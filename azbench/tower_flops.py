"""Operations of the policy-value net's forward from its shapes, with each
residual block's skip counted as the configuration builds it:
``flops.model_flops`` counts a 1x1 projection in every block, which a
block without one (``model.residual_projection`` false: AlphaZero's
identity skip) does not run. Convs and dense layers as 2 x
multiply-accumulates; BatchNorm, the skip's add, activations and softmax
left out."""

from __future__ import annotations

from typing import Sequence

from azbench import flops


def projection_flops(cfg: dict, obs_shape: Sequence[int]) -> int:
    """One position's projection convs that ``flops.model_flops`` counts
    and a configuration without projections does not run."""
    m = cfg["model"]
    if m.get("residual_projection", True):
        return 0
    h, w, _ = obs_shape
    return 2 * m["depth"] * h * w * m["filters"] * m["filters"]


def trunk_conv_flops(cfg: dict, obs_shape: Sequence[int]) -> int:
    """One position's stem and residual-block convs."""
    m = cfg["model"]
    h, w, c = obs_shape
    trunk = flops.net_forward_flops(h, w, c, 0, m["filters"], m["depth"], 0,
                                    0, 0)
    return trunk - projection_flops(cfg, obs_shape)


def net_forward_flops(cfg: dict, obs_shape: Sequence[int],
                      actions: int) -> int:
    """One position's whole forward for a configuration's ``model``."""
    return (flops.model_flops(cfg, obs_shape, actions)
            - projection_flops(cfg, obs_shape))
