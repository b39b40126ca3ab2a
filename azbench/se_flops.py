"""Operations of a squeeze-excitation residual net's forward from its
shapes (``model.se_ratio`` > 0: Leela Chess Zero's gate in every identity
block, azbench/reference/net_se.py): ``tower_flops``' counts of the convs,
heads and dense layers, plus each gate's two dense layers, C x C / ratio
and C / ratio x 2C multiply-accumulates a position. Convs and dense layers
as 2 x multiply-accumulates; BatchNorm, the board mean, the sigmoid, the
gate's scale and offset, the skip's add and activations left out."""

from __future__ import annotations

from typing import Sequence

from azbench import tower_flops


def gate_flops(cfg: dict) -> int:
    """One position's squeeze-excitation dense layers, every block's."""
    m = cfg["model"]
    ratio = m.get("se_ratio", 0)
    if not ratio:
        return 0
    c = m["filters"]
    return 2 * m["depth"] * 3 * c * (c // ratio)


def tower_block_flops(cfg: dict, obs_shape: Sequence[int]) -> int:
    """One position's stem, residual-block convs and gates: the work of the
    ``conv_kernel`` and ``se_kernel`` launches."""
    return tower_flops.trunk_conv_flops(cfg, obs_shape) + gate_flops(cfg)


def net_forward_flops(cfg: dict, obs_shape: Sequence[int],
                      actions: int) -> int:
    """One position's whole forward."""
    return (tower_flops.net_forward_flops(cfg, obs_shape, actions)
            + gate_flops(cfg))
