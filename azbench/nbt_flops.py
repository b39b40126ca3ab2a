"""Operations of a nested-bottleneck net's forward from its shapes
(``model.mid_filters`` > 0: KataGo's b18c384nbt blocks,
azbench/reference/net_nbt.py), and the bytes of the pooled bias's kernel.
Convs and dense layers as 2 x multiply-accumulates, counted from the
shapes whatever implements them: the stem, each block's 1x1 convs down
and up, each inner block's two 3x3 convs (in a pooled block the first
split into its regular and pooled channels) and the pooled bias's dense
layer; BatchNorm, the board mean and max, the skips' adds and activations
left out."""

from __future__ import annotations

from typing import Sequence

from azbench import flops


def _model(cfg: dict):
    m = cfg["model"]
    return (m["filters"], m["mid_filters"], m.get("gpool_filters", 0),
            set(m.get("gpool_blocks", ())), m["depth"])


def tower_block_flops(cfg: dict, obs_shape: Sequence[int]) -> int:
    """One position's stem, block convs and pooled dense layers: the work
    of the ``conv_kernel`` and ``gpool_kernel`` launches."""
    h, w, c = obs_shape
    cells = h * w
    filters, mid, pooled, pooled_blocks, depth = _model(cfg)
    macs = cells * 9 * c * filters                          # stem
    for i in range(1, depth + 1):
        macs += 2 * cells * filters * mid                   # 1x1 down, up
        macs += 2 * cells * 9 * mid * mid                   # second inner
        regular = mid - pooled if i in pooled_blocks else mid
        macs += cells * 9 * mid * mid                       # conv1 (r + g)
        macs += cells * 9 * regular * mid                   # conv2
        if i in pooled_blocks:
            macs += 3 * pooled * regular                    # pooled dense
    return 2 * macs


def net_forward_flops(cfg: dict, obs_shape: Sequence[int],
                      actions: int) -> int:
    """One position's whole forward: the tower and the heads."""
    m = cfg["model"]
    h, w, c = obs_shape
    heads = flops.net_forward_flops(h, w, c, actions, m["filters"], 0,
                                    m["policy_filters"], m["value_filters"],
                                    m["value_hidden"])
    stem = 2 * h * w * 9 * c * m["filters"]
    return heads - stem + tower_block_flops(cfg, obs_shape)


def gpool_launch_bytes(cfg: dict, obs_shape: Sequence[int],
                       positions: int) -> int:
    """The bytes one ``gpool_kernel`` launch must move for ``positions``
    positions: the pooled channels and the regular ones read once, the
    output written once (bf16), the dense weight and conv2's norm read once
    (float32)."""
    h, w, _ = obs_shape
    _, mid, pooled, _, _ = _model(cfg)
    regular = mid - pooled
    return (2 * positions * h * w * (pooled + 2 * regular)
            + 4 * (3 * pooled * regular + 4 * regular))
