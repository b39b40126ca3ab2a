"""Operations and bytes of the program's work, computed from shapes.

``net_forward_flops``: one position's forward through the policy-value net,
convs and dense layers as 2 x multiply-accumulates (BatchNorm, activations
and softmax left out).

``k1_step_bytes``: the bytes one step of the fused PUCT kernel K1 must move
for a batch of games, from each game's depth before and after the step
(a frozen copy of the count the port's bring-up measured K1 against): the
inputs read once, the expansion and the backup along the previous path, one
node row per descent level, and the outputs written once.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of device ``kind`` (KeyError if not listed)."""
    with open(PEAKS_FILE) as fp:
        return json.load(fp)[kind]


def net_forward_flops(height: int, width: int, channels: int, actions: int,
                      filters: int, depth: int, policy_filters: int,
                      value_filters: int, value_hidden: int) -> int:
    cells = height * width
    macs = cells * 9 * channels * filters                      # stem
    macs += depth * cells * (2 * 9 * filters * filters         # two 3x3
                             + filters * filters)              # 1x1 proj
    macs += cells * filters * (policy_filters + value_filters)  # head convs
    macs += cells * policy_filters * actions                   # policy dense
    macs += cells * value_filters * value_hidden + value_hidden  # value
    return 2 * macs


def model_flops(cfg: dict, obs_shape: Sequence[int], actions: int) -> int:
    """``net_forward_flops`` of a configuration's ``model`` section."""
    m = cfg["model"]
    h, w, c = obs_shape
    return net_forward_flops(h, w, c, actions, m["filters"], m["depth"],
                             m["policy_filters"], m["value_filters"],
                             m["value_hidden"])


def k1_step_bytes(prev_depth: np.ndarray, new_depth: np.ndarray,
                  actions: int, cells: int) -> int:
    prev = np.asarray(prev_depth, np.int64)
    new = np.asarray(new_depth, np.int64)
    per_game = (
        4 * actions + 1 + 64 + (1 + prev) + 3 + 2    # inputs
        + (actions + 1) + 2 + 4 * prev               # expand + backup
        + (new + 1) * (4 * actions + 2)              # descent
        + (new + 1) + 6 + 3                          # path + create
        + 2 * actions + 64 + 4 * cells               # outputs
    )
    return int(4 * per_game.sum())
