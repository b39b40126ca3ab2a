"""Kernel K1's share of its roofline on the last ply of the traced
generation: the bytes its steps must move at the tree depths those launches
saw (azbench/flops.py ``k1_step_bytes``) over the card's memory bandwidth,
divided by K1's device time on those launches (the last sims + 1 wave
kernels of the trace). K1 is bound by memory. Nothing without the trace or
the depths."""

import numpy as np
import torch

from azbench import flops


def read(run):
    act, depths = run.activity, run.values.get("bracket_depths")
    if act is None or depths is None:
        return None
    events = act.events_by_name.get("wave_kernel", [])
    cfg = run.config["config"]
    steps = cfg["mcts"]["simulations"] + 1
    if len(events) < steps:
        return None
    seconds = sum(d for _, d in sorted(events)[-steps:]) / 1e9
    if seconds <= 0:
        return None
    actions = cfg["connect_n"]["width"]
    cells = cfg["connect_n"]["width"] * cfg["connect_n"]["height"]
    total = 0
    for leaf in depths:
        new = np.concatenate([leaf, [-1.0]])
        prev = np.concatenate([[0.0], leaf])
        total += flops.k1_step_bytes(prev, new, actions, cells)
    peak = flops.peaks(torch.cuda.get_device_name())["hbm_bytes_per_s"]
    return 100.0 * (total / peak) / seconds
