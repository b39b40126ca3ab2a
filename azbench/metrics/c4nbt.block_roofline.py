"""The nested-bottleneck tower's share of the card's bf16 peak in the
traced generation: the stem's, the blocks' 1x1 and 3x3 convs' and the
pooled biases' dense FLOPs from their shapes (azbench/nbt_flops.py) times
the positions the graph replays evaluated (waves minus the drain steps,
times the batch), over the summed device time of the traced
``conv_kernel`` and ``gpool_kernel`` events and the card's published bf16
rate. Whatever implements the pooled bias, the same work is counted.
Nothing without the trace or its ``gpool_kernel`` events."""

import torch

from azbench import flops, nbt_flops


def read(run):
    act, waves = run.activity, run.values.get("bracket_waves")
    plies = run.values.get("bracket_plies")
    if act is None or not waves or not plies:
        return None
    pools = act.events_by_name.get("gpool_kernel", [])
    convs = act.events_by_name.get("conv_kernel", [])
    seconds = sum(d for _, d in pools + convs) / 1e9
    if not pools or seconds <= 0:
        return None
    cfg = run.config["config"]
    c = cfg["connect_n"]
    per_position = nbt_flops.tower_block_flops(cfg,
                                               (c["height"], c["width"], 4))
    positions = (waves - plies) * cfg["self_play"]["games_per_generation"]
    peak = flops.peaks(torch.cuda.get_device_name())["bf16_flops"]
    return 100.0 * positions * per_position / peak / seconds
