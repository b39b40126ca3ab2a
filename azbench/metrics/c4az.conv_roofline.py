"""The trunk convs' share of the card's bf16 peak in the traced generation:
the stem's and the residual blocks' conv FLOPs from their shapes
(azbench/tower_flops.py, each block's skip as the configuration builds it)
times the positions the graph replays evaluated (waves minus the drain
steps, times the batch), over the summed device time of the traced
``conv_kernel`` events and the card's published bf16 rate. The convs are
bound by their FLOPs. Nothing without the trace or its conv events."""

import torch

from azbench import flops, tower_flops


def read(run):
    act, waves = run.activity, run.values.get("bracket_waves")
    plies = run.values.get("bracket_plies")
    if act is None or not waves or not plies:
        return None
    events = act.events_by_name.get("conv_kernel", [])
    seconds = sum(d for _, d in events) / 1e9
    if seconds <= 0:
        return None
    cfg = run.config["config"]
    c = cfg["connect_n"]
    per_position = tower_flops.trunk_conv_flops(cfg,
                                                (c["height"], c["width"], 4))
    positions = (waves - plies) * cfg["self_play"]["games_per_generation"]
    peak = flops.peaks(torch.cuda.get_device_name())["bf16_flops"]
    return 100.0 * positions * per_position / peak / seconds
