"""The self-play step's share of the card's bf16 peak in the traced
generation, as ``c4se.mfu`` defines it, with the net's forward FLOPs
counted for a nested-bottleneck tower (azbench/nbt_flops.py: the stem, the
blocks' convs, the pooled biases' dense layers and the heads). Positions
the graph replays evaluated (waves minus the drain steps, times the batch)
over the bracket's wall time and the card's published bf16 rate. Nothing
without the trace."""

import torch

from azbench import flops, nbt_flops


def read(run):
    act, waves = run.activity, run.values.get("bracket_waves")
    plies = run.values.get("bracket_plies")
    if act is None or not waves or not plies or act.window_s <= 0:
        return None
    cfg = run.config["config"]
    c = cfg["connect_n"]
    per_position = nbt_flops.net_forward_flops(
        cfg, (c["height"], c["width"], 4), c["width"])
    positions = (waves - plies) * cfg["self_play"]["games_per_generation"]
    peak = flops.peaks(torch.cuda.get_device_name())["bf16_flops"]
    return 100.0 * positions * per_position / act.window_s / peak
