"""The train step's share of the card's bf16 peak over the traced bracket
of steps: 3 x the net's forward FLOPs (azbench/flops.py) x the rows that
carry gradients in a step (the batch plus the auxiliary rows, whose
eval-mode forward feeds the loss), over the bracket's wall time per step
and the card's published bf16 rate."""

import torch

from azbench import flops


def read(run):
    act, steps = run.activity, run.values.get("bracket_steps")
    if act is None or not steps or act.window_s <= 0:
        return None
    cfg = run.config["config"]
    c = cfg["connect_n"]
    per_row = flops.model_flops(cfg, (c["height"], c["width"], 4),
                                c["width"])
    rows = cfg["model"]["batch_size"]
    if cfg["loop"]["solver_labels_path"] and (
            cfg["loop"]["solver_value_weight"] > 0
            or cfg["loop"]["solver_policy_weight"] > 0):
        rows += cfg["loop"]["solver_value_batch"]
    peak = flops.peaks(torch.cuda.get_device_name())["bf16_flops"]
    return 100.0 * 3 * per_row * rows * steps / act.window_s / peak
