"""The pooled-bias kernel's share of its bandwidth bound in the traced
generation: each traced ``gpool_kernel`` event's bytes
(azbench/nbt_flops.py ``gpool_launch_bytes`` at the cell's batch: the
pooled and regular channels read, the output written, the dense weight
and conv2's norm read once) over 3.35 TB/s, over the events' summed
device time. Nothing without the trace or its ``gpool_kernel`` events."""

from azbench import nbt_flops

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def read(run):
    act = run.activity
    if act is None:
        return None
    pools = act.events_by_name.get("gpool_kernel", [])
    seconds = sum(d for _, d in pools) / 1e9
    if not pools or seconds <= 0:
        return None
    cfg = run.config["config"]
    c = cfg["connect_n"]
    per_launch = nbt_flops.gpool_launch_bytes(
        cfg, (c["height"], c["width"], 4),
        cfg["self_play"]["games_per_generation"])
    return 100.0 * len(pools) * per_launch / HBM_BYTES_PER_S / seconds
