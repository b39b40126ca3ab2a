"""What the pooled biases cost of the nested-bottleneck tower: the device
time of the traced ``gpool_kernel`` events over that of the
``conv_kernel`` and ``gpool_kernel`` events together, in the traced
generation. Nothing without the trace or its ``gpool_kernel`` events."""


def read(run):
    act = run.activity
    if act is None:
        return None
    pools = sum(d for _, d in act.events_by_name.get("gpool_kernel", []))
    convs = sum(d for _, d in act.events_by_name.get("conv_kernel", []))
    if pools <= 0:
        return None
    return 100.0 * pools / (pools + convs)
