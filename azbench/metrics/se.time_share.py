"""What the squeeze-excitation gates cost of the tower: the device time of
the traced ``se_kernel`` events over that of the ``conv_kernel`` and
``se_kernel`` events together, in the traced generation. Nothing without
the trace or its ``se_kernel`` events."""


def read(run):
    act = run.activity
    if act is None:
        return None
    gates = sum(d for _, d in act.events_by_name.get("se_kernel", []))
    convs = sum(d for _, d in act.events_by_name.get("conv_kernel", []))
    if gates <= 0:
        return None
    return 100.0 * gates / (gates + convs)
