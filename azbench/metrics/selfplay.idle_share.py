"""The device's idle share of the traced self-play generation: 1 - busy /
wall, busy the union of the device events' intervals."""


def read(run):
    act = run.activity
    if act is None or act.window_s <= 0 or not act.device_events:
        return None
    return 100.0 * (1.0 - act.busy_s / act.window_s)
