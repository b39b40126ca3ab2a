"""Device kernels and copies per search wave in the traced generation: the
profiled device events over the waves run there (K1 launches counted by
the program, graph replays included). Nothing without a trace."""


def read(run):
    act, waves = run.activity, run.values.get("bracket_waves")
    if act is None or not waves or not act.device_events:
        return None
    return act.device_events / waves
