"""Percent of the traced generation's wall (the base of
``selfplay.idle_share``) during which the device was idle while the host's
innermost open program span was ``search.waves``: a ply's graph replays and
its drain step (azbench/spans.py). Nothing without the trace or the
program's spans."""

from azbench import spans


def read(run):
    return spans.idle_share(run, "search.waves")
