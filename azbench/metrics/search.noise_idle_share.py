"""Percent of the traced generation's wall (the base of
``selfplay.idle_share``) during which the device was idle while the host's
innermost open program span was ``search.noise``: the root-noise draws
before a ply's waves (azbench/spans.py). Nothing without the trace or the
program's spans."""

from azbench import spans


def read(run):
    return spans.idle_share(run, "search.noise")
