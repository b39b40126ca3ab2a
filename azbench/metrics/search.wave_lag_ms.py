"""Median over the traced generation's plies of the start of the ply's
first K1 device event less the start of its ``search.waves`` span, in ms:
how far the device runs behind the host that issues a ply's waves. Near 0
the device waits on the host; far above the idle gaps, the host is ahead
(azbench/spans.py). Nothing without the trace or the program's spans."""

from azbench import spans


def read(run):
    r = spans.reading(run)
    return None if r is None else spans.median_ms(r.lags_ns)
