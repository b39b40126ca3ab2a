"""Median host milliseconds of the traced generation's ``search.noise``
spans, one a ply: the root-noise draws of all its waves
(azbench/spans.py). Nothing without the trace or the program's spans."""

from azbench import spans


def read(run):
    r = spans.reading(run)
    if r is None:
        return None
    return spans.median_ms(e - s for name, s, e in r.spans
                           if name == "search.noise")
