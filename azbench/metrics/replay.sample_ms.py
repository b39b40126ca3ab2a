"""Milliseconds per ``Learner.replay_sample`` of one batch, the device
drained before and after (median over the traced run's timed samples)."""

import statistics


def read(run):
    spans = run.spans.get("replay_sample")
    return 1e3 * statistics.median(spans) if spans else None
