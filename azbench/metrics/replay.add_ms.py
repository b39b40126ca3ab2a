"""Milliseconds per ``Learner.replay_add`` of one generation's batch, the
device drained before and after (median over the window's generations)."""

import statistics


def read(run):
    spans = run.spans.get("replay_add")
    return 1e3 * statistics.median(spans) if spans else None
