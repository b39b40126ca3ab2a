"""The program's spans laid over the traced generation's device activity.

The port records spans (``custom_alphazero_tpu_torch/io/trace.py``) on the
clock that torch.profiler's kineto events carry, so the spans of the traced
generation are those that overlap the bracket's events, and each instant
the device is idle can be charged to the innermost program span open then.
The ``search.*`` and ``selfplay.ply_idle_share`` readers share this reading.
It is None without the bracket's profile, where the program records no
spans (a program without ``io/trace.py``), and unless the trace holds every
K1 launch of the traced generation (plies x (simulations + 1)) and a
``search.waves`` span per ply.

The device intervals are read once per run from the bracket's profile, as
``azbench/trace.py::read_events`` reads them (device events only, their
union, so overlapping streams are not counted twice).
"""

from __future__ import annotations

import bisect
import statistics
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def attribute(spans: Sequence[Tuple[str, int, int]],
              device_intervals: Iterable[Tuple[int, int]],
              t0: int, t1: int) -> Dict[Optional[str], int]:
    """Device-idle time within [t0, t1], split at span edges and charged to
    the innermost span open at each instant: {name: ns}, None for idle time
    in no span. ``spans`` are (name, start, end); of the spans open at an
    instant the innermost is the one that started last (of two that start
    together, the one that ends first). The values add up to the idle time
    of [t0, t1]."""
    busy = merge(device_intervals)
    starts = [s for s, _ in busy]
    before = [0]  # busy time of the intervals before index i
    for s, e in busy:
        before.append(before[-1] + e - s)

    def busy_until(x: int) -> int:
        i = bisect.bisect_right(starts, x)
        if i == 0:
            return 0
        s, e = busy[i - 1]
        return before[i - 1] + min(x, e) - s

    clipped = [(name, max(s, t0), min(e, t1)) for name, s, e in spans
               if s < t1 and e > t0]
    edges = sorted({t0, t1} | {s for _, s, _ in clipped}
                   | {e for _, _, e in clipped})
    out: Dict[Optional[str], int] = {}
    for a, b in zip(edges, edges[1:]):
        # Every span edge is an edge here: a span covers [a, b) or misses it.
        open_ = [(s, -e, name) for name, s, e in clipped if s <= a and e >= b]
        name = max(open_)[2] if open_ else None
        idle = (b - a) - (busy_until(b) - busy_until(a))
        out[name] = out.get(name, 0) + idle
    return out


def device_reading(run):
    """(t0, t1, merged device intervals) of the traced bracket, t0 and t1
    the first start and last end of its kineto events, host and device;
    read once and kept in ``run.values``. None without the profile."""
    cached = run.values.get("bracket_device")
    if cached is not None:
        return cached
    prof = getattr(getattr(run, "_bracket", None), "_prof", None)
    if prof is None or run.activity is None:
        return None
    from torch.autograd import DeviceType

    t0 = t1 = None
    device = []
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        start = evt.start_ns()
        end = start + evt.duration_ns()
        t0 = start if t0 is None else min(t0, start)
        t1 = end if t1 is None else max(t1, end)
        if evt.device_type() == DeviceType.CUDA:
            device.append((start, end))
    if t0 is None:
        return None
    cached = (t0, t1, merge(device))
    run.values["bracket_device"] = cached
    return cached


def program_spans():
    """The port's recorded spans, or None where it records none."""
    try:
        from custom_alphazero_tpu_torch.io import trace
    except ImportError:
        return None
    return trace.spans()


def reading(run):
    """What the span readers read, once per run (kept in ``run.values``):
    ``idle`` ({innermost span name or None: idle seconds}), ``window_s``,
    ``spans`` (the traced generation's, (name, start, end) in ns), and per
    ply ``lags_ns`` (its first K1 event's start less its ``search.waves``
    span's start). None where any part is missing."""
    cached = run.values.get("span_reading")
    if cached is not None:
        return cached
    act = run.activity
    plies = run.values.get("bracket_plies")
    if act is None or not plies or act.window_s <= 0:
        return None
    recorded = program_spans()
    device = device_reading(run) if recorded is not None else None
    if device is None:
        return None
    t0, t1, intervals = device
    spans = sorted((s.name, s.start_ns, s.end_ns) for s in recorded
                   if s.end_ns is not None and s.start_ns < t1
                   and s.end_ns > t0)
    steps = run.config["config"]["mcts"]["simulations"] + 1
    k1 = sorted(start for start, _ in act.events_by_name.get(
        "wave_kernel", []))
    waves = sorted(s for name, s, _ in spans if name == "search.waves")
    if len(k1) != plies * steps or len(waves) != plies:
        return None
    idle = attribute(spans, intervals, t0, t1)
    out = SimpleNamespace(
        idle={name: ns / 1e9 for name, ns in idle.items()},
        window_s=act.window_s, spans=spans,
        lags_ns=[k1[k * steps] - waves[k] for k in range(plies)],
        first_span_ns=min(s for _, s, _ in spans),
        first_k1_ns=k1[0])
    run.values["span_reading"] = out
    return out


def idle_share(run, name: str) -> Optional[float]:
    """Percent of the bracket's wall during which the device was idle with
    ``name`` the innermost open program span."""
    r = reading(run)
    if r is None:
        return None
    return 100.0 * r.idle.get(name, 0.0) / r.window_s


def median_ms(values_ns) -> Optional[float]:
    values = list(values_ns)
    return statistics.median(values) / 1e6 if values else None
