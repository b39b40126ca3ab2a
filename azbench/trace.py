"""Device activity of a bracket of work, from torch.profiler's raw events.

The events are read as torch's own parse reads them but without its tree of
Python objects (some 80 us an event there; a Connect-4 generation has about
1.7 M). No Chrome trace is written. Busy time is the union of the device
events' intervals, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Activity:
    window_s: float = 0.0
    busy_s: float = 0.0
    seconds_by_name: Dict[str, float] = field(default_factory=dict)
    count_by_name: Dict[str, int] = field(default_factory=dict)
    # (start_ns, duration_ns) of every device event of a name, in order:
    # kept only for the names asked for.
    events_by_name: Dict[str, List[Tuple[int, int]]] = field(
        default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def device_events(self) -> int:
        return sum(self.count_by_name.values())

    def top_ops(self, count: int = 10) -> List[List]:
        top = sorted(self.seconds_by_name.items(), key=lambda kv: -kv[1])
        return [[name[:120], seconds] for name, seconds in top[:count]]


class Bracket:
    """``with Bracket(keep=("wave_kernel",)) as b: work()`` profiles the
    work, the device drained at both ends; ``b.activity`` holds the result.
    Host operations are recorded too, to name what the host was doing in
    the longest idle gaps. Only work launched from the entering thread is
    seen."""

    def __init__(self, keep=()):
        self.keep = tuple(keep)
        self.activity = Activity()

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA, ProfilerActivity.CPU]
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.activity = read_events(self._prof, window, self.keep)
        return False


def read_events(prof, window_s: float, keep=()) -> Activity:
    from torch.autograd import DeviceType

    act = Activity(window_s=window_s)
    spans: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        name = evt.name()
        start, dur = evt.start_ns(), evt.duration_ns()
        if evt.device_type() == DeviceType.CUDA:
            act.count_by_name[name] = act.count_by_name.get(name, 0) + 1
            act.seconds_by_name[name] = (act.seconds_by_name.get(name, 0.0)
                                         + dur / 1e9)
            spans.append((start, start + dur))
            for part in keep:
                if part in name:
                    act.events_by_name.setdefault(part, []).append(
                        (start, dur))
        else:
            host.append((start, start + dur, name))
    spans.sort()
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_start = cur_end = None
    for s, e in spans:
        if cur_end is None:
            cur_start, cur_end = s, e
        elif s > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, s))
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    act.busy_s = busy / 1e9
    act.idle_gaps = _name_gaps(gaps, host)
    return act


def _name_gaps(gaps, host, count: int = 10) -> List[Tuple[str, float]]:
    """The longest idle gaps, each named by the host operation that began
    last before the gap's middle (what the host was doing)."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for s, e in longest:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][2][:120] if i >= 0 else "no host operation"
        out.append((label, (e - s) / 1e9))
    return out
