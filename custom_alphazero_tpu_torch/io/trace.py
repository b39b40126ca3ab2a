"""Spans: the port's one way to time a region of the program.

    from custom_alphazero_tpu_torch.io import trace

    with trace.span("search.waves") as s:
        ...
    s.seconds        # the span's duration, after exit
    trace.spans()    # the recorded spans, oldest first

A span records its name, an id, the id of the span that encloses it on the
same thread (its cause, None at the top), the thread's id, and its start
and end in nanoseconds. The stamps are ``time.time_ns()``, the clock that
``torch.profiler``'s kineto events carry, so a span can be laid over the
device events of a profile taken at the same time.

Spans are kept in memory, the newest ``CAPACITY`` of them; nothing is
written out unless a caller asks. While a ``torch.profiler`` records, a
span also opens a host range of its name, so the profile's host events
(and a Chrome trace exported from it) carry it. The range is torch's fast
record function, a plain host op: a ``torch.profiler.record_function`` is
a user annotation, which the profiler mirrors on the device's timeline as
one device event over all the work launched inside it, and a span of a
whole generation would then read as device time from end to end.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional

import torch

CAPACITY = 65536

_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


def _profiler_range(name: str):
    """A host range of ``name`` in the running profile (not a user
    annotation: see the module's docstring)."""
    return torch._C._profiler._RecordFunctionFast(name)


def _open_spans() -> list:
    """This thread's open spans, outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """``with span(name) as s:`` records one span of the enclosed code."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.thread = 0
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self._range = None

    def __enter__(self) -> "span":
        stack = _open_spans()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        # Read the flag as the profiler sets it, on every call.
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _open_spans().pop()
        _records.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def spans() -> List[span]:
    """The recorded spans (the newest ``CAPACITY``), in the order they
    ended."""
    return list(_records)
