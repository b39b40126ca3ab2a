"""Stall watchdog: restartable failure detection for the training loop
(the port's copy of runtime/watchdog.py).

The hazard is a wedged device stream: the host blocks inside a device call
and no Python-level timeout can fire. The only reliable recovery is process
exit + supervisor restart, which is cheap here because training
checkpoint-resumes exactly (steps, replay, optimizer state, best-model
lineage; io/checkpoint.py).

``Heartbeat`` is plain logic (injectable clock, unit-testable);
``start_watchdog`` runs it on a daemon thread and hard-exits the process
with :data:`STALL_EXIT_CODE` when the heartbeat goes stale. ``os._exit``
is deliberate: a wedged device call holds locks that would deadlock any
graceful shutdown path.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

STALL_EXIT_CODE = 42

# Set by the supervisor: a file the loop touches at entry and on every
# heartbeat so liveness is observable from OUTSIDE the process — the only
# detector that can cover a wedge happening before the loop's first line
# (device start-up at interpreter start).
HEARTBEAT_ENV = "CAZ_HEARTBEAT_FILE"


def touch_liveness_file() -> None:
    """Touch the supervisor's heartbeat file, if one was provided."""
    path = os.environ.get(HEARTBEAT_ENV)
    if path:
        try:
            os.utime(path, None)
        except OSError:
            pass


class CompileGraceToucher:
    """Daemon thread that keeps the supervisor's liveness file fresh while
    the loop is still in its pre-steady-state phases (generation 0 builds
    the kernels and captures the search's graph; the first arena captures
    too). Bounded: stops at ``stop()`` (first generation complete) or after
    ``grace_s`` seconds, whichever comes first — so a genuine wedge before
    steady state is still detected by the supervisor once the grace budget
    runs out. See config.RunConfig.compile_grace_minutes.
    ``touch`` / ``clock`` are injectable for tests."""

    def __init__(self, grace_s: float, interval_s: float = 30.0,
                 touch: Callable[[], None] = touch_liveness_file,
                 clock: Callable[[], float] = time.monotonic):
        self._stop = threading.Event()
        self._deadline = clock() + grace_s
        self._clock = clock
        self._touch = touch
        self._interval = interval_s
        self.thread = threading.Thread(
            target=self._run, name="compile-grace-toucher", daemon=True
        )
        self.thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self):
        while not self._stop.wait(self._interval):
            if self._clock() >= self._deadline:
                return
            self._touch()


class Heartbeat:
    """Tracks liveness: ``beat()`` on progress, ``stalled()`` to check."""

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def beat(self) -> None:
        with self._lock:
            self._last = self._clock()

    def age(self) -> float:
        with self._lock:
            return self._clock() - self._last

    def stalled(self) -> bool:
        return self.age() > self.timeout_s


class Watchdog:
    """Daemon thread that exits the process when the heartbeat stalls.

    Callers MUST ``disarm()`` when the supervised phase ends (run() does
    so in a finally) — otherwise the thread outlives the training loop
    and kills a perfectly healthy process once beats stop arriving.
    ``on_stall`` (tests) replaces the default exit action.
    """

    def __init__(self, heartbeat: Heartbeat, poll_s: float = 15.0,
                 on_stall: Optional[Callable[[], None]] = None):
        self.heartbeat = heartbeat
        self.poll_s = poll_s
        self.on_stall = on_stall
        self._disarmed = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self.thread.start()

    def disarm(self) -> None:
        self._disarmed.set()

    def _action(self):
        print(
            f"[watchdog] no progress for {self.heartbeat.age():.0f}s "
            f"(limit {self.heartbeat.timeout_s:.0f}s); exiting "
            f"{STALL_EXIT_CODE} for supervisor restart",
            file=sys.stderr,
            flush=True,
        )
        os._exit(STALL_EXIT_CODE)

    def _run(self):
        while not self._disarmed.wait(self.poll_s):
            if self.heartbeat.stalled():
                if self._disarmed.is_set():
                    return
                (self.on_stall or self._action)()
                return


def start_watchdog(
    heartbeat: Heartbeat,
    poll_s: float = 15.0,
    on_stall: Optional[Callable[[], None]] = None,
) -> Watchdog:
    return Watchdog(heartbeat, poll_s, on_stall)
