"""Supervisor: restart the training loop when it stalls (the port's copy
of runtime/supervisor.py).

Two complementary detectors:

1. **In-process stall watchdog** (runtime/watchdog.py): the loop detects
   its own steady-state stalls (a wedged device stream blocks the host
   inside a device call) and hard-exits with STALL_EXIT_CODE; this
   supervisor relaunches it, which resumes exactly from the latest
   checkpoint (steps, optimizer state, replay ring, best-model lineage).

2. **Supervisor-side liveness monitor** (``liveness_timeout_minutes``):
   the in-process watchdog cannot cover a wedge that happens before the
   loop's first line runs (device start-up at interpreter start). The
   supervisor passes the child a heartbeat file (env
   ``CAZ_HEARTBEAT_FILE``); the loop touches it at entry and on every
   internal heartbeat. If the file's age ever exceeds the timeout, the
   supervisor SIGKILLs the child (a blocked device call ignores SIGTERM)
   and restarts it.

Restart policy: the watchdog's exit code and liveness kills trigger a
relaunch (crashes and clean exits propagate), with linear backoff and a
restart budget.

Run:  python -m custom_alphazero_tpu_torch.runtime.supervisor \
          --supervise.max_restarts=10 --supervise.backoff_s=30 \
          --supervise.liveness_timeout_minutes=10 \
          <runtime.loop args...>
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

from custom_alphazero_tpu_torch.runtime.watchdog import (
    HEARTBEAT_ENV,
    STALL_EXIT_CODE,
)


def _run_child(cmd, liveness_timeout_s: Optional[float],
               poll_s: float) -> int:
    """Spawn one child; return its exit code. With a liveness timeout,
    monitor the heartbeat file and SIGKILL (reported as STALL_EXIT_CODE)
    when it goes stale."""
    if not liveness_timeout_s:
        return subprocess.run(cmd).returncode
    fd, hb_path = tempfile.mkstemp(prefix="caz_heartbeat_")
    os.close(fd)
    env = dict(os.environ, **{HEARTBEAT_ENV: hb_path})
    try:
        child = subprocess.Popen(cmd, env=env)
        while True:
            try:
                code = child.wait(timeout=poll_s)
                return code
            except subprocess.TimeoutExpired:
                pass
            try:
                age = time.time() - os.stat(hb_path).st_mtime
            except OSError:
                # Heartbeat file vanished (external cleanup): recreate it
                # rather than crash the monitor; the age clock restarts.
                open(hb_path, "w").close()
                age = 0.0
            if age > liveness_timeout_s:
                print(
                    f"[supervisor] child heartbeat stale for {age:.0f}s "
                    f"(limit {liveness_timeout_s:.0f}s); killing for "
                    "restart (wedged before/inside a device call)",
                    flush=True,
                )
                child.send_signal(signal.SIGKILL)
                child.wait()
                return STALL_EXIT_CODE
    finally:
        try:
            os.unlink(hb_path)
        except OSError:
            pass


def supervise(
    loop_args: Sequence[str],
    max_restarts: int = 10,
    backoff_s: float = 30.0,
    cmd: Optional[List[str]] = None,
    sleep=time.sleep,
    liveness_timeout_minutes: float = 0.0,
    poll_s: float = 5.0,
) -> int:
    """Run the loop command until it exits for a non-stall reason.

    Returns the final exit code: 0 on clean completion, the child's code on
    a non-stall failure, or STALL_EXIT_CODE when the restart budget is
    exhausted. `cmd` overrides the launched command (tests)."""
    base = cmd if cmd is not None else [
        sys.executable, "-u", "-m", "custom_alphazero_tpu_torch.runtime.loop",
    ]
    restarts = 0
    while True:
        code = _run_child(
            base + list(loop_args),
            liveness_timeout_minutes * 60.0 or None,
            poll_s,
        )
        if code != STALL_EXIT_CODE:
            return code
        restarts += 1
        if restarts > max_restarts:
            print(f"[supervisor] stall persisted through {max_restarts} "
                  "restarts; giving up", flush=True)
            return STALL_EXIT_CODE
        delay = backoff_s * restarts
        print(f"[supervisor] stall exit ({STALL_EXIT_CODE}); restart "
              f"{restarts}/{max_restarts} in {delay:.0f}s "
              "(training resumes from the latest checkpoint)", flush=True)
        sleep(delay)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    max_restarts, backoff, liveness = 10, 30.0, 0.0
    passthrough = []
    for a in args:
        if a.startswith("--supervise.max_restarts="):
            max_restarts = int(a.split("=", 1)[1])
        elif a.startswith("--supervise.backoff_s="):
            backoff = float(a.split("=", 1)[1])
        elif a.startswith("--supervise.liveness_timeout_minutes="):
            liveness = float(a.split("=", 1)[1])
        else:
            passthrough.append(a)
    return supervise(passthrough, max_restarts, backoff,
                     liveness_timeout_minutes=liveness)


if __name__ == "__main__":
    raise SystemExit(main())
