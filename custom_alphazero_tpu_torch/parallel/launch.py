"""Start N ranks of one command as local processes (what ``torchrun
--nproc_per_node=N`` does, for tests and tools).

Each rank gets torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` and, in place of an address and a port, a ``file://``
store in a fresh temporary directory (``$CAZ_DIST_INIT_METHOD``, read by
``distributed.initialize``), so concurrent launches never race for a port.
A rank's standard output and error go to a file of their own. When a rank
fails, or the time limit passes, every rank still running is killed and
the call raises: a rank that waits in a collective for a dead one never
hangs the caller.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from custom_alphazero_tpu_torch.parallel.distributed import (
    INIT_METHOD_ENV,
    TIMEOUT_ENV,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(text: str, n: int = 4000) -> str:
    return text[-n:]


def launch(n: int, argv: List[str], timeout_s: float = 120.0,
           env: Optional[Dict[str, str]] = None,
           collective_timeout_s: float = 60.0) -> List[str]:
    """Run ``python argv...`` as ranks 0..n-1 and return each rank's output
    (standard output and error, in that order). Raises ``RuntimeError``
    when a rank exits non-zero and ``TimeoutError`` after ``timeout_s``;
    each rank's process group times out its collectives after
    ``collective_timeout_s``."""
    workdir = tempfile.mkdtemp(prefix="caz_launch_")
    base = dict(os.environ)
    base.update(env or {})
    base["PYTHONPATH"] = REPO + (os.pathsep + base["PYTHONPATH"]
                                 if base.get("PYTHONPATH") else "")
    base[INIT_METHOD_ENV] = "file://" + os.path.join(workdir, "store")
    base[TIMEOUT_ENV] = str(collective_timeout_s)
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        base.pop(key, None)
    procs, files = [], []
    try:
        for rank in range(n):
            rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(n),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
            out = open(os.path.join(workdir, f"rank{rank}.out"), "w+")
            err = open(os.path.join(workdir, f"rank{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable] + list(argv), stdout=out, stderr=err,
                env=rank_env, cwd=REPO))
        deadline = time.monotonic() + timeout_s
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for out, err in files:
            text = []
            for f in (out, err):
                f.seek(0)
                text.append(f.read())
                f.close()
            outputs.append("".join(text))
        shutil.rmtree(workdir, ignore_errors=True)
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {n} exited with code {procs[failed].returncode}"
            f":\n{_tail(outputs[failed])}")
    if any(p.returncode != 0 for p in procs):
        raise TimeoutError(
            f"{n} ranks still running after {timeout_s:g} s; killed. "
            f"Rank 0's output:\n{_tail(outputs[0])}")
    return outputs
