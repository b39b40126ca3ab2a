"""Profiling harness (the port of tools/profile.py).

- ``phase_timings``: wall-clock seconds per phase of the actor-learner loop
  (self-play generation, one train step, one arena) through the port's
  ``Learner``, the card drained around every call, and the derived rates;
- ``capture_trace``: a ``torch.profiler`` trace (host and CUDA activity) of
  one self-play generation, written as a Chrome trace (chrome://tracing,
  Perfetto) where JAX writes an xprof trace. A first generation runs
  before the trace, so the search's CUDA graph capture falls outside it.
  The trace carries the program's spans (io/trace.py: the generation, and
  each ply's root-noise draws and waves) as host ops of their names.

CLI:  python -m custom_alphazero_tpu_torch.tools.profile [--trace-dir=DIR]
        [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from custom_alphazero_tpu_torch.config import Config
from custom_alphazero_tpu_torch.runtime.loop import Learner
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args

TRACE_FILE = "selfplay.pt.trace.json"


def _sync() -> None:
    """Wait for the card, where one is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds of fn(*args) after ``warmup`` calls, the card
    drained before and after each call."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _learner(cfg: Config, batch_size: int, sims: int, device) -> Learner:
    cfg = dataclasses.replace(
        cfg,
        mcts=dataclasses.replace(cfg.mcts, simulations=sims),
        self_play=dataclasses.replace(cfg.self_play,
                                      games_per_generation=batch_size),
    )
    return Learner(cfg, device)


def phase_timings(cfg: Optional[Config] = None, batch_size: int = 256,
                  sims: int = 64, device=None) -> Dict[str, float]:
    """Seconds per call of generation, train step and arena on ``device``
    (None = the card), and the generation's simulations and samples per
    second. The nets are freshly initialised."""
    learner = _learner(cfg or Config(), batch_size, sims, device)
    t_selfplay = timed(learner.generate)
    batch, stats = learner.generate()
    replay = learner.replay_add(learner.init_replay(), batch)
    obs, pi, z = learner.replay_sample(replay)
    t_train = timed(lambda: learner.train_step(obs, pi, z))
    t_arena = timed(learner.run_arena, iters=1)
    plies = int(stats.plies)
    return {
        "selfplay_s": t_selfplay,
        "train_step_s": t_train,
        "arena_s": t_arena,
        "sims_per_s": plies * sims / t_selfplay,
        "samples_per_s": plies / t_selfplay,
    }


def capture_trace(trace_dir: str, batch_size: int = 1024, sims: int = 64,
                  cfg: Optional[Config] = None, device=None) -> str:
    """Record one self-play generation under ``torch.profiler`` and write
    it to ``trace_dir``; returns the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    learner = _learner(cfg or Config(), batch_size, sims, device)
    activities = [ProfilerActivity.CPU]
    if learner.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # Warm up: the first generation builds the kernel and captures the
    # search's graph.
    learner.generate()
    _sync()
    with profile(activities=activities) as prof:
        learner.generate()
        _sync()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"Trace written to {path}")
    return path


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    trace_dir = args.pop("--trace-dir", None)
    device = args.pop("--device", None)
    if args:
        print(f"unknown flags: {sorted(args)}", file=sys.stderr)
        return 2
    timings = phase_timings(device=device)
    for key, value in timings.items():
        print(f"{key}: {value:,.4f}")
    if trace_dir:
        capture_trace(trace_dir, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
