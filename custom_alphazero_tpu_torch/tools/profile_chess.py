"""Where do chess search waves spend their time? (the port of
tools/profile_chess.py)

Times each part of a simulation wave separately at a given batch: engine
ops (step / step_lite / legal_mask / observe), the net forward (a freshly
initialised net of the default width, in its compute dtype), and a whole
general search, so that per-wave totals can be attributed before
optimizing. Every time is the median over ``iters`` calls after one
warm-up call, each call timed with CUDA events on the card (the device
drained at its end) and by the host clock on the CPU.

Run: python -m custom_alphazero_tpu_torch.tools.profile_chess [--batch=1024]
       [--sims=64] [--iters=20] [--device=cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import (
    ChessConfig,
    MCTSConfig,
    ModelConfig,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args


def _time(fn, args, iters=20, device=None) -> float:
    """Median ms of ``fn(*args)`` over ``iters`` calls after one warm-up."""
    device = resolve_device(device)
    fn(*args)
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    batch = int(args.get("--batch", 1024))
    sims = int(args.get("--sims", 64))
    iters = int(args.get("--iters", 20))
    device = resolve_device(args.get("--device"))

    env = Chess(ChessConfig())
    net = init_train_state(
        env.num_actions, ModelConfig(),
        torch.Generator(device=device).manual_seed(0), env.obs_shape,
        device=device).net
    evaluate = make_evaluate_fn(net)

    states = env.init(batch, device)
    legal = env.legal_mask(states)
    first_legal = legal.to(torch.uint8).argmax(-1)
    obs = env.observe(states)

    report = {"batch": batch}
    report["step_ms"] = _time(env.step, (states, first_legal), iters, device)
    report["step_lite_ms"] = _time(env.step_lite, (states, first_legal),
                                   iters, device)
    report["legal_mask_ms"] = _time(env.legal_mask, (states,), iters, device)
    report["observe_ms"] = _time(env.observe, (states,), iters, device)
    report["forward_ms"] = _time(evaluate, (obs,), iters, device)

    mcts = MCTS(env, MCTSConfig(simulations=sims))

    def search(st):
        return mcts.root_child_visits(mcts.search(st, evaluate, None, sims))

    ms = _time(search, (states,), max(3, iters // 4), device)
    report[f"search{sims}_ms"] = ms
    report[f"search{sims}_ms_per_wave"] = ms / sims
    report[f"search{sims}_sims_per_s"] = batch * sims / (ms / 1e3)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
