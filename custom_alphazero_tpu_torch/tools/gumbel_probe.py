"""Throughput probe of one standalone Gumbel search at chess scale (the
port of tools/gumbel_probe.py).

Runs ``GumbelMCTS.search_select`` alone (no generation loop around it) from
B chess start positions and prints its wall time and simulations/s. JAX's
probe bisected a TPU-only kernel fault with this program; that fault has no
counterpart on the card, and here the probe measures throughput only. The
first call warms up (its time is printed as ``first=``); the second is
timed. The net is a freshly initialised one of the default width, or the
uniform evaluator with ``--uniform=true``.

Run: python -m custom_alphazero_tpu_torch.tools.gumbel_probe [B]
       [--sims=N] [--uniform=true] [--device=cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from custom_alphazero_tpu_torch.config import (
    Config,
    apply_overrides,
    resolve_device,
)
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.loop import make_env
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.search.gumbel import GumbelMCTS
from custom_alphazero_tpu_torch.tools.cli import parse_args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags, positional = parse_args(argv, __doc__)
    b = int(positional[0]) if positional else 64
    sims = int(flags.pop("--sims", 100))
    uniform = flags.pop("--uniform", "false") == "true"
    device = resolve_device(flags.pop("--device", None))
    if flags:
        print(f"unknown flags: {sorted(flags)}", file=sys.stderr)
        return 2

    cfg = apply_overrides(Config(), {
        "game": "chess",
        "mcts.simulations": str(sims),
        "mcts.use_gumbel": "true",
        "mcts.use_dirichlet": "false",
    })
    env = make_env(cfg)
    search = GumbelMCTS(env, cfg.mcts)
    a = env.num_actions
    generator = torch.Generator(device=device).manual_seed(0)
    if uniform:
        def evaluate(obs):
            n = obs.shape[0]
            return (torch.full((n, a), 1.0 / a, device=obs.device),
                    torch.zeros((n,), device=obs.device))
    else:
        evaluate = make_evaluate_fn(init_train_state(
            a, cfg.model, generator, env.obs_shape, device=device).net)

    def run(seed: int):
        generator.manual_seed(seed)
        states = env.init(b, device)
        _, action, _ = search.search_select(states, evaluate, generator,
                                            sims)
        return action.cpu()  # waits for the device

    t0 = time.perf_counter()
    run(1)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    act = run(2)
    t = time.perf_counter() - t0
    print(
        f"OK B={b} sims={sims} uniform={uniform}: first={first:.1f}s "
        f"run={t:.3f}s ({b * sims / t:,.0f} sims/s) "
        f"actions[:4]={act[:4].tolist()}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
