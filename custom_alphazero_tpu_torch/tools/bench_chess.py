"""Chess search throughput benchmark (the port of tools/bench_chess.py).

Measures simulations/s of the general search on the chess engine with the
reference-scale net (depth 4, 128 filters, freshly initialised, bf16) and
with a uniform evaluator (the search and engine cost without the net).
``--sims=800`` is AlphaZero's 800 simulations per move. Each batch size is
warmed up with one search, then three searches are timed: CUDA events on
the card, the host clock on the CPU.

Run: python -m custom_alphazero_tpu_torch.tools.bench_chess [--sims=N]
       [--topk=K] [--fast] [--device=cpu] [B1 B2 ...]
(B: positive batch sizes, default 64 256 1024; --fast turns on
mcts.fast_edge_stats; --topk sets mcts.topk_actions.)
"""

from __future__ import annotations

import sys

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
from custom_alphazero_tpu_torch.tools.chess_tactics import uniform_evaluate
from custom_alphazero_tpu_torch.tools.cli import usage_error
from custom_alphazero_tpu_torch.tools.profile_chess import _time

SIMS = 64  # default; override with --sims=
NET = ModelConfig(depth=4, filters=128, value_hidden=256)
USAGE = ("usage: bench_chess [--sims=N] [--topk=K] [--fast] [--device=cpu] "
         "[B1 B2 ...] (positive ints; default 64 256 1024)")


def measure(batch_size: int, use_net: bool = True, sims: int = None,
            topk: int = 0, fast: bool = False, device=None) -> float:
    """Simulations/s of one search of ``batch_size`` opening positions."""
    device = resolve_device(device)
    sims = sims or SIMS
    env = Chess(ChessConfig())
    mcts = MCTS(env, MCTSConfig(simulations=sims, topk_actions=topk,
                                fast_edge_stats=fast))
    if use_net:
        net = init_train_state(
            env.num_actions, NET,
            torch.Generator(device=device).manual_seed(0), env.obs_shape,
            device=device).net
        evaluate_fn = make_evaluate_fn(net)
    else:
        evaluate_fn = uniform_evaluate(env.num_actions)

    def search(states):
        tree = mcts.search(states, evaluate_fn, None, sims)
        return mcts.root_child_visits(tree)

    states = env.init(batch_size, device)
    ms = _time(search, (states,), 3, device)
    rate = batch_size * sims / (ms / 1e3)
    name = "net" if use_net else "uniform"
    if fast:
        name += "+fast"
    print(f"B={batch_size} [{name}]: {rate:,.0f} sims/s ({ms:.1f} ms/search)")
    return rate


def main(argv=None):
    sizes = []
    sims, topk, fast, device = None, 0, False, None
    for a in sys.argv[1:] if argv is None else argv:
        if a == "--fast":
            fast = True
        elif a.startswith("--sims="):
            sims = int(a.split("=", 1)[1])
        elif a.startswith("--topk="):
            topk = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.isdigit() and int(a) >= 1:
            sizes.append(int(a))
        else:
            raise usage_error(f"bad batch size {a!r}", USAGE)
    sizes = sizes or [64, 256, 1024]
    rates = {}
    for b in sizes:
        rates[("net", b)] = measure(b, True, sims, topk, fast, device)
    for b in sizes[-2:]:
        rates[("uniform", b)] = measure(b, False, sims, topk, fast, device)
    return rates


if __name__ == "__main__":
    main()
