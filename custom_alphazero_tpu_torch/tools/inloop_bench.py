"""In-loop self-play throughput probe (the port of tools/inloop_bench.py).

The full reference workload (250 simulations per move, the depth-4 /
128-filter net) across lockstep batch sizes, plain and continuous, measured
through the production ``Learner.generate`` (the fused search on Connect-4:
kernel K1 in one CUDA graph per wave), not the standalone search. A new
Learner has freshly initialised nets; its first generation also builds the
kernel and captures the graph, and its time is printed as ``first=``.

Run: python -m custom_alphazero_tpu_torch.tools.inloop_bench [B ...]
Flags: --iters=N (default 3) --device=cpu
"""

from __future__ import annotations

import sys

from custom_alphazero_tpu_torch.config import Config, apply_overrides
from custom_alphazero_tpu_torch.runtime.loop import Learner
from custom_alphazero_tpu_torch.tools.chess_inloop_bench import _generate
from custom_alphazero_tpu_torch.tools.cli import parse_args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags, positional = parse_args(argv, __doc__)
    batches = [int(a) for a in positional] or [1024, 2048]
    iters = int(flags.pop("--iters", 3))
    device = flags.pop("--device", None)
    if flags:
        print(f"unknown flags: {sorted(flags)}", file=sys.stderr)
        return 2

    for continuous in (False, True):
        for b in batches:
            cfg = apply_overrides(Config(), {
                "mcts.simulations": "250",
                "mcts.use_dirichlet": "true",
                "mcts.dirichlet_alpha": "1.0",
                "mcts.greedy_from_move": "12",
                "self_play.games_per_generation": str(b),
                "self_play.exclude_draws": "false",
                "self_play.continuous": "true" if continuous else "false",
            })
            learner = Learner(cfg, device=device)
            first, _, _ = _generate(learner)
            runs = [_generate(learner) for _ in range(iters)]
            times = [t for t, _, _ in runs]
            t, plies, samples = sorted(runs)[len(runs) // 2]
            sims = plies * cfg.mcts.simulations
            print(
                f"continuous={continuous} B={b}: {t:.2f}s/gen "
                f"(all {['%.2f' % x for x in times]}) "
                f"{sims / t:,.0f} sims/s, {samples} samples "
                f"({samples / t:,.0f} samples/s) first={first:.1f}s",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
