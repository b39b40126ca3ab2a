"""Chess generation throughput through the Learner (the port of
tools/chess_inloop_bench.py).

Measures simulations/s and samples/s of ``Learner.generate`` (the
production generation program, observations bit-packed ply by ply) on
chess at a large lockstep batch, for the PUCT and the Gumbel regimes. A
new Learner has freshly initialised nets; its first generation also
warms up, and its time is printed as ``first=``.

Run: python -m custom_alphazero_tpu_torch.tools.chess_inloop_bench [B ...]
Flags: --sims=N (default 100) --gumbel={both,true,false} --iters=N
       --compress=true --max_plies=N --device=cpu
"""

from __future__ import annotations

import sys
import time

from custom_alphazero_tpu_torch.config import Config, apply_overrides
from custom_alphazero_tpu_torch.runtime.loop import Learner
from custom_alphazero_tpu_torch.tools.cli import parse_args


def _generate(learner: Learner):
    """(seconds, plies, valid samples) of one generation."""
    t0 = time.perf_counter()
    batch, stats = learner.generate()
    # Reading the counts waits for the device.
    plies = int(stats.plies)
    samples = int(batch.valid.sum())
    return time.perf_counter() - t0, plies, samples


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags, positional = parse_args(argv, __doc__)
    batches = [int(a) for a in positional] or [256]
    sims = int(flags.pop("--sims", 100))
    gumbel_mode = flags.pop("--gumbel", "both")
    iters = int(flags.pop("--iters", 2))
    compress = flags.pop("--compress", "true")
    max_plies = flags.pop("--max_plies", "")
    device = flags.pop("--device", None)
    if flags:
        print(f"unknown flags: {sorted(flags)}", file=sys.stderr)
        return 2

    gumbel_arms = {
        "both": (False, True), "true": (True,), "false": (False,)
    }[gumbel_mode]
    for gumbel in gumbel_arms:
        for b in batches:
            cfg = apply_overrides(Config(), {
                "game": "chess",
                "mcts.simulations": str(sims),
                "mcts.use_dirichlet": "false" if gumbel else "true",
                "mcts.dirichlet_alpha": "0.3",
                "mcts.use_gumbel": "true" if gumbel else "false",
                "mcts.greedy_from_move": "30",
                "self_play.games_per_generation": str(b),
                "self_play.exclude_draws": "false",
                "self_play.continuous": "true",
                "replay.compress_obs": compress,
                **({"self_play.max_plies": max_plies} if max_plies else {}),
            })
            learner = Learner(cfg, device=device)
            first, _, _ = _generate(learner)
            runs = [_generate(learner) for _ in range(iters)]
            times = [t for t, _, _ in runs]
            t, plies, samples = sorted(runs)[len(runs) // 2]
            n_sims = plies * sims
            print(
                f"gumbel={gumbel} B={b} sims={sims}: {t:.2f}s/gen "
                f"(all {['%.2f' % x for x in times]}) "
                f"{n_sims / t:,.0f} sims/s, {samples} samples "
                f"({samples / t:,.0f} samples/s) first={first:.1f}s",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
