"""Full strength report for a trained run (the port of tools/final_eval.py,
the BASELINE strength protocol).

Loads a run's best promoted model and reports, against the exact-solver
oracle:

1. raw-policy move/value accuracy on a precomputed labeled position set
   (tools/distill.py output), if given;
2. searched move accuracy / rank score / blunders against a RANDOM
   opponent from random ply-8 openings (tools/strength.evaluate_strength;
   the fused search, kernel K1, on the card);
3. the same against the PERFECT (solver) opponent.

The report and its printed lines are the JAX tool's; the number of CUDA
graph captures goes to stderr.

Run: python -m custom_alphazero_tpu_torch.tools.final_eval --run_id=strong-r1 \\
       [--labels=data/eval_labels.npz] [--games=20] [--sims=250] \\
       [--seed=0] [--which=best] [--results_dir=results] [--device=cpu]
"""

from __future__ import annotations

import json
import sys

from custom_alphazero_tpu_torch.config import MCTSConfig
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from custom_alphazero_tpu_torch.tools.strength import (
    evaluate_strength,
    labeled_policy_accuracy,
    load_run_model,
)


def main(argv=None):
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None
                                          else argv))
    run_id = args["--run_id"]
    games = int(args.get("--games", 20))
    device = args.get("--device")
    captures = FusedConnectNSearchV2.captures
    env, evaluate_fn, cfg, meta = load_run_model(
        run_id, args.get("--results_dir", "results"),
        args.get("--which", "best"), device=device,
    )
    sims = int(args.get("--sims", cfg.mcts.simulations))
    report = {"run_id": run_id, "which": args.get("--which", "best"),
              "steps": meta.get("steps"), "iteration": meta.get("iteration"),
              "sims": sims}
    if "--labels" in args:
        report["raw_policy_labeled"] = labeled_policy_accuracy(
            evaluate_fn, args["--labels"], device=device
        )
        print("raw-policy labeled:", report["raw_policy_labeled"], flush=True)
    for opponent in ("random", "perfect"):
        r = evaluate_strength(
            env, evaluate_fn, num_games=games, use_mcts=True,
            mcts_cfg=MCTSConfig(simulations=sims), opponent=opponent,
            seed=int(args.get("--seed", 0)), device=device,
        )
        r["wdl"] = (
            sum(x == 1 for x in r["results"]),
            sum(x == 0 for x in r["results"]),
            sum(x == -1 for x in r["results"]),
        )
        # Oracle-normalized per-opening outcomes: solver-expected beside
        # achieved ("converts N wins" means something only next to how
        # many openings were theoretically won).
        r["openings"] = [
            {"expected": e, "achieved": a}
            for e, a in zip(r.pop("expected_results"), r.pop("results"))
        ]
        report[f"mcts_vs_{opponent}"] = r
        print(f"mcts vs {opponent}:", {
            k: v for k, v in r.items() if k != "openings"
        }, flush=True)
        print(
            "  openings (expected->achieved): "
            + " ".join(
                f"{o['expected']:+d}->{o['achieved']:+d}"
                for o in r["openings"]
            ),
            flush=True,
        )
        print(
            f"  converted {r['converted_wins']}/{r['expected_wins']} won "
            f"openings; losses from non-lost openings: "
            f"{r['losses_from_nonlost']}",
            flush=True,
        )
    print(json.dumps(report, default=str))
    print(f"graph captures: {FusedConnectNSearchV2.captures - captures}",
          file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
