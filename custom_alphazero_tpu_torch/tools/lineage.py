"""Strength progression over a run's promotion lineage (the port of
tools/lineage.py).

Walks every promoted best-model checkpoint (``evaluation/iteration_N``)
and scores each against the exact-solver oracle:

- raw-policy move/value accuracy on a precomputed solver-labeled position
  set (no solver calls; tools/distill.py output);
- optionally a searched strength probe per promotion
  (tools/strength.evaluate_strength) at ``--probe_games`` games.

A random-initialisation row comes first. Its weights come from torch's
initialisation stream, not JAX's draws, so that row differs from the JAX
tool's; the promoted rows are the same checkpoints.

Output: a markdown table (promotion iteration -> accuracies) plus one JSON
line; the number of CUDA graph captures (one per probed checkpoint) goes to
stderr.

Run: python -m custom_alphazero_tpu_torch.tools.lineage --run_id=strong-r2 \\
       --labels=data/eval_labels.npz [--probe_games=0] [--sims=250] \\
       [--device=cpu]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import (
    MCTSConfig,
    from_json,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.io.checkpoint import (
    list_evaluation_iterations,
    load_checkpoint,
)
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args
from custom_alphazero_tpu_torch.tools.strength import (
    evaluate_strength,
    labeled_policy_accuracy,
)


def lineage_report(
    run_id: str,
    results_dir: str = "results",
    game: str = "connect_n",
    labels: str | None = None,
    probe_games: int = 0,
    sims: int | None = None,
    include_random_init: bool = True,
    device=None,
) -> dict:
    """Score every promoted checkpoint of ``run_id`` on ``device`` (None =
    the card); returns {run_id, sims, entries: [{iteration, steps,
    move_accuracy, ...}]}.

    ``include_random_init`` prepends a random-initialisation row (the
    baseline any promotion must beat)."""
    device = resolve_device(device)
    run_dir = paths.run_path(results_dir, game, run_id)
    with open(os.path.join(run_dir, paths.CONFIG_FILE)) as fp:
        cfg = from_json(fp.read())
    if game == "chess":
        if probe_games > 0:
            raise SystemExit(
                "--probe_games uses the Connect-4 exact-solver oracle; "
                "for chess lineages use --labels (e.g. a tactics set from "
                "tools/chess_tactics.py) or tools/chess_strength.py"
            )
        env = Chess(cfg.chess)
    else:
        env = ConnectN(cfg.connect_n)
    sims = sims if sims is not None else cfg.mcts.simulations
    lineage = list_evaluation_iterations(
        paths.evaluation_path(results_dir, game, run_id)
    )

    def score(net, iteration, steps):
        evaluate_fn = make_evaluate_fn(net)
        entry = {"iteration": iteration, "steps": steps}
        if labels:
            entry.update(labeled_policy_accuracy(evaluate_fn, labels,
                                                 device=device))
        if probe_games > 0:
            probe = evaluate_strength(
                env, evaluate_fn, num_games=probe_games, use_mcts=True,
                mcts_cfg=MCTSConfig(simulations=sims), opponent="random",
                device=device,
            )
            entry["mcts_move_accuracy"] = probe["move_accuracy"]
            entry["mcts_rank_score"] = probe["mean_rank_score"]
        return entry

    entries = []
    if include_random_init:
        template = init_train_state(
            env.num_actions, cfg.model,
            torch.Generator(device=device).manual_seed(0), env.obs_shape,
            device=device,
        )
        entries.append(score(template.net, "random-init", 0))
    for iteration, path in lineage:
        tree, meta = load_checkpoint(path)
        net = from_jax_variables(
            tree["params"], tree["batch_stats"], env.num_actions, cfg.model,
            env.obs_shape[-1], env.obs_shape[:2], device=device)
        entries.append(score(net, iteration, meta.get("steps")))
    return {"run_id": run_id, "sims": sims, "entries": entries}


def format_table(report: dict) -> str:
    entries = report["entries"]
    probe = any("mcts_move_accuracy" in e for e in entries)
    labeled = any("move_accuracy" in e for e in entries)
    head = ["promotion iter", "steps"]
    if labeled:
        head += ["labeled move acc", "labeled value acc", "value sign acc"]
    if probe:
        head += [f"MCTS-{report['sims']} move acc", "rank score"]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for e in entries:
        row = [str(e["iteration"]), str(e["steps"])]
        if labeled:
            row += [f"{e.get('move_accuracy', float('nan')):.3f}",
                    f"{e.get('value_accuracy', float('nan')):.3f}",
                    f"{e.get('value_sign_accuracy', float('nan')):.3f}"]
        if probe:
            row += [f"{e.get('mcts_move_accuracy', float('nan')):.3f}",
                    f"{e.get('mcts_rank_score', float('nan')):.3f}"]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    captures = FusedConnectNSearchV2.captures
    report = lineage_report(
        args["--run_id"],
        results_dir=args.get("--results_dir", "results"),
        game=args.get("--game", "connect_n"),
        labels=args.get("--labels"),
        probe_games=int(args.get("--probe_games", 0)),
        sims=int(args["--sims"]) if "--sims" in args else None,
        device=args.get("--device"),
    )
    print(format_table(report))
    print(json.dumps(report))
    print(f"graph captures: {FusedConnectNSearchV2.captures - captures}",
          file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
