"""Summarize a run's metrics (the port of tools/run_report.py).

Prints the loss trajectory, self-play throughput, and the arena and
solver-score history with promotions and the lineage's Elo, from the
run's JSONL mirror of its scalars. Host code only: the same file gives the
JAX tool's dict and printed lines.

Run: python -m custom_alphazero_tpu_torch.tools.run_report --run_id=strong-r2 \\
         [--results_dir=results] [--game=connect_n]
"""

from __future__ import annotations

import json
import math
import os
import sys
from collections import defaultdict

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import from_json
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args


def load(results_dir: str, game: str, run_id: str) -> dict:
    """{tag: [(step, value), ...]} from the run's metrics.jsonl."""
    path = os.path.join(
        paths.tensorboard_path(results_dir, game, run_id), "metrics.jsonl"
    )
    by_tag = defaultdict(list)
    with open(path) as fp:
        for line in fp:
            row = json.loads(line)
            by_tag[row["tag"]].append((row["step"], row["value"]))
    return dict(by_tag)


def promotion_gate(results_dir: str, game: str, run_id: str) -> float:
    """The run's arena promote threshold, from its config.json snapshot;
    0.55 (the default) when there is no readable snapshot."""
    try:
        run_dir = paths.run_path(results_dir, game, run_id)
        with open(os.path.join(run_dir, paths.CONFIG_FILE)) as fp:
            return from_json(fp.read()).arena.promote_threshold
    except (OSError, ValueError, KeyError):
        return 0.55


def summarize(by_tag: dict, gate: float = 0.55) -> dict:
    out = {}
    loss = by_tag.get("train/loss", [])
    if loss:
        steps = [s for s, _ in loss]
        values = [v for _, v in loss]
        k = max(1, len(values) // 20)
        out["steps"] = steps[-1]
        out["loss_first"] = round(sum(values[:k]) / k, 4)
        out["loss_last"] = round(sum(values[-k:]) / k, 4)
        out["loss_min"] = round(min(values), 4)
    sims = [v for _, v in by_tag.get("self_play/sims_per_second", [])]
    if sims:
        out["sims_per_s_median"] = int(sorted(sims)[len(sims) // 2])
    games = [v for _, v in by_tag.get("self_play/games", [])]
    if games:
        out["generations"] = len(games)
        out["games_total"] = int(sum(games))
    samples = [v for _, v in by_tag.get("self_play/samples", [])]
    if samples:
        out["samples_total"] = int(sum(samples))
    arena = by_tag.get("evaluation/winning_score", [])
    if arena:
        out["arenas"] = len(arena)
        out["promotions"] = sum(1 for _, v in arena if v >= gate)
        out["arena_history"] = [(s, round(v, 3)) for s, v in arena]
    solver = by_tag.get("evaluation/solver_score", [])
    if solver:
        out["solver_score_history"] = [(s, round(v, 3)) for s, v in solver]
    if arena:
        out["elo_history"] = elo_history(arena, gate=gate)
        if out["elo_history"]:
            out["elo_gain"] = out["elo_history"][-1][1]
    return out


def elo_history(arena, gate: float = 0.55, cap: float = 0.99):
    """Cumulative Elo gain of the best-model lineage from the arena winning
    scores: a promotion at score s is a 400 * log10(s / (1 - s)) step over
    the previous best, an arena without promotion adds nothing. Scores are
    clipped to ``cap`` so that a clean sweep gives a finite step."""
    total, out = 0.0, []
    for step, score in arena:
        if score >= gate:
            s = min(max(score, 1.0 - cap), cap)
            total += 400.0 * math.log10(s / (1.0 - s))
            out.append((step, round(total, 1)))
    return out


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    results_dir = args.get("--results_dir", "results")
    game = args.get("--game", "connect_n")
    run_id = args["--run_id"]
    by_tag = load(results_dir, game, run_id)
    report = summarize(
        by_tag, gate=promotion_gate(results_dir, game, run_id)
    )
    for key, value in report.items():
        print(f"{key}: {value}")
    return report


if __name__ == "__main__":
    main()
