"""Multi-rank scaling PROXY measurement on one machine (the port of
tools/multihost_proxy.py).

What one machine can show of a run across cards, labelled as such:

1. **Work division**: the same generation workload (fixed TOTAL games) run
   by one rank (dp=1) and by two ranks (dp=2, parallel/launch.py), timing
   steady-state generations in each, plus one rank playing half the games:
   the per-rank compute of dp=2. Two ranks on one card, or on the CPU,
   share it, so the meaningful numbers are the division overhead (dp=2
   wall time against the half workload alone) and that the work is
   divided exactly.
2. **Collective inventory**: the collectives the port issued, counted by
   parallel/distributed.py's wrappers, over one dp=2 generation and one
   train step (JAX counts them in the compiled programs).

Run: python -m custom_alphazero_tpu_torch.tools.multihost_proxy [--games=64]
       [--sims=32] [--gens=4] [--device=cpu]
Writes a JSON report to stdout.
"""

from __future__ import annotations

import json
import re
import sys
import tempfile

from custom_alphazero_tpu_torch.parallel import launch

CHILD_TIMEOUT_S = 1200.0
INVENTORY = "COLLECTIVES "


def _overrides(games: int, sims: int, gens: int, mode: str) -> dict:
    return {
        "mcts.simulations": str(sims),
        # games_per_generation is GLOBAL: dp=2 splits it over the ranks.
        "self_play.games_per_generation": str(games),
        "self_play.exclude_draws": "false",
        "model.depth": "2", "model.filters": "32",
        "model.value_hidden": "32", "model.batch_size": "64",
        "replay.capacity": "20000", "replay.min_size": "64",
        "loop.train_iterations_per_generation": "1",
        "loop.generations": str(gens + 1),  # gen 0 = set-up, dropped
        "loop.samples_checkpoint_frequency": "0",
        "loop.visualize_frequency": "0",
        "arena.evaluation_frequency": "0",
        "arena.checkpoint_frequency": "0",
        "run.results_dir": tempfile.mkdtemp(),
        "run.run_id": f"proxy-{mode}",
        "run.compile_grace_minutes": "0",
    }


def run_rank(overrides: dict, device=None) -> None:
    """One rank of a proxy run: ``runtime.loop.run`` (the coordinator
    prints the "[gen N] ... in X.XXs" lines)."""
    import torch

    from custom_alphazero_tpu_torch.config import Config, apply_overrides
    from custom_alphazero_tpu_torch.parallel import distributed
    from custom_alphazero_tpu_torch.runtime.loop import run

    device = distributed.initialize(device)
    torch.set_num_threads(1)
    run(apply_overrides(Config(), overrides), device=device)
    distributed.shutdown()


def _run_children(mode, games, sims, gens, nproc, device):
    code = ("from custom_alphazero_tpu_torch.tools.multihost_proxy import "
            f"run_rank; run_rank({_overrides(games, sims, gens, mode)!r}, "
            f"{device!r})")
    out = launch.launch(nproc, ["-c", code], timeout_s=CHILD_TIMEOUT_S,
                        env={"OMP_NUM_THREADS": "1"})[0]
    gens_seen = [
        (int(m.group(1)), int(m.group(2)), float(m.group(3)))
        for m in re.finditer(
            r"\[gen (\d+)\] \d+ samples from (\d+) games in "
            r"([0-9.]+)s", out)
    ]
    steady = [t for g, _, t in gens_seen if g > 0]
    return {
        "mean_gen_s": sum(steady) / max(len(steady), 1),
        "games_per_gen": gens_seen[-1][1],
    }


def inventory_rank(sims: int, games: int, device=None) -> None:
    """One rank of ``collective_inventory``: the coordinator prints the
    counts of one generation and of one replay add, sample and train
    step."""
    import torch

    from custom_alphazero_tpu_torch.config import Config, apply_overrides
    from custom_alphazero_tpu_torch.parallel import distributed
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    device = distributed.initialize(device)
    torch.set_num_threads(1)
    cfg = apply_overrides(Config(), {
        "mcts.simulations": str(sims),
        "self_play.games_per_generation": str(max(games, 16)),
        "model.depth": "1", "model.filters": "16", "model.value_hidden": "16",
        "model.batch_size": "32",
        "replay.capacity": "1024", "replay.min_size": "32",
        "arena.games": "32",
        "mesh.data_parallelism": "2",
    })
    learner = Learner(cfg, device)
    counts = {}
    distributed.reset_counts()
    batch, _ = learner.generate()
    counts["generate"] = dict(distributed.COUNTS)
    distributed.reset_counts()
    replay = learner.replay_add(learner.init_replay(), batch)
    learner.train_step(*learner.replay_sample(replay))
    counts["train_step"] = dict(distributed.COUNTS)
    if distributed.is_coordinator():
        print(INVENTORY + json.dumps(counts), flush=True)
    distributed.shutdown()


def collective_inventory(sims: int = 16, games: int = 16,
                         device=None) -> dict:
    """Collectives of one dp=2 generation and one dp=2 train step, by
    kind."""
    code = ("from custom_alphazero_tpu_torch.tools.multihost_proxy import "
            f"inventory_rank; inventory_rank({sims}, {games}, {device!r})")
    out = launch.launch(2, ["-c", code], timeout_s=CHILD_TIMEOUT_S,
                        env={"OMP_NUM_THREADS": "1"})[0]
    line = next(line for line in out.splitlines()
                if line.startswith(INVENTORY))
    return json.loads(line[len(INVENTORY):])


def main(argv=None):
    from custom_alphazero_tpu_torch.tools.cli import parse_kv_args

    args = parse_kv_args(argv or sys.argv[1:], __doc__)
    games = int(args.get("--games", 64))
    sims = int(args.get("--sims", 32))
    gens = int(args.get("--gens", 4))
    device = args.get("--device")

    report = {
        "DISCLAIMER": (
            "PROXY on one machine whose ranks share one card (or its CPU "
            "cores); NOT a measurement across cards. Real N-card "
            "efficiency needs N cards (BASELINE scaling row remains "
            "environment-limited)."
        ),
    }
    # dp=1: whole workload in one rank.
    report["dp1"] = _run_children("solo", games, sims, gens, 1, device)
    # Half workload in one rank: the per-rank compute baseline for dp=2
    # on a shared card (real cards would each run this alone).
    report["dp1_half_workload"] = _run_children("solo", games // 2, sims,
                                                gens, 1, device)
    # dp=2: two ranks, the same TOTAL workload. The coordinator's [gen]
    # lines report GLOBAL games (summed stats).
    report["dp2"] = _run_children("dist", games, sims, gens, 2, device)
    t_half = report["dp1_half_workload"]["mean_gen_s"]
    t_dp2 = report["dp2"]["mean_gen_s"]
    report["division_exact"] = report["dp2"]["games_per_gen"] == games
    # On a shared card a dp=2 generation costs at least the half-workload
    # time (same per-rank compute) + collective/coordination overhead;
    # this ratio isolates that overhead.
    report["dp2_overhead_vs_half_workload"] = (t_dp2 - t_half) / t_half
    print(json.dumps(report, indent=2), flush=True)  # timings first
    report["collectives_dp2"] = collective_inventory(sims, games, device)
    print(json.dumps({"collectives_dp2": report["collectives_dp2"]},
                     indent=2))
    return report


if __name__ == "__main__":
    main()
