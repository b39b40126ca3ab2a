"""Multi-rank dry run of the full production cycle (the port of
``dryrun_multichip``, __graft_entry__.py).

N ranks on a (data, model) mesh (mp = 2 when N is even, else 1) at tiny
shapes run the loop's own programs once each: self-play shards, the
per-shard replay append and sample, the data-parallel train step (the
value head's hidden layer column-sharded at mp = 2) and the arena shards;
the coordinator prints JAX's five ``dryrun`` lines.

CLI:  python -m custom_alphazero_tpu_torch.tools.dryrun_multigpu N [--device=cpu]
"""

from __future__ import annotations

import sys

from custom_alphazero_tpu_torch.parallel import distributed, launch


def mesh_of(n_devices: int):
    """(dp, mp) of the dry run's mesh."""
    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // mp, mp


def dryrun_rank(n_devices: int, device=None) -> None:
    """One rank's part of the dry run."""
    import torch

    from custom_alphazero_tpu_torch.config import Config, apply_overrides
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    device = distributed.initialize(device)
    torch.set_num_threads(1)
    dp, mp = mesh_of(n_devices)
    cfg = apply_overrides(Config(), {
        "mcts.simulations": "8",
        "self_play.games_per_generation": str(dp * 2),
        "self_play.exclude_draws": "false",
        "model.depth": "1",
        "model.filters": "8",
        "model.value_hidden": str(mp * 8),
        "model.batch_size": str(dp * 2),
        "replay.capacity": str(dp * 64),
        "replay.min_size": str(dp * 2),
        "arena.games": str(dp * 2),
        "mesh.data_parallelism": str(dp),
        "mesh.model_parallelism": str(mp),
    })
    say = distributed.is_coordinator()
    learner = Learner(cfg, device)
    mesh_desc = learner.mesh.shape

    batch, stats = learner.generate()
    samples = int(distributed.all_reduce(
        batch.valid.sum().float(), learner.mesh.data_group).item())
    if int(stats.games) != dp * 2:
        raise RuntimeError(f"dryrun: {int(stats.games)} games, expected "
                           f"{dp * 2}")
    if say:
        print(f"dryrun phase self-play OK: mesh={mesh_desc}, "
              f"{samples} samples from {int(stats.games)} games")

    replay = learner.replay_add(learner.init_replay(), batch)
    size = int(distributed.all_reduce(
        replay.size.float(), learner.mesh.data_group).item())
    if size <= 0:
        raise RuntimeError("dryrun: the replay rings are empty")
    obs_b, pi_b, z_b = learner.replay_sample(replay)
    if say:
        print(f"dryrun phase replay OK: {size} rows across shards, "
              f"sampled batch {(cfg.model.batch_size, *obs_b.shape[1:])}")

    metrics = learner.train_step(obs_b, pi_b, z_b)
    if metrics.steps != 1:
        raise RuntimeError(f"dryrun: {metrics.steps} steps, expected 1")
    if say:
        print(f"dryrun phase train OK: loss={float(metrics.loss):.4f}")

    result = learner.run_arena()
    score = float(result.score)
    games = int(result.wins) + int(result.losses) + int(result.draws)
    if games != dp * 2:
        raise RuntimeError(f"dryrun: {games} arena games, expected "
                           f"{dp * 2}")
    if say:
        print(f"dryrun phase arena OK: {games} games, score={score:.3f}")
        print(f"dryrun_multichip OK: mesh={mesh_desc}", flush=True)
    distributed.shutdown()


def dryrun_multigpu(n_devices: int, device=None,
                    timeout_s: float = 600.0) -> str:
    """Run the dry run on ``n_devices`` ranks; returns the coordinator's
    output (raises when a rank fails)."""
    code = ("from custom_alphazero_tpu_torch.tools.dryrun_multigpu import "
            f"dryrun_rank; dryrun_rank({n_devices}, {device!r})")
    return launch.launch(n_devices, ["-c", code], timeout_s=timeout_s,
                         env={"OMP_NUM_THREADS": "1"})[0]


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    device = None
    rest = []
    for arg in args:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    if len(rest) != 1 or not rest[0].isdigit() or int(rest[0]) < 1:
        raise SystemExit("usage: dryrun_multigpu N [--device=cpu]")
    print(dryrun_multigpu(int(rest[0]), device), end="")


if __name__ == "__main__":
    main()
