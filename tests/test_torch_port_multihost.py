"""The port's loop as two real processes (the counterpart of
tests/test_multihost.py), and the multi-rank tools.

Two ranks on the CPU join a Gloo process group (parallel/launch.py, a
``file://`` store, one torch thread each) and run the same
``runtime.loop.run`` on a dp=2 mesh. Checked: both ranks finish and agree
on the summary (the seconds in ``timings`` aside); host I/O is the
coordinator's only (each rank gets a results directory of its own: the
other rank's stays empty); then both resume from the coordinator's
directory at dp=2."""

import json
import os
import textwrap

import numpy as np
import pytest

from custom_alphazero_tpu_torch.io.checkpoint import load_replay
from custom_alphazero_tpu_torch.parallel import launch

CHILD = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from custom_alphazero_tpu_torch.config import Config, apply_overrides
    from custom_alphazero_tpu_torch.parallel import distributed
    from custom_alphazero_tpu_torch.runtime.loop import run

    distributed.initialize(device="cpu")
    assert distributed.world_size() == 2
    dirs, generations = json.loads(sys.argv[1]), sys.argv[2]
    cfg = apply_overrides(Config(), {
        "mcts.simulations": "8",
        "self_play.games_per_generation": "8",
        "self_play.exclude_draws": "false",
        "self_play.max_plies": "12",
        "model.depth": "1", "model.filters": "8", "model.value_hidden": "16",
        "model.batch_size": "16",
        "replay.capacity": "2000", "replay.min_size": "16",
        "loop.train_iterations_per_generation": "2",
        "loop.generations": generations,
        "loop.samples_checkpoint_frequency": "1",
        "arena.games": "8",
        "arena.evaluation_frequency": "4", "arena.checkpoint_frequency": "4",
        "run.results_dir": dirs[distributed.rank()],
        "run.run_id": "mh",
    })
    summary = run(cfg, device="cpu")
    print("SUMMARY " + json.dumps(summary), flush=True)
    distributed.shutdown()
""")


def _run(dirs, generations):
    outs = launch.launch(2, ["-c", CHILD, json.dumps(dirs), str(generations)],
                         timeout_s=120, env={"OMP_NUM_THREADS": "1"})
    summaries = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("SUMMARY ")]
        assert lines, out[-2000:]
        summary = json.loads(lines[-1][len("SUMMARY "):])
        for timing in summary["timings"]:  # wall-clock seconds differ
            for key in [k for k in timing if k.endswith(("_s", "_second"))]:
                timing.pop(key)
        summaries.append(summary)
    assert summaries[0] == summaries[1], summaries
    return outs, summaries[0]


def _files(root):
    return [f for _, _, files in os.walk(root) for f in files]


def test_two_process_loop_coordinator_gated_then_resumed(tmp_path):
    dirs = [str(tmp_path / "proc0"), str(tmp_path / "proc1")]
    outs, summary = _run(dirs, 3)
    assert summary["iterations"] == 6
    assert summary["last_arena_score"] is not None
    # Both ranks' stats are the global ones: 8 games a generation.
    assert "from 8 games" in outs[0] and "[gen" not in outs[1]
    assert "distributed: world=2 backend=gloo devices=[cpu, cpu]" in outs[0]
    # The coordinator wrote the full run layout...
    run0 = os.path.join(dirs[0], "connect_n", "mh")
    assert os.path.isfile(os.path.join(run0, "config.json"))
    written = _files(dirs[0])
    assert any(f.endswith(".npz") for f in written)       # sample archives
    assert "metrics.jsonl" in written                     # metrics
    ring = load_replay(os.path.join(run0, "training"))
    # ...in JAX's dp=2 layout: 2 x 1000 rows, a cursor per shard...
    assert np.asarray(ring["value"]).shape == (2000,)
    assert np.asarray(ring["head"]).shape == (2,)
    sizes = np.asarray(ring["size"])
    # ...and the non-coordinator wrote nothing.
    assert not os.path.exists(dirs[1]) or not _files(dirs[1])

    # Resume: both ranks read the coordinator's directory.
    outs, resumed = _run([dirs[0], dirs[0]], 1)
    assert f"Resumed training state at step 6 (replay={int(sizes.sum())})" \
        in outs[0]
    assert resumed["iterations"] == 8
    assert np.asarray(load_replay(os.path.join(run0, "training"))["size"]
                      ).sum() > sizes.sum()


def test_scaling_measure_one_and_two_ranks():
    from custom_alphazero_tpu_torch.tools.scaling import measure

    r1 = measure(1, per_device_games=4, sims=6, plies=2, device="cpu",
                 iters=1)
    r2 = measure(2, per_device_games=4, sims=6, plies=2, device="cpu",
                 iters=1)
    assert r1["devices"] == 1 and r2["devices"] == 2
    for r in (r1, r2):
        assert set(r) == {"devices", "env_steps_per_s", "sims_per_s",
                          "seconds_per_rollout"}
        assert r["env_steps_per_s"] > 0
        # Two quotients of the same seconds: equal up to their rounding.
        assert r["sims_per_s"] == pytest.approx(r["env_steps_per_s"] * 6,
                                                rel=1e-12)


def test_dryrun_multigpu_four_ranks():
    """dp=2 x mp=2: JAX's five lines."""
    from custom_alphazero_tpu_torch.tools.dryrun_multigpu import (
        dryrun_multigpu,
    )

    out = dryrun_multigpu(4, "cpu", timeout_s=120)
    mesh = "mesh={'data': 2, 'model': 2}"
    for head in ("dryrun phase self-play OK: " + mesh,
                 "dryrun phase replay OK: ",
                 "dryrun phase train OK: loss=",
                 "dryrun phase arena OK: 4 games, score=",
                 "dryrun_multichip OK: " + mesh):
        assert head in out, out
    assert "sampled batch (4, 6, 7, 4)" in out


def test_collective_inventory_counts():
    """One dp=2 generation reduces its stats once; one train step reduces
    each of the net's 6 BatchNorm layers' statistics forward and backward,
    and the gradients once."""
    from custom_alphazero_tpu_torch.tools.multihost_proxy import (
        collective_inventory,
    )

    counts = collective_inventory(sims=4, games=16, device="cpu")
    assert counts == {"generate": {"all_reduce": 1},
                      "train_step": {"all_reduce": 2 * 6 + 1}}
