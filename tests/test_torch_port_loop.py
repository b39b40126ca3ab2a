"""The port's actor-learner loop end to end on the CPU at a tiny size:
generate -> replay -> train -> arena -> promote -> checkpoint, resume, the
STOP file, the guardrails, and the configuration tree it reads."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from custom_alphazero_tpu import config as jax_config
from custom_alphazero_tpu import paths as jax_paths
from custom_alphazero_tpu_torch import config as port_config
from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import Config, apply_overrides
from custom_alphazero_tpu_torch.io.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    load_replay,
)
from custom_alphazero_tpu_torch.io.metrics import MetricsWriter, crc32c
from custom_alphazero_tpu_torch.models.convert import train_state_from_jax
from custom_alphazero_tpu_torch.replay.codec import PackedObs
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime import loop as loop_module
from custom_alphazero_tpu_torch.runtime import watchdog
from custom_alphazero_tpu_torch.runtime.loop import (
    Learner,
    main,
    max_game_plies,
    run,
)

C4R5_CONFIG = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                           "c4-r5", "config.json")


def _tiny_cfg(tmp_path, run_id, generations, **extra):
    overrides = {
        "mcts.simulations": "8",
        "self_play.games_per_generation": "8",
        "model.depth": "1",
        "model.filters": "8",
        "model.value_hidden": "16",
        "model.batch_size": "16",
        "replay.capacity": "2000",
        "replay.min_size": "32",
        "loop.train_iterations_per_generation": "2",
        "loop.generations": str(generations),
        "loop.samples_checkpoint_frequency": "2",
        "arena.games": "8",
        "arena.evaluation_frequency": "4",
        "arena.checkpoint_frequency": "4",
        "run.results_dir": str(tmp_path),
        "run.run_id": run_id,
    }
    overrides.update(extra)
    return apply_overrides(Config(), overrides)


def _metrics(tmp_path, run_id):
    jsonl = os.path.join(
        paths.tensorboard_path(str(tmp_path), "connect_n", run_id),
        "metrics.jsonl")
    with open(jsonl) as fp:
        return [json.loads(line) for line in fp]


# Games cut at 12 plies (kept as draws) make a generation and an arena a
# third as long as full 42-ply games on the CPU.
SHORT_GAMES = {"self_play.max_plies": "12", "self_play.exclude_draws": "false"}


def test_loop_end_to_end_and_resume(tmp_path, capsys):
    summary = run(_tiny_cfg(tmp_path, "t1", 3, **SHORT_GAMES), device="cpu")
    assert summary["iterations"] == 6
    assert summary["last_arena_score"] is not None
    assert [t["train_iterations"] for t in summary["timings"]] == [2, 2, 2]
    out = capsys.readouterr().out
    assert "Starting run t1 on cpu" in out
    assert "[gen 2]" in out and "[iter 4] arena score=" in out

    run_dir = paths.run_path(str(tmp_path), "connect_n", "t1")
    with open(os.path.join(run_dir, "config.json")) as fp:
        assert json.load(fp)["mcts"]["simulations"] == 8
    training = paths.training_path(str(tmp_path), "connect_n", "t1")
    tree, meta = load_checkpoint(training)
    replay = load_replay(training)
    assert meta["steps"] == 6 == int(tree["steps"])
    assert replay is not None and int(replay["size"]) > 32
    assert replay["obs"]["words"].dtype == np.uint32  # bit-packed ring
    # The arena's winner landed in the lineage.
    assert checkpoint_exists(paths.evaluation_iteration_path(
        str(tmp_path), "connect_n", "t1", 4))
    # The samples archive of generation 1 (every second generation).
    samples = np.load(paths.samples_path(str(tmp_path), "connect_n", "t1", 1))
    assert samples["states"].shape[1:] == (6, 7, 4)
    assert len(samples["states"]) == len(samples["policies"]) == len(
        samples["values"]) > 0
    tags = {m["tag"] for m in _metrics(tmp_path, "t1")}
    assert {"self_play/samples", "self_play/sims_per_second", "train/loss",
            "train/learning_rate", "train/steps", "train/sample_reuse",
            "evaluation/winning_score"} <= tags

    # Resume: steps, ring and best model continue from the checkpoint.
    summary2 = run(_tiny_cfg(tmp_path, "t1", 2, **SHORT_GAMES), device="cpu")
    assert summary2["iterations"] == 10
    out = capsys.readouterr().out
    assert f"Resumed training state at step 6 (replay={int(replay['size'])})" \
        in out
    assert "Restored best model from iteration 4" in out
    tree, meta = load_checkpoint(training)
    assert meta["steps"] == 10

    # The JAX package's strength tool loads the run the port trained, and
    # its evaluator agrees with the port's net from the same checkpoint.
    import jax.numpy as jnp

    from custom_alphazero_tpu.tools.strength import load_run_model

    _, jax_evaluate, jax_cfg, jax_meta = load_run_model(
        "t1", str(tmp_path), which="last")
    assert jax_meta["steps"] == 10 and jax_cfg.model.filters == 8
    assert load_run_model("t1", str(tmp_path), which="best")[3][
        "iteration"] >= 4
    obs = np.random.default_rng(0).random((4, 6, 7, 4)).astype(np.float32)
    net = train_state_from_jax(
        tree, 7, port_config.ModelConfig(depth=1, filters=8, value_hidden=16),
        device="cpu").net
    probs, value = make_evaluate_fn(net)(torch.from_numpy(obs))
    ref_probs, ref_value = jax_evaluate(jnp.asarray(obs))
    # bf16 trunks in both packages: the net tests' bf16 bound.
    np.testing.assert_allclose(probs.numpy(), ref_probs, atol=1e-2)
    np.testing.assert_allclose(value.numpy(), ref_value, atol=1e-2)


def test_stop_file_graceful_exit_and_final_checkpoint(tmp_path):
    run_dir = paths.run_path(str(tmp_path), "connect_n", "t2")
    os.makedirs(run_dir)
    stop = os.path.join(run_dir, "STOP")
    open(stop, "w").close()
    # A STOP file from before the start is consumed: the run still trains,
    # and its exit state is resumable though 2 is no checkpoint boundary.
    summary = run(_tiny_cfg(tmp_path, "t2", 1), device="cpu")
    assert summary["iterations"] == 2
    assert not os.path.exists(stop)
    training = paths.training_path(str(tmp_path), "connect_n", "t2")
    assert load_checkpoint(training)[1]["steps"] == 2

    # Mid-run STOP: a run-forever loop exits once the file appears.
    done = {}
    thread = threading.Thread(target=lambda: done.update(
        summary=run(_tiny_cfg(tmp_path, "t2", 0), device="cpu")))
    thread.start()
    deadline = time.time() + 60
    while time.time() < deadline and not done:
        time.sleep(0.2)
        if os.path.exists(os.path.join(run_dir, "tensorboard")):
            open(stop, "w").close()
    thread.join(timeout=60)
    assert not thread.is_alive(), "the loop did not honour a mid-run STOP"
    assert done["summary"]["iterations"] >= 2


def test_promotion_changes_the_next_generation_in_place(tmp_path):
    """A candidate that wins is copied into the best net in place, and the
    next generation's moves come from the new weights."""
    cfg = _tiny_cfg(tmp_path, "p1", 1, **{"mcts.greedy_from_move": "0",
                                          "self_play.max_plies": "12"})
    learner = Learner(cfg, device="cpu")
    best_pointers = [t.data_ptr() for t in learner.best.state_dict().values()]
    evaluate_best = learner.evaluate_best

    def generation():
        learner.generator.manual_seed(0)
        return learner.generate()[0]

    before = generation()
    assert torch.equal(generation().policy, before.policy)
    # Train the candidate away from the best net: nothing changes yet.
    obs, pi, z = (before.obs[:16], torch.eye(7)[torch.arange(16) % 7],
                  torch.ones(16))
    for _ in range(30):
        learner.train_step(obs, pi, z)
    assert learner.train_state.steps == 30
    assert torch.equal(generation().policy, before.policy)
    learner.promote()
    after = generation()
    assert not torch.equal(after.policy, before.policy)
    assert best_pointers == [t.data_ptr()
                             for t in learner.best.state_dict().values()]
    assert learner.evaluate_best is evaluate_best
    assert not learner.best.training and not learner.train_state.net.training
    for a, b in zip(learner.best.state_dict().values(),
                    learner.train_state.net.state_dict().values()):
        assert torch.equal(a, b)

    # Through run(): a threshold of 0 promotes at every arena.
    summary = run(_tiny_cfg(tmp_path, "p2", 3,
                            **{"arena.promote_threshold": "0.0"}),
                  device="cpu")
    assert summary["promotions"] == 1


def test_large_observations_are_packed_inside_the_generation(tmp_path):
    """From 2048 floats per observation on (here a 23 x 23 board) the
    generation packs its observations ply by ply, the ring takes the packed
    batch as it is, and the samples archive decodes the valid rows."""
    cfg = _tiny_cfg(tmp_path, "big", 2, **{
        "connect_n.width": "23", "connect_n.height": "23",
        "self_play.max_plies": "6", "self_play.exclude_draws": "false",
        "mcts.simulations": "4", "arena.evaluation_frequency": "0",
    })
    learner = Learner(cfg, device="cpu")
    batch, _ = learner.generate()
    assert isinstance(batch.obs, PackedObs)
    assert batch.obs.words.shape == (6 * 8, -(-23 * 23 * 4 // 32))
    ring = learner.replay_add(learner.init_replay(), batch)
    assert int(ring.size) == 48
    obs, _, _ = learner.replay_sample(ring)
    assert obs.shape == (16, 23, 23, 4)
    assert torch.equal(obs.sum(-1) >= 1, torch.ones(16, 23, 23,
                                                    dtype=torch.bool))

    summary = run(cfg, device="cpu")
    assert summary["iterations"] == 4
    samples = np.load(paths.samples_path(str(tmp_path), "connect_n", "big",
                                         1))
    assert samples["states"].shape == (48, 23, 23, 4)
    assert set(np.unique(samples["states"])) <= {0.0, 1.0}


def test_sample_reuse_guardrail_clamps_and_reports(tmp_path, capsys):
    cfg = _tiny_cfg(tmp_path, "reuse1", 2, **{
        # 50 x 16 = 800 trained samples per generation against ~100-200
        # fresh ones: reuse would be 4-8 unclamped.
        "loop.train_iterations_per_generation": "50",
        "loop.max_sample_reuse": "1.0",
        "arena.evaluation_frequency": "0",
        "arena.checkpoint_frequency": "0",
    })
    summary = run(cfg, device="cpu")
    assert 2 <= summary["iterations"] < 100
    assert "clamping to" in capsys.readouterr().out
    reuse = [m["value"] for m in _metrics(tmp_path, "reuse1")
             if m["tag"] == "train/sample_reuse"]
    assert reuse and all(v <= 1.0 + 1e-6 for v in reuse)
    for timing in summary["timings"]:
        if timing["train_iterations"]:
            assert timing["train_iterations"] == max(
                timing["samples"] // 16, 1)
    # Without the bound the loop only warns.
    cfg = _tiny_cfg(tmp_path, "reuse2", 1, **{
        "loop.train_iterations_per_generation": "20",
        "replay.min_size": "16",
        "arena.evaluation_frequency": "0",
        "arena.checkpoint_frequency": "0",
    })
    assert run(cfg, device="cpu")["iterations"] == 20
    assert "WARNING: sample reuse" in capsys.readouterr().out


def test_non_finite_loss_aborts(tmp_path, monkeypatch):
    cfg = _tiny_cfg(tmp_path, "nanabort", 3, **{
        "model.lr_values": "(1000000.0,)",
        "model.lr_boundaries": "()",
        "loop.train_iterations_per_generation": "8",
        "arena.evaluation_frequency": "0",
        "arena.checkpoint_frequency": "0",
        "run.watchdog_minutes": "5",
    })
    armed = []

    def start(heartbeat):
        armed.append(watchdog.start_watchdog(heartbeat))
        return armed[-1]

    monkeypatch.setattr(loop_module, "start_watchdog", start)
    with pytest.raises(RuntimeError, match="non-finite"):
        run(cfg, device="cpu")
    # The abort leaves nothing behind: the watchdog is disarmed.
    assert len(armed) == 1 and armed[0]._disarmed.is_set()


@pytest.mark.parametrize("policy_weight", [0.0, 0.5],
                         ids=["aux_value", "aux_value_and_policy"])
def test_loop_with_aux_targets(tmp_path, policy_weight):
    rng = np.random.default_rng(0)
    n = 64
    pi = np.zeros((n, 7), np.float32)
    pi[np.arange(n), rng.integers(0, 7, n)] = 1.0
    labels = tmp_path / "labels.npz"
    np.savez(labels,
             obs=rng.standard_normal((n, 6, 7, 4)).astype(np.float32),
             z=rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32), pi=pi)
    cfg = _tiny_cfg(tmp_path, "aux1", 2, **{
        "loop.solver_labels_path": str(labels),
        "loop.solver_value_weight": "0.5",
        "loop.solver_policy_weight": str(policy_weight),
        "loop.solver_value_batch": "16",
        **SHORT_GAMES,
    })
    summary = run(cfg, device="cpu")
    assert summary["iterations"] >= 2
    learner = Learner(cfg, device="cpu")
    assert learner.solver_labels[0].shape == (64, 6, 7, 4)
    assert (learner.solver_labels_pi is not None) == (policy_weight > 0)
    tags = {m["tag"] for m in _metrics(tmp_path, "aux1")}
    assert "train/solver_value_loss" in tags
    assert ("train/solver_policy_loss" in tags) == (policy_weight > 0)
    if policy_weight > 0:
        np.savez(labels, obs=np.zeros((4, 6, 7, 4), np.float32),
                 z=np.zeros(4, np.float32))
        with pytest.raises(ValueError, match="'pi'"):
            Learner(cfg, device="cpu")


@pytest.mark.parametrize("overrides, item", [
    ({"game": "chess"}, "Chess engine"),
    ({"mesh.data_parallelism": "4"}, "Multi-GPU"),
    ({"mesh.model_parallelism": "2"}, "Multi-GPU"),
    ({"mcts.use_gumbel": "true"}, "Gumbel search"),
    ({"mcts.reuse_tree": "true"}, "Subtree reuse"),
])
def test_unported_settings_raise_at_construction(tmp_path, overrides, item):
    """Every setting is ported. Chess, Gumbel search and subtree reuse: the
    Learner builds them, and with reuse it generates. Multi-GPU: a mesh
    larger than the one process raises JAX's ``make_mesh`` ValueError
    before anything starts."""
    cfg = _tiny_cfg(tmp_path, "np", 1, **overrides)
    if item == "Subtree reuse":
        cfg = _tiny_cfg(tmp_path, "np", 1, **overrides,
                        **{"self_play.max_plies": "6"})
        batch, stats = Learner(cfg, device="cpu").generate()
        assert int(stats.plies) == 6 * 8
        assert batch.policy.shape == (6 * 8, 7)
        return
    if item in ("Chess engine", "Gumbel search"):
        learner = Learner(cfg, device="cpu")
        assert learner.env.num_actions == (1968 if item == "Chess engine"
                                           else 7)
        assert learner.cfg.mcts.use_gumbel == (item == "Gumbel search")
        return
    from custom_alphazero_tpu.parallel.mesh import make_mesh

    # The mesh JAX's Learner asks for at one device: the data axis set, or
    # the automatic one (1 when the model axis takes more than there is).
    with pytest.raises(ValueError) as jax_raised:
        make_mesh(jax_config.MeshConfig(
            data_parallelism=cfg.mesh.data_parallelism or 1,
            model_parallelism=cfg.mesh.model_parallelism),
            jax.devices()[:1])
    assert "devices, have 1" in str(jax_raised.value)
    with pytest.raises(ValueError) as raised:
        Learner(cfg, device="cpu")
    assert str(raised.value) == str(jax_raised.value)
    with pytest.raises(ValueError, match="devices, have 1"):
        run(cfg, device="cpu")
    assert not os.path.exists(tmp_path / cfg.game)  # nothing was started


def test_entry_point_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(_tiny_cfg(tmp_path, "nocuda", 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([f"--run.results_dir={tmp_path}", "--loop.generations=1"])
    # main() parses the JAX loop's overrides and hands run() the config.
    seen = {}
    monkeypatch.setattr(loop_module, "run",
                        lambda cfg: seen.update(cfg=cfg) or {})
    main(["--mcts.simulations=64", "--model.lr_values=(0.1,0.01)",
          "--model.lr_boundaries=(5,)", "--arena.deterministic=true"])
    assert seen["cfg"].mcts.simulations == 64
    assert seen["cfg"].model.lr_values == (0.1, 0.01)
    assert seen["cfg"].arena.deterministic is True
    with pytest.raises(ValueError, match="Expected --dotted.key=value"):
        main(["mcts.simulations=64"])


def test_max_game_plies():
    assert max_game_plies(Config()) == 42
    assert max_game_plies(apply_overrides(
        Config(), {"self_play.max_plies": "9"})) == 9
    assert max_game_plies(apply_overrides(
        Config(), {"connect_n.width": "5", "connect_n.height": "4",
                   "connect_n.n": "3"})) == 20


# ---------------------------------------------------------------------------
# The own copies: config, paths, metrics, watchdog
# ---------------------------------------------------------------------------

def _without_port_keys(tree: dict) -> dict:
    """A config tree without the port's own ``model.residual_projection``
    (default True, the JAX net's block), ``model.se_ratio`` (default 0,
    no squeeze-excitation gate) and the nested bottleneck tower's
    ``model.mid_filters``, ``gpool_filters`` and ``gpool_blocks`` (default
    0, 0 and none: the classic blocks)."""
    assert tree["model"].pop("residual_projection") is True
    assert tree["model"].pop("se_ratio") == 0
    assert tree["model"].pop("mid_filters") == 0
    assert tree["model"].pop("gpool_filters") == 0
    assert list(tree["model"].pop("gpool_blocks")) == []
    return tree


def test_config_tree_matches_jax():
    import dataclasses

    assert Config().model.residual_projection is True
    assert _without_port_keys(dataclasses.asdict(Config())) == \
        dataclasses.asdict(jax_config.Config())
    assert _without_port_keys(json.loads(port_config.to_json(Config()))) == \
        json.loads(jax_config.to_json(jax_config.Config()))
    with open(C4R5_CONFIG) as fp:
        text = fp.read()
    cfg = port_config.from_json(text)
    assert _without_port_keys(json.loads(port_config.to_json(cfg))) == \
        json.loads(jax_config.to_json(jax_config.from_json(text)))
    assert port_config.from_json(port_config.to_json(cfg)) == cfg
    assert cfg.model.lr_boundaries == (10000, 13000)
    assert cfg.replay.capacity == 400_000 and cfg.arena.games == 256
    overrides = {"mcts.simulations": "64", "model.lr_values": "(0.1,0.01)",
                 "model.lr_boundaries": "(5,)", "arena.deterministic": "yes",
                 "run.run_id": "x", "loop.max_sample_reuse": "1.5"}
    assert _without_port_keys(dataclasses.asdict(
        apply_overrides(Config(), overrides))) == dataclasses.asdict(
            jax_config.apply_overrides(jax_config.Config(), overrides))
    assert apply_overrides(Config(), {
        "model.residual_projection": "false"}).model.residual_projection \
        is False
    assert port_config.parse_cli_overrides(["--a.b=1", "--c=x=y"]) == \
        jax_config.parse_cli_overrides(["--a.b=1", "--c=x=y"])


@pytest.mark.parametrize("overrides, match", [
    ({"model.lr_values": "(0.1,)"}, "lr_values"),
    ({"model.lr_boundaries": "(5,5)", "model.lr_values": "(1.,1.,1.)"},
     "strictly increasing"),
    ({"arena.solver_score_veto": "true"}, "solver_score_veto"),
    ({"mcts.max_nodes": "4"}, "max_nodes"),
    ({"mcts.topk_actions": "-2"}, "topk_actions"),
    ({"mcts.simulations": "0"}, "simulations"),
])
def test_validate_rejects_what_jax_rejects(overrides, match):
    with pytest.raises(ValueError, match=match):
        apply_overrides(Config(), overrides)
    with pytest.raises(ValueError, match=match):
        jax_config.apply_overrides(jax_config.Config(), overrides)


def test_paths_match_jax(tmp_path):
    args = (str(tmp_path), "connect_n", "r1")
    for name in ("run_path", "self_play_path", "training_path",
                 "evaluation_path", "tensorboard_path", "updated_mcts_path"):
        assert getattr(paths, name)(*args) == getattr(jax_paths, name)(*args)
    for name in ("self_play_iteration_path", "samples_path",
                 "evaluation_iteration_path"):
        assert getattr(paths, name)(*args, 7) == getattr(jax_paths, name)(
            *args, 7)
    assert (paths.CONFIG_FILE, paths.SAMPLES_FILE) == (
        jax_paths.CONFIG_FILE, jax_paths.SAMPLES_FILE)
    paths.create_all_directories(*args)
    assert sorted(os.listdir(paths.run_path(*args))) == [
        "evaluation", "self_play", "tensorboard", "training"]
    assert len(paths.new_run_id()) == len("2024-01-01_00-00-00")


def test_metrics_writer(tmp_path):
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283  # RFC 3720
    logdir = str(tmp_path / "tb")
    with MetricsWriter(logdir) as w:
        w.scalar("train/loss", 1.25, step=1)
        w.scalar("train/loss", 0.75, step=2)
        w.scalars({"a": 1.0, "b": 2.0}, step=3)
    with open(os.path.join(logdir, "metrics.jsonl")) as fp:
        lines = [json.loads(line) for line in fp]
    assert [(m["tag"], m["value"], m["step"]) for m in lines] == [
        ("train/loss", 1.25, 1), ("train/loss", 0.75, 2), ("a", 1.0, 3),
        ("b", 2.0, 3)]
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir)
    acc.Reload()
    assert [(s.step, s.value) for s in acc.Scalars("train/loss")] == [
        (1, 1.25), (2, 0.75)]
    assert acc.Scalars("b")[0].value == 2.0


def test_watchdog_pieces(tmp_path, monkeypatch):
    now = [0.0]
    beat = watchdog.Heartbeat(10.0, clock=lambda: now[0])
    assert not beat.stalled()
    now[0] = 11.0
    assert beat.stalled() and beat.age() == 11.0
    beat.beat()
    assert not beat.stalled()
    # The watchdog fires its action once the heartbeat is stale.
    now[0] = 30.0
    fired = threading.Event()
    dog = watchdog.start_watchdog(beat, poll_s=0.01, on_stall=fired.set)
    assert fired.wait(5.0)
    dog.thread.join(5.0)
    # Disarmed in time, it never fires.
    beat.beat()
    quiet = threading.Event()
    dog = watchdog.start_watchdog(beat, poll_s=0.01, on_stall=quiet.set)
    dog.disarm()
    dog.thread.join(5.0)
    assert not quiet.is_set()
    # The liveness file is touched only when the supervisor names one.
    heartbeat_file = tmp_path / "alive"
    heartbeat_file.write_text("")
    os.utime(heartbeat_file, (0, 0))
    watchdog.touch_liveness_file()
    assert os.path.getmtime(heartbeat_file) == 0
    monkeypatch.setenv(watchdog.HEARTBEAT_ENV, str(heartbeat_file))
    watchdog.touch_liveness_file()
    assert os.path.getmtime(heartbeat_file) > 0
    # The grace toucher touches until stopped or out of budget.
    touches = []
    toucher = watchdog.CompileGraceToucher(
        60.0, interval_s=0.01, touch=lambda: touches.append(1))
    deadline = time.time() + 5
    while not touches and time.time() < deadline:
        time.sleep(0.01)
    toucher.stop()
    toucher.thread.join(5.0)
    assert touches and not toucher.thread.is_alive()
    assert watchdog.STALL_EXIT_CODE == 42
