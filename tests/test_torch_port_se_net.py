"""Leela Chess Zero's squeeze-excitation residual block (``se_ratio`` > 0,
identity skips) on the CPU at small sizes: the port's net against the
benchmark's plain reference (azbench/reference/net_se.py) in float32
(forward, loss, gradients, one SGD step), the gate's leaves through the
Flax layout and a checkpoint, the loop training and resuming such a net
from its command-line flags, the configuration's checks, and the
benchmark's squeeze-excitation self-play driver on a tiny configuration."""

import ast
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from azbench import harness
from azbench.reference import connect4
from azbench.reference import net_se as ref_net
from azbench.tests import fixture
from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import (
    Config,
    ModelConfig,
    apply_overrides,
    from_json,
    parse_cli_overrides,
    to_json,
    validate,
)
from custom_alphazero_tpu_torch.io.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from custom_alphazero_tpu_torch.models.convert import (
    from_jax_variables,
    to_jax_variables,
    train_state_from_jax,
    train_state_to_jax,
)
from custom_alphazero_tpu_torch.models.policy_value import PolicyValueNet
from custom_alphazero_tpu_torch.runtime.loop import run
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)

REPO = fixture.REPO
# (board (H, W), n in a row): Connect-4 and a 5x4 Connect-3.
BOARDS = {"7x6": ((6, 7), 4), "5x4": ((4, 5), 3)}
SMALL = dict(depth=2, filters=16, value_hidden=32, compute_dtype="float32",
             residual_projection=False, se_ratio=4)
GATE = "SqueezeExcite_0"


def _state(board: str, seed: int = 0):
    """A port TrainState of a gated net whose every bias, BatchNorm scale,
    offset and running statistic and momentum leaf is drawn, the gates'
    biases wide, so each term matters."""
    (h, w), _ = BOARDS[board]
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(w, ModelConfig(**SMALL), gen, (h, w, 4),
                             device="cpu")
    with torch.no_grad():
        for name, t in state.net.named_parameters():
            if t.dim() == 1:
                spread = 0.5 if ".se." in name else 0.1
                t.copy_(torch.randn(t.shape, generator=gen) * spread
                        + (1.0 if name.endswith("bn.weight") else 0.0))
        for name, t in state.net.named_buffers():
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5
                    if name.endswith("running_var")
                    else torch.randn(t.shape, generator=gen) * 0.1)
        for t in state.trace:
            t.copy_(torch.randn(t.shape, generator=gen) * 1e-3)
    return state


def _reference(state):
    tree = train_state_to_jax(state, ModelConfig(**SMALL))
    params = ref_net.to_device(ref_net.flatten(tree["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), "cpu")
    trace = ref_net.to_device(ref_net.flatten(
        tree["opt_state"]["0"]["trace"]), "cpu")
    return params, stats, trace


def _obs(board: str, count: int, seed: int) -> torch.Tensor:
    (h, w), n = BOARDS[board]
    rng = np.random.default_rng(seed)
    boards = connect4.random_positions(rng, count, h, w, n, h * w - 2)
    return torch.from_numpy(connect4.observe(boards))


@pytest.mark.parametrize("board", list(BOARDS))
def test_se_net_forward_matches_the_reference(board):
    """Eval and train mode against the reference, and the no-gate control
    (the same weights without the gates) far from both."""
    state = _state(board)
    params, stats, _ = _reference(state)
    x = _obs(board, 32, 1)
    net = state.net
    assert all(block.se is not None and block.proj is None
               for block in net.blocks)
    with torch.no_grad():
        logits, value = net.eval()(x)
        ref_logits, ref_value, _ = ref_net.forward(params, stats, x,
                                                   SMALL["depth"])
        bare_logits, _, _ = ref_net.forward(params, stats, x, SMALL["depth"],
                                            gate=False)
    assert torch.allclose(logits, ref_logits, atol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5)
    assert (bare_logits - ref_logits).abs().max() > 0.05
    with torch.no_grad():
        logits, value = net.train()(x)
        net.eval()
        ref_logits, ref_value, moved = ref_net.forward(
            params, stats, x, SMALL["depth"], train=True)
    assert torch.allclose(logits, ref_logits, atol=1e-4)
    assert torch.allclose(value, ref_value, atol=1e-5)
    last = net.blocks[-1].conv2.bn
    path = f"ResidualBlock_{SMALL['depth'] - 1}/ConvBlock_1/BatchNorm_0"
    assert torch.allclose(last.running_mean, moved[f"{path}/mean"],
                          atol=1e-6)
    assert torch.allclose(last.running_var, moved[f"{path}/var"], atol=1e-6)


@pytest.mark.parametrize("board", list(BOARDS))
def test_se_net_sgd_step_matches_the_reference(board):
    """Loss, gradients (the new momentum less the old one's decay) and the
    parameters after one step of the port's train step, with its auxiliary
    value term, against the reference's, the gates' leaves among them."""
    (h, w), _ = BOARDS[board]
    state = _state(board, seed=2)
    params, stats, trace = _reference(state)
    x = _obs(board, 64, 2)
    rng = np.random.default_rng(3)
    pi = torch.from_numpy(rng.dirichlet(np.ones(w), 64).astype(np.float32))
    z = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], 64).astype(np.float32))
    aux = _obs(board, 16, 4)
    aux_z = torch.from_numpy(rng.choice([-1.0, 1.0], 16).astype(np.float32))
    m = ModelConfig(**SMALL)
    step = make_train_step(m, aux_value_weight=0.25, aux_value_batch=16)
    _, metrics = step(state, x, pi, z, None, aux, aux_z, None,
                      torch.arange(16))
    lr = ref_net.learning_rate(m.lr_values, m.lr_boundaries, 0)
    new_params, _, new_trace, losses, grads = ref_net.sgd_step(
        params, stats, trace, x, pi, z, aux, aux_z, SMALL["depth"], m.l2,
        0.25, lr, m.momentum)
    assert abs(float(metrics.loss) - losses["loss"]) < 1e-5
    tree = train_state_to_jax(state, m)
    got = ref_net.flatten(tree["params"])
    got_trace = ref_net.flatten(tree["opt_state"]["0"]["trace"])
    assert set(got) == set(new_params)
    gate_leaves = [k for k in new_params if f"/{GATE}/" in k]
    assert len(gate_leaves) == 4 * SMALL["depth"]
    assert all(np.abs(grads[k].numpy()).max() > 0 for k in gate_leaves)
    for k in new_params:
        got_grad = got_trace[k] - m.momentum * trace[k].numpy()
        assert np.allclose(got_grad, grads[k].numpy(), atol=1e-5), k
        assert np.allclose(got_trace[k], new_trace[k].numpy(), atol=1e-5), k
        assert np.allclose(got[k], new_params[k].numpy(), atol=1e-6), k


def test_se_net_round_trips_through_a_checkpoint(tmp_path):
    """The gate's leaves in the Flax layout (params and momentum, no
    statistics), a save and load bit for bit, and a ValueError for a gate
    mismatch both ways."""
    state = _state("7x6", seed=5)
    m = ModelConfig(**SMALL)
    tree = train_state_to_jax(state, m)
    filters, hidden = SMALL["filters"], SMALL["filters"] // SMALL["se_ratio"]
    for i in range(SMALL["depth"]):
        block = tree["params"][f"ResidualBlock_{i}"]
        assert set(block) == {"ConvBlock_0", "ConvBlock_1", GATE}
        assert {k: {leaf: a.shape for leaf, a in v.items()}
                for k, v in block[GATE].items()} == {
            "Dense_0": {"kernel": (filters, hidden), "bias": (hidden,)},
            "Dense_1": {"kernel": (hidden, 2 * filters),
                        "bias": (2 * filters,)}}
        assert set(tree["opt_state"]["0"]["trace"][f"ResidualBlock_{i}"][
            GATE]) == {"Dense_0", "Dense_1"}
        assert GATE not in tree["batch_stats"][f"ResidualBlock_{i}"]
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree, 1e-3)
    loaded, _ = load_checkpoint(path)
    back = train_state_from_jax(loaded, 7, m, 4, (6, 7), device="cpu")
    for (name, a), b in zip(state.net.state_dict().items(),
                            back.net.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.trace, back.trace):
        assert torch.equal(a, b)
    x = _obs("7x6", 8, 6)
    with torch.no_grad():
        assert torch.equal(state.net.eval()(x)[0], back.net(x)[0])
    # A net without gates refuses the gated variables, and the reverse.
    params, stats = to_jax_variables(back.net)
    with pytest.raises(ValueError, match="squeeze-excitation"):
        from_jax_variables(params, stats, 7, dataclasses.replace(
            m, se_ratio=0), device="cpu")
    bare = PolicyValueNet(7, dataclasses.replace(m, se_ratio=0))
    bare_params, bare_stats = to_jax_variables(bare)
    with pytest.raises(ValueError, match="squeeze-excitation"):
        from_jax_variables(bare_params, bare_stats, 7, m, device="cpu")


def test_se_module_parameters():
    """A gate of ratio r adds C x C / r + C / r + C / r x 2C + 2C
    parameters a block, as Lc0's two dense layers with biases."""
    net = PolicyValueNet(7, ModelConfig(**SMALL))
    bare = PolicyValueNet(7, dataclasses.replace(ModelConfig(**SMALL),
                                                 se_ratio=0))
    extra = sum(p.numel() for p in net.parameters()) - sum(
        p.numel() for p in bare.parameters())
    c, hidden = SMALL["filters"], SMALL["filters"] // SMALL["se_ratio"]
    assert extra == SMALL["depth"] * (c * hidden + hidden + hidden * 2 * c
                                      + 2 * c)
    assert {n.split(".", 2)[2] for n, _ in net.named_parameters()
            if ".se." in n} == {"se.dense1.weight", "se.dense1.bias",
                                "se.dense2.weight", "se.dense2.bias"}


@pytest.mark.parametrize("model, match", [
    (dict(se_ratio=4), "residual_projection"),
    (dict(se_ratio=3, residual_projection=False), "does not divide"),
    (dict(se_ratio=-1, residual_projection=False), ">= 0"),
])
def test_validate_rejects_gates_it_cannot_build(model, match):
    """A gate needs identity blocks, a ratio that divides the filters, and a
    ratio of at least 0."""
    cfg = dataclasses.replace(Config(), model=dataclasses.replace(
        ModelConfig(filters=16), **model))
    with pytest.raises(ValueError, match=match):
        validate(cfg)


def test_config_tree_without_se_ratio_loads_with_none():
    """A configuration tree written before the option (or by the JAX
    package) loads with se_ratio 0; the port's snapshot carries it, and the
    command line sets it."""
    tree = json.loads(to_json(Config()))
    assert tree["model"].pop("se_ratio") == 0
    assert from_json(json.dumps(tree)).model.se_ratio == 0
    cfg = apply_overrides(Config(), parse_cli_overrides(
        ["--model.residual_projection=false", "--model.se_ratio=8",
         "--model.filters=256"]))
    assert cfg.model.se_ratio == 8
    assert from_json(to_json(cfg)) == cfg


def test_net_se_imports_neither_the_program_nor_jax():
    with open(ref_net.__file__) as fp:
        tree = ast.parse(fp.read())
    names = [alias.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    tops = {name.split(".")[0] for name in names}
    assert not tops & {"jax", "jaxlib", "flax", "optax",
                       "custom_alphazero_tpu", "custom_alphazero_tpu_torch"}
    assert tops <= {"__future__", "typing", "torch", "azbench"}


# Games cut at 12 plies (kept as draws), a tiny gated net.
LOOP_FLAGS = [
    "--mcts.simulations=8", "--self_play.games_per_generation=8",
    "--self_play.max_plies=12", "--self_play.exclude_draws=false",
    "--model.depth=2", "--model.filters=8", "--model.value_hidden=16",
    "--model.batch_size=16", "--model.residual_projection=false",
    "--model.se_ratio=4", "--replay.capacity=2000", "--replay.min_size=32",
    "--loop.train_iterations_per_generation=2",
    "--loop.samples_checkpoint_frequency=2", "--arena.games=8",
    "--arena.evaluation_frequency=4", "--arena.checkpoint_frequency=4",
    "--run.run_id=se"]


def test_loop_trains_and_resumes_an_se_net(tmp_path, capsys):
    """``runtime.loop`` from the command-line flags of a gated net:
    generate, replay, train, arena, checkpoint with the gates' leaves and
    momentum; the resume continues from the checkpoint, and the saved net
    is the reference's on its own tree."""
    torch.set_num_threads(1)

    def cfg(generations):
        return apply_overrides(Config(), parse_cli_overrides(
            LOOP_FLAGS + [f"--run.results_dir={tmp_path}",
                          f"--loop.generations={generations}"]))

    summary = run(cfg(2), device="cpu")
    assert summary["iterations"] == 4
    training = paths.training_path(str(tmp_path), "connect_n", "se")
    tree, meta = load_checkpoint(training)
    assert meta["steps"] == 4
    for part in (tree["params"], tree["opt_state"]["0"]["trace"]):
        assert set(part["ResidualBlock_1"][GATE]) == {"Dense_0", "Dense_1"}
    summary = run(cfg(1), device="cpu")
    assert summary["iterations"] == 6
    assert "Resumed training state at step 4" in capsys.readouterr().out
    tree, meta = load_checkpoint(training)
    assert meta["steps"] == 6
    m = cfg(1).model
    net = train_state_from_jax(tree, 7, m, device="cpu").net
    assert all(block.se is not None for block in net.blocks)
    params = ref_net.to_device(ref_net.flatten(tree["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), "cpu")
    x = _obs("7x6", 16, 9)
    float_net = train_state_from_jax(tree, 7, dataclasses.replace(
        m, compute_dtype="float32"), device="cpu").net
    with torch.no_grad():
        logits, value = float_net(x)
        ref_logits, ref_value, _ = ref_net.forward(params, stats, x, m.depth)
    assert torch.allclose(logits, ref_logits, atol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5)


# ---------------------------------------------------------------------------
# The benchmark's squeeze-excitation self-play driver
# ---------------------------------------------------------------------------


def _se_root(tmp_path) -> str:
    """A tiny benchmark root with a seeded gated configuration (depth 2, 16
    filters, ratio 4, float32, 8 games, 8 simulations) and its cell, added
    as new files and entries."""
    root = fixture.tiny_root(str(tmp_path))
    bench_dir = os.path.join(root, "azbench")
    cfg = fixture.tiny_config()
    cfg["model"].update(depth=2, filters=16, residual_projection=False,
                        se_ratio=4)
    os.makedirs(os.path.join(root, "weights-se"))
    shutil.copy(os.path.join(REPO, "azbench", "weights", "c4-se20x256",
                             "seeded.json"),
                os.path.join(root, "weights-se", "seeded.json"))
    with open(os.path.join(bench_dir, "configs", "tiny-se.json"), "w") as fp:
        json.dump({"name": "tiny-se", "weights": "weights-se",
                   "config": cfg}, fp)
    shutil.copy(os.path.join(REPO, "azbench", "limits", "c4se-selfplay.json"),
                os.path.join(bench_dir, "limits", "tiny-se-selfplay.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        b = json.load(fp)
    b["configs"].append({"name": "tiny-se", "source": "test",
                         "file": "azbench/configs/tiny-se.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-se-selfplay", "config": "tiny-se",
                           "traffic": "selfplay_seeded_se", "chips": 1,
                           "why": "test"})
    for metric in b["end_to_end"] + b["per_layer"]:
        if "c4se-selfplay" in metric.get("workloads", ()):
            metric["workloads"].append("tiny-se-selfplay")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(b, fp)
    return root


def test_se_selfplay_driver_end_to_end(tmp_path):
    """The c4se-selfplay cell's driver on a tiny gated configuration:
    correct, every compared number within its limit, the weights the
    recipe's (the gates' leaves drawn by their own kinds, set-up twice from
    one seed gives the same tree)."""
    from azbench.drivers import selfplay_se

    torch.set_num_threads(1)
    root = _se_root(tmp_path)
    seed = 2**31 + 13
    out = harness.run_cell(root, "tiny-se-selfplay", seed=seed, seconds=0.5,
                           trace=False, device="cpu")
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"selfplay_faults", "ring_faults",
                                    "noise_mean_z", "search_faults",
                                    "logit_gap", "value_gap"}
    assert out["compared"]["logit_gap"]["value"] < 1e-4
    assert out["metrics"]["selfplay_positions_per_s"]["value"] > 0

    bench = harness._load_json(os.path.join(root, "BENCHMARK.json"))
    run_ = harness.Run(root, bench, "tiny-se-selfplay", seed, 0.0, False,
                       "cpu", 0.0)
    lrn, (params, _) = selfplay_se.learner(run_)
    again = selfplay_se.seeded_tree(run_, seed)
    flat = ref_net.flatten(again["params"])
    assert all(np.array_equal(flat[k], params[k].numpy()) for k in flat)
    bias = flat[f"ResidualBlock_0/{GATE}/Dense_1/bias"]
    assert bias.shape == (32,) and bias.std() > 0.2
    assert flat[f"ResidualBlock_1/{GATE}/Dense_0/kernel"].shape == (16, 4)


@pytest.mark.parametrize("case", ["no option", "no gate", "projection",
                                  "configuration"])
def test_se_selfplay_driver_refuses_what_it_cannot_compare(tmp_path,
                                                           monkeypatch, case):
    """Set-up refuses a program whose ModelConfig has no ``se_ratio`` (as
    the parent's, whose ``from_json`` drops the key) before it builds
    anything, a program whose built blocks carry no gate or a projection,
    and a configuration without gates."""
    from azbench.drivers import selfplay_se
    from custom_alphazero_tpu_torch import config as port_config

    torch.set_num_threads(1)
    root = _se_root(tmp_path)
    bench = harness._load_json(os.path.join(root, "BENCHMARK.json"))
    run_ = harness.Run(root, bench, "tiny-se-selfplay", 5, 0.0, False, "cpu",
                       0.0)
    if case == "no option":
        fields = [f for f in dataclasses.fields(port_config.ModelConfig)
                  if f.name != "se_ratio"]
        old = dataclasses.make_dataclass(
            "ModelConfig", [(f.name, f.type, f) for f in fields],
            frozen=True)
        monkeypatch.setattr(port_config, "ModelConfig", old)
        with pytest.raises(RuntimeError, match="se_ratio"):
            selfplay_se.setup(run_)
        return
    if case == "configuration":
        run_.config["config"]["model"]["se_ratio"] = 0
        with pytest.raises(ValueError, match="se_ratio"):
            selfplay_se.refuse_other_net(run_)
        return
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    lrn = Learner(run_.program_config(), device="cpu")
    selfplay_se.refuse_other_net(run_, lrn)
    if case == "no gate":
        lrn.best.blocks[1].se = None
    else:
        lrn.candidate.blocks[0].proj = lrn.candidate.blocks[0].conv1
    with pytest.raises(RuntimeError, match="gate"):
        selfplay_se.refuse_other_net(run_, lrn)


@pytest.mark.parametrize("control", ["float8", "no_gate"])
def test_se_cell_controls_fail_its_limits(monkeypatch, control):
    """The c4se-selfplay cell's controls at the configuration's own shapes
    (20 blocks of 256 filters, ratio 8): the recipe's weights for one seed
    (calibrated on 64 positions, where the cell takes 1,024), 32
    positions, the port's bf16 forward (its plain version, loaded through
    the converter) within the cell's limits, and in the program's place the
    reference one precision below bf16 (float8) or without its gates
    outside them."""
    from azbench.drivers import selfplay_seeded as seeded
    from azbench.drivers import selfplay_se as driver
    from custom_alphazero_tpu_torch.ops import fused_net

    torch.set_num_threads(2)
    bench = harness._load_json(os.path.join(REPO, "BENCHMARK.json"))

    def new_run():
        return harness.Run(REPO, bench, "c4se-selfplay", 2**31 + 7, 0.0,
                           False, "cpu", 0.0)

    def judged(priors, values):
        run_ = new_run()
        for name, value in zip(("logit_gap", "value_gap"),
                               seeded.forward_gaps(priors, values, *ref)):
            run_.compare(name, value)
        return run_

    run_ = new_run()
    recipe = seeded._recipe(run_)
    recipe["calibration"]["positions"] = 64
    monkeypatch.setattr(seeded, "_recipe", lambda _: recipe)
    tree = driver.seeded_tree(run_, run_.seed)
    params = ref_net.to_device(ref_net.flatten(tree["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), "cpu")
    obs = _obs("7x6", 32, 8)
    depth = run_.config["config"]["model"]["depth"]
    ref = driver.reference_forward(params, stats, depth, obs)
    quantize = ref_net.float8_rounding if control == "float8" else None
    low_logits, low_values = driver.reference_forward(
        params, stats, depth, obs, quantize, gate=control != "no_gate")
    judged_control = judged(torch.softmax(low_logits, -1), low_values)
    assert not judged_control.correct, judged_control.compared

    cfg = ModelConfig(**{k: v for k, v in run_.config["config"][
        "model"].items() if k not in ("lr_boundaries", "lr_values")})
    net = from_jax_variables(tree["params"], tree["batch_stats"], 7, cfg,
                             device="cpu")
    with torch.inference_mode():
        logits, values = fused_net.forward_plain(net, obs)
    sound = judged(torch.softmax(logits.float(), -1), values.float())
    assert sound.correct, sound.compared
