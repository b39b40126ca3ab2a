"""AlphaZero's identity-skip residual block (``residual_projection=False``)
on the CPU at small sizes: the port's net against the benchmark's plain
reference (azbench/reference/net_identity.py) in float32 (forward, loss,
gradients, one SGD step), its round trip through the Flax layout and a
checkpoint, projection checkpoints loading as before, and the benchmark's
seeded-weights self-play driver end to end on a tiny identity
configuration."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from azbench import harness
from azbench.reference import connect4
from azbench.reference import net_identity as ref_net
from azbench.tests import fixture
from custom_alphazero_tpu_torch.config import ModelConfig
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
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)

REPO = fixture.REPO
# (board (H, W), n in a row): Connect-4 and a 5x4 Connect-3.
BOARDS = {"7x6": ((6, 7), 4), "5x4": ((4, 5), 3)}
SMALL = dict(depth=3, filters=16, value_hidden=32, compute_dtype="float32",
             residual_projection=False)


def _state(board: str, seed: int = 0):
    """A port TrainState of an identity-skip net whose every bias,
    BatchNorm scale, offset and running statistic and momentum leaf is
    drawn, so each term matters."""
    (h, w), _ = BOARDS[board]
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(w, ModelConfig(**SMALL), gen, (h, w, 4),
                             device="cpu")
    with torch.no_grad():
        for name, t in state.net.named_parameters():
            if t.dim() == 1:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1
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
def test_identity_net_forward_matches_the_reference(board):
    state = _state(board)
    params, stats, _ = _reference(state)
    x = _obs(board, 32, 1)
    net = state.net
    assert all(block.proj is None for block in net.blocks)
    with torch.no_grad():
        logits, value = net.eval()(x)
        ref_logits, ref_value, _ = ref_net.forward(params, stats, x,
                                                   SMALL["depth"])
    assert torch.allclose(logits, ref_logits, atol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5)
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
def test_identity_net_sgd_step_matches_the_reference(board):
    """Loss, gradients (the new momentum less the old one's decay) and the
    parameters after one step of the port's train step, with its auxiliary
    value term, against the reference's."""
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
    for k in new_params:
        got_grad = got_trace[k] - m.momentum * trace[k].numpy()
        assert np.allclose(got_grad, grads[k].numpy(), atol=1e-5), k
        assert np.allclose(got_trace[k], new_trace[k].numpy(), atol=1e-5), k
        assert np.allclose(got[k], new_params[k].numpy(), atol=1e-6), k


def test_identity_net_round_trips_through_a_checkpoint(tmp_path):
    state = _state("7x6", seed=5)
    m = ModelConfig(**SMALL)
    tree = train_state_to_jax(state, m)
    for part in ("params", "batch_stats"):
        for i in range(SMALL["depth"]):
            assert set(tree[part][f"ResidualBlock_{i}"]) == {
                "ConvBlock_0", "ConvBlock_1"}
    assert "ConvBlock_2" not in tree["opt_state"]["0"]["trace"][
        "ResidualBlock_0"]
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
    # A projection net refuses the identity variables, and the reverse.
    params, stats = to_jax_variables(back.net)
    with pytest.raises(ValueError, match="projection"):
        from_jax_variables(params, stats, 7, dataclasses.replace(
            m, residual_projection=True), device="cpu")


def test_projection_checkpoints_load_as_before():
    """The committed c4-r5 net (projection blocks) loads under the default
    ``residual_projection=True`` and not into an identity net."""
    tree, _ = load_checkpoint(os.path.join(REPO, "artifacts", "c4-r5",
                                           "iteration_11600"))
    m = ModelConfig(depth=4, filters=128)
    assert m.residual_projection
    state = train_state_from_jax(tree, 7, m, device="cpu")
    assert all(block.proj is not None for block in state.net.blocks)
    again = train_state_to_jax(state, m)
    for key in ("params", "batch_stats"):
        flat, want = (ref_net.flatten(t[key]) for t in (again, tree))
        assert set(flat) == set(want)
        assert all(np.array_equal(flat[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="projection"):
        train_state_from_jax(tree, 7, dataclasses.replace(
            m, residual_projection=False), device="cpu")


def test_identity_module_has_no_projection_parameters():
    net = PolicyValueNet(7, ModelConfig(**SMALL))
    assert not any(".proj." in name for name, _ in net.named_parameters())
    with_proj = PolicyValueNet(7, dataclasses.replace(
        ModelConfig(**SMALL), residual_projection=True))
    extra = sum(p.numel() for p in with_proj.parameters()) - sum(
        p.numel() for p in net.parameters())
    filters = SMALL["filters"]
    assert extra == SMALL["depth"] * (filters * filters + 3 * filters)


def _identity_root(tmp_path) -> str:
    """A tiny benchmark root with a seeded identity configuration (depth 2,
    16 filters, float32, 8 games, 8 simulations) and its cell, added as new
    files and entries."""
    root = fixture.tiny_root(str(tmp_path))
    bench_dir = os.path.join(root, "azbench")
    cfg = fixture.tiny_config()
    cfg["model"].update(depth=2, filters=16, residual_projection=False)
    os.makedirs(os.path.join(root, "weights-az"))
    shutil.copy(os.path.join(REPO, "azbench", "weights", "c4-az19x256",
                             "seeded.json"),
                os.path.join(root, "weights-az", "seeded.json"))
    with open(os.path.join(bench_dir, "configs", "tiny-az.json"), "w") as fp:
        json.dump({"name": "tiny-az", "weights": "weights-az",
                   "config": cfg}, fp)
    shutil.copy(os.path.join(REPO, "azbench", "limits", "c4az-selfplay.json"),
                os.path.join(bench_dir, "limits", "tiny-az-selfplay.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        b = json.load(fp)
    b["configs"].append({"name": "tiny-az", "source": "test",
                         "file": "azbench/configs/tiny-az.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-az-selfplay", "config": "tiny-az",
                           "traffic": "selfplay_seeded", "chips": 1,
                           "why": "test"})
    for metric in b["end_to_end"] + b["per_layer"]:
        if "c4az-selfplay" in metric.get("workloads", ()):
            metric["workloads"].append("tiny-az-selfplay")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(b, fp)
    return root


def test_seeded_selfplay_driver_end_to_end(tmp_path):
    """The c4az-selfplay cell's driver on a tiny identity configuration:
    correct, every compared number within its limit, the weights the
    recipe's (set-up twice from one seed gives the same tree), and a
    configuration whose blocks the program does not build refused at
    set-up."""
    from azbench.drivers import selfplay_seeded

    torch.set_num_threads(1)
    root = _identity_root(tmp_path)
    seed = 2**31 + 11
    out = harness.run_cell(root, "tiny-az-selfplay", seed=seed, seconds=0.5,
                           trace=False, device="cpu")
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"selfplay_faults", "ring_faults",
                                    "noise_mean_z", "search_faults",
                                    "logit_gap", "value_gap"}
    assert out["compared"]["logit_gap"]["value"] < 1e-4
    assert out["metrics"]["selfplay_positions_per_s"]["value"] > 0

    bench = harness._load_json(os.path.join(root, "BENCHMARK.json"))
    run = harness.Run(root, bench, "tiny-az-selfplay", seed, 0.0, False,
                      "cpu", 0.0)
    lrn, (params, _) = selfplay_seeded.learner(run)
    again = selfplay_seeded.seeded_tree(run, seed)
    flat = ref_net.flatten(again["params"])
    assert all(np.array_equal(flat[k], params[k].numpy()) for k in flat)
    scale = flat["ResidualBlock_0/ConvBlock_0/BatchNorm_0/scale"]
    assert 0.5 <= scale.min() and scale.max() <= 1.5 and scale.std() > 0.1
    assert not np.array_equal(flat["ConvBlock_0/Conv_0/bias"], 0)
    lrn.best.blocks[0].proj = lrn.best.blocks[0].conv1
    with pytest.raises(RuntimeError, match="projection"):
        selfplay_seeded.refuse_other_net(run, lrn)


def test_seeded_cell_float8_control_fails_its_limits(monkeypatch):
    """The c4az-selfplay cell's precision control at the configuration's
    own shapes (19 blocks of 256 filters): the recipe's weights for one
    seed (calibrated on 64 positions, where the cell takes 1,024), 32
    positions, the port's bf16 forward (its plain version, loaded through
    the converter) within the cell's limits, and the reference one
    precision below bf16 (float8) in the program's place outside them."""
    from azbench.drivers import selfplay_seeded as driver
    from custom_alphazero_tpu_torch.ops import fused_net

    torch.set_num_threads(2)
    bench = harness._load_json(os.path.join(REPO, "BENCHMARK.json"))

    def new_run():
        return harness.Run(REPO, bench, "c4az-selfplay", 2**31 + 7, 0.0,
                           False, "cpu", 0.0)

    def judged(priors, values):
        run = new_run()
        for name, value in zip(("logit_gap", "value_gap"),
                               driver.forward_gaps(priors, values, *ref)):
            run.compare(name, value)
        return run

    run = new_run()
    recipe = driver._recipe(run)
    recipe["calibration"]["positions"] = 64
    monkeypatch.setattr(driver, "_recipe", lambda _: recipe)
    tree = driver.seeded_tree(run, run.seed)
    params = ref_net.to_device(ref_net.flatten(tree["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), "cpu")
    obs = _obs("7x6", 32, 8)
    depth = run.config["config"]["model"]["depth"]
    ref = driver.reference_forward(params, stats, depth, obs)
    low_logits, low_values = driver.reference_forward(
        params, stats, depth, obs, ref_net.float8_rounding)
    control = judged(torch.softmax(low_logits, -1), low_values)
    assert not control.correct, control.compared

    cfg = ModelConfig(**{k: v for k, v in run.config["config"]["model"].items()
                         if k not in ("lr_boundaries", "lr_values")})
    net = from_jax_variables(tree["params"], tree["batch_stats"], 7, cfg,
                             device="cpu")
    with torch.inference_mode():
        logits, values = fused_net.forward_plain(net, obs)
    sound = judged(torch.softmax(logits.float(), -1), values.float())
    assert sound.correct, sound.compared


def test_seeded_driver_finds_a_search_that_misreads_the_net(tmp_path,
                                                             monkeypatch):
    """The c4az-selfplay cell's check on a planted fault: a search step that
    backs up the net's values with the wrong sign (the buffers hold the
    net's own output) is not correct, by ``search_faults`` alone."""
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2

    torch.set_num_threads(1)
    root = _identity_root(tmp_path)
    real = fused_mcts_v2.wave_step

    def misread(buffers, carry, geom, record=False):
        buffers.value.neg_()
        try:
            return real(buffers, carry, geom, record)
        finally:
            buffers.value.neg_()

    misread.launches = 0
    monkeypatch.setattr(fused_mcts_v2.FusedConnectNSearchV2, "_wave_step",
                        staticmethod(misread))
    out = harness.run_cell(root, "tiny-az-selfplay", seed=2**31 + 12,
                           seconds=0.5, trace=False, device="cpu")
    compared = out["compared"]
    assert not out["correct"], compared
    assert compared["search_faults"]["value"] > 0, compared
    assert all(item["value"] <= item["limit"] for name, item in
               compared.items() if name != "search_faults"), compared
