"""KataGo's pre-activation nested-bottleneck tower with global pooling
(``mid_filters`` > 0: b18c384nbt's blocks) on the CPU at small sizes: the
port's net against the benchmark's plain reference
(azbench/reference/net_nbt.py) in float32 (forward, the controls without
the pooled bias or the inner skips, one SGD step), N1's plain version
against the module path, the new leaves through the Flax layout and a
checkpoint, the configuration's checks, a tiny Learner generation and the
benchmark's nested-bottleneck self-play driver on a tiny configuration."""

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
from azbench.reference import net_nbt as ref_net
from azbench.tests import fixture
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
from custom_alphazero_tpu_torch.ops import fused_net
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)

REPO = fixture.REPO
# (board (H, W), n in a row): Connect-4 and a 5x4 Connect-3.
BOARDS = {"7x6": ((6, 7), 4), "5x4": ((4, 5), 3)}
# Trunk 32, mid 16, 8 of them pooled (8 regular) in the first of 2 blocks.
SMALL = dict(depth=2, filters=32, mid_filters=16, gpool_filters=8,
             gpool_blocks=(1,), value_hidden=32, compute_dtype="float32",
             residual_projection=False)
GPOOL = "GlobalPoolBias_0"


def _state(board: str, seed: int = 0, **model):
    """A port TrainState of a nested-bottleneck net whose every bias,
    BatchNorm scale, offset and running statistic and momentum leaf is
    drawn, so each term matters."""
    (h, w), _ = BOARDS[board]
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(w, ModelConfig(**dict(SMALL, **model)), gen,
                             (h, w, 4), device="cpu")
    with torch.no_grad():
        for name, t in state.net.named_parameters():
            if t.dim() == 1:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1
                        + (1.0 if name.endswith("bn.weight")
                           or name.endswith("norm.weight") else 0.0))
        for name, t in state.net.named_buffers():
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5
                    if name.endswith("running_var")
                    else torch.randn(t.shape, generator=gen) * 0.1)
        for t in state.trace:
            t.copy_(torch.randn(t.shape, generator=gen) * 1e-3)
    return state


def _reference(state):
    tree = train_state_to_jax(state, state.net.cfg)
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
def test_nbt_net_forward_matches_the_reference(board):
    """Eval and train mode against the reference; the controls without the
    pooled bias (no_gpool) and without the inner skips (no_inner_skip) far
    from both."""
    state = _state(board)
    params, stats, _ = _reference(state)
    x = _obs(board, 32, 1)
    net = state.net
    assert [block.inner[0].gpool is not None for block in net.blocks] == [
        True, False]
    with torch.no_grad():
        logits, value = net.eval()(x)
        ref_logits, ref_value, _ = ref_net.forward(params, stats, x,
                                                   SMALL["depth"])
        bare = [ref_net.forward(params, stats, x, SMALL["depth"],
                                **{control: False})[0]
                for control in ("gpool", "inner_skip")]
    assert torch.allclose(logits, ref_logits, atol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5)
    for control in bare:
        assert (control - ref_logits).abs().max() > 0.05
    with torch.no_grad():
        logits, value = net.train()(x)
        net.eval()
        ref_logits, ref_value, moved = ref_net.forward(
            params, stats, x, SMALL["depth"], train=True)
    assert torch.allclose(logits, ref_logits, atol=1e-4)
    assert torch.allclose(value, ref_value, atol=1e-5)
    for bn, path in (
            (net.trunk_norm, "BatchNorm_0"),
            (net.blocks[0].inner[0].gpool.bn,
             f"NestedBottleneckBlock_0/InnerBlock_0/{GPOOL}/BatchNorm_0"),
            (net.blocks[1].post.bn,
             "NestedBottleneckBlock_1/NormConv_1/BatchNorm_0")):
        assert torch.allclose(bn.running_mean, moved[f"{path}/mean"],
                              atol=1e-6)
        assert torch.allclose(bn.running_var, moved[f"{path}/var"],
                              atol=1e-6)


def test_reference_rounding_reaches_the_stored_skip_stream():
    """The reference's ``quantize`` (the precision controls) rounds, besides
    each conv operand, the trunk's skip stream where the fused forward
    stores it: the stem's output and each block's x + conv1x1(...), so
    that a control computes the whole forward in its precision. At trunk
    width: the stem, two a block (its stored output, its first conv's
    input) and the two heads' conv inputs."""
    state = _state("7x6")
    params, stats, _ = _reference(state)
    x = _obs("7x6", 8, 2)
    widths = []

    def recording(t):
        if t.dim() == 4 and t.shape[0] == x.shape[0]:
            widths.append(t.shape[1])
        return ref_net.bfloat16_rounding(t)

    with torch.no_grad():
        ref_net.forward(params, stats, x, SMALL["depth"], quantize=recording)
    assert widths.count(SMALL["filters"]) == 2 * SMALL["depth"] + 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_forward_matches_the_module_path(dtype):
    """N1's plain version of a nested-bottleneck net against the module
    path: float32 up to the order of float32 sums; bf16 within the bound
    of a few bf16 steps over 13 layers (observed at most 0.006 on logits
    up to 0.6: held at 0.05). Dropping the pooled bias from the plain
    version's arithmetic moves it far past that."""
    state = _state("7x6", seed=3, compute_dtype=dtype)
    net = state.net.eval()
    x = _obs("7x6", 16, 2)
    with torch.inference_mode():
        want = net(x)
        got = fused_net.forward_plain(net, x)
        weight = net.blocks[0].inner[0].gpool.dense.weight
        saved = weight.clone()
        weight.zero_()
        bare = fused_net.forward_plain(net, x)
        weight.copy_(saved)
    tol = 1e-5 if dtype == "float32" else 0.05
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert (a - b.float()).abs().max() < tol
    assert (bare[0] - got[0]).abs().max() > 0.05


def test_applies_takes_the_widths_n1_builds():
    """A bf16 eval net on CUDA observations takes the fused forward where
    the mid width and the regular and pooled channels are multiples of 64;
    a mid width of 96 or 32 pooled channels take the module path."""
    cuda = type("Obs", (), {"device": torch.device("cuda")})()

    def net(**model):
        widths = dict(SMALL, compute_dtype="bfloat16", filters=128,
                      mid_filters=128, gpool_filters=64)
        widths.update(model)
        return PolicyValueNet(7, ModelConfig(**widths)).eval()

    assert fused_net.applies(net(), cuda)
    assert not fused_net.applies(net(mid_filters=96, gpool_filters=32), cuda)
    assert not fused_net.applies(net(gpool_filters=32), cuda)


def test_nbt_net_sgd_step_matches_the_reference():
    """Loss, gradients (the new momentum less the old one's decay) and the
    parameters after one step of the port's train step, with its auxiliary
    value term, against the reference's, the pooled and pre-activation
    leaves among them."""
    (h, w), _ = BOARDS["7x6"]
    state = _state("7x6", seed=2)
    params, stats, trace = _reference(state)
    x = _obs("7x6", 64, 2)
    rng = np.random.default_rng(3)
    pi = torch.from_numpy(rng.dirichlet(np.ones(w), 64).astype(np.float32))
    z = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], 64).astype(np.float32))
    aux = _obs("7x6", 16, 4)
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
    pooled = [k for k in new_params if f"/{GPOOL}/" in k]
    assert len(pooled) == 5  # conv kernel and bias, norm, dense kernel
    assert all(np.abs(grads[k].numpy()).max() > 0 for k in pooled)
    for k in new_params:
        got_grad = got_trace[k] - m.momentum * trace[k].numpy()
        assert np.allclose(got_grad, grads[k].numpy(), atol=1e-5), k
        assert np.allclose(got_trace[k], new_trace[k].numpy(), atol=1e-5), k
        assert np.allclose(got[k], new_params[k].numpy(), atol=1e-6), k


def test_nbt_net_round_trips_through_a_checkpoint(tmp_path):
    """The new leaves in the Flax layout (params, statistics, momentum), a
    save and load bit for bit, and a ValueError for a mismatch of nesting
    or pooling."""
    state = _state("7x6", seed=5)
    m = ModelConfig(**SMALL)
    tree = train_state_to_jax(state, m)
    params = tree["params"]
    assert "BatchNorm_0" in params and "BatchNorm_0" in tree["batch_stats"]
    assert not any(k.startswith("ResidualBlock_") for k in params)
    block = params["NestedBottleneckBlock_0"]
    assert set(block) == {"NormConv_0", "InnerBlock_0", "InnerBlock_1",
                          "NormConv_1"}
    assert set(block["InnerBlock_0"]) == {"NormConv_0", GPOOL, "NormConv_1"}
    assert set(params["NestedBottleneckBlock_1"]["InnerBlock_0"]) == {
        "NormConv_0", "NormConv_1"}
    pooled = block["InnerBlock_0"][GPOOL]
    assert {k: {leaf: a.shape for leaf, a in v.items()}
            for k, v in pooled.items()} == {
        "Conv_0": {"kernel": (3, 3, 16, 8), "bias": (8,)},
        "BatchNorm_0": {"scale": (8,), "bias": (8,)},
        "Dense_0": {"kernel": (24, 8)}}
    assert block["NormConv_0"]["BatchNorm_0"]["scale"].shape == (32,)
    assert block["NormConv_0"]["Conv_0"]["kernel"].shape == (1, 1, 32, 16)
    assert set(tree["batch_stats"]["NestedBottleneckBlock_0"][
        "InnerBlock_0"][GPOOL]) == {"BatchNorm_0"}
    assert set(tree["opt_state"]["0"]["trace"]["NestedBottleneckBlock_0"][
        "InnerBlock_0"][GPOOL]) == {"Conv_0", "BatchNorm_0", "Dense_0"}
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
    params, stats = to_jax_variables(back.net)
    with pytest.raises(ValueError, match="pooled"):
        from_jax_variables(params, stats, 7, dataclasses.replace(
            m, gpool_blocks=(2,)), device="cpu")
    with pytest.raises(ValueError, match="nested bottleneck"):
        from_jax_variables(params, stats, 7, ModelConfig(
            depth=2, filters=32, residual_projection=False), device="cpu")
    classic = PolicyValueNet(7, ModelConfig(depth=2, filters=32,
                                            residual_projection=False))
    with pytest.raises(ValueError, match="nested bottleneck"):
        from_jax_variables(*to_jax_variables(classic), 7, m, device="cpu")


def test_nbt_module_parameters():
    """b18c384nbt at Connect-4's shapes: 26.39 M parameters, and a pooled
    block's branch adds its conv, norm and bias-free dense layer."""
    cfg = ModelConfig(depth=18, filters=384, mid_filters=192,
                      gpool_filters=64, gpool_blocks=(5, 10, 15),
                      residual_projection=False)
    net = PolicyValueNet(7, cfg)
    assert sum(p.numel() for p in net.parameters()) == 26_385_373
    assert [i for i, block in enumerate(net.blocks)
            if block.inner[0].gpool is not None] == [4, 9, 14]
    gpool = net.blocks[4].inner[0].gpool
    assert gpool.dense.bias is None
    assert tuple(gpool.dense.weight.shape) == (128, 192)
    assert tuple(net.blocks[4].inner[0].conv2.conv.weight.shape) == (
        192, 128, 3, 3)


@pytest.mark.parametrize("model, match", [
    (dict(mid_filters=64), "residual_projection"),
    (dict(mid_filters=64, residual_projection=False, se_ratio=4),
     "se_ratio=0"),
    (dict(gpool_filters=8, gpool_blocks=(1,), residual_projection=False),
     "mid_filters > 0"),
    (dict(mid_filters=64, gpool_filters=8, residual_projection=False),
     "needs both"),
    (dict(mid_filters=64, gpool_filters=64, gpool_blocks=(1,),
          residual_projection=False), "no regular channel"),
    (dict(mid_filters=64, gpool_filters=8, gpool_blocks=(0,),
          residual_projection=False), "from 1 to"),
    (dict(mid_filters=64, gpool_filters=8, gpool_blocks=(1, 1),
          residual_projection=False), "distinct"),
    (dict(mid_filters=-1, residual_projection=False), ">= 0"),
])
def test_validate_rejects_towers_it_cannot_build(model, match):
    """Nested bottlenecks refuse projections and gates; pooling needs a
    nested tower, both its options, regular channels left over and block
    numbers within the depth."""
    cfg = dataclasses.replace(Config(), model=dataclasses.replace(
        ModelConfig(depth=4, filters=16), **model))
    with pytest.raises(ValueError, match=match):
        validate(cfg)


def test_config_tree_without_the_options_loads_classic_blocks():
    """A configuration tree written before the options (or by the JAX
    package) loads with none; the port's snapshot carries them, and the
    command line sets them."""
    tree = json.loads(to_json(Config()))
    for key in ("mid_filters", "gpool_filters", "gpool_blocks"):
        tree["model"].pop(key)
    assert from_json(json.dumps(tree)).model.mid_filters == 0
    cfg = apply_overrides(Config(), parse_cli_overrides(
        ["--model.residual_projection=false", "--model.mid_filters=192",
         "--model.gpool_filters=64", "--model.gpool_blocks=5,10,15",
         "--model.filters=384", "--model.depth=18"]))
    assert cfg.model.gpool_blocks == (5, 10, 15)
    assert from_json(to_json(cfg)) == cfg


def test_net_nbt_imports_neither_the_program_nor_jax():
    with open(ref_net.__file__) as fp:
        tree = ast.parse(fp.read())
    names = [alias.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    tops = {name.split(".")[0] for name in names}
    assert not tops & {"jax", "jaxlib", "flax", "optax",
                       "custom_alphazero_tpu", "custom_alphazero_tpu_torch"}
    assert tops <= {"__future__", "math", "typing", "torch", "azbench"}


def test_learner_generates_with_an_nbt_net():
    """One tiny generation of the Learner with a nested-bottleneck net (its
    evaluations through the module path on the CPU), then a train step."""
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    torch.set_num_threads(1)
    cfg = apply_overrides(Config(), parse_cli_overrides([
        "--mcts.simulations=4", "--self_play.games_per_generation=4",
        "--self_play.max_plies=6", "--self_play.exclude_draws=false",
        "--model.depth=1", "--model.filters=16", "--model.mid_filters=8",
        "--model.gpool_filters=4", "--model.gpool_blocks=1",
        "--model.value_hidden=8", "--model.batch_size=8",
        "--model.residual_projection=false", "--replay.capacity=200",
        "--replay.min_size=8"]))
    lrn = Learner(cfg, device="cpu")
    assert lrn.best.blocks[0].inner[0].gpool is not None
    batch, _ = lrn.generate()
    valid = batch.valid
    assert int(valid.sum()) > 0
    assert torch.allclose(batch.policy[valid].sum(-1),
                          torch.ones(int(valid.sum())))
    replay = lrn.replay_add(lrn.init_replay(), batch)
    metrics = lrn.train_step(*lrn.replay_sample(replay)[:3])
    assert np.isfinite(float(metrics.loss))


# ---------------------------------------------------------------------------
# The benchmark's nested-bottleneck self-play driver
# ---------------------------------------------------------------------------


def _nbt_root(tmp_path) -> str:
    """A tiny benchmark root with a seeded nested-bottleneck configuration
    (depth 2, trunk 16, mid 8, 4 pooled in block 1, float32, 8 games, 8
    simulations) and its cell, added as new files and entries."""
    root = fixture.tiny_root(str(tmp_path))
    bench_dir = os.path.join(root, "azbench")
    cfg = fixture.tiny_config()
    cfg["model"].update(depth=2, filters=16, residual_projection=False,
                        mid_filters=8, gpool_filters=4, gpool_blocks=[1])
    os.makedirs(os.path.join(root, "weights-nbt"))
    shutil.copy(os.path.join(REPO, "azbench", "weights", "c4-b18c384nbt",
                             "seeded.json"),
                os.path.join(root, "weights-nbt", "seeded.json"))
    with open(os.path.join(bench_dir, "configs", "tiny-nbt.json"),
              "w") as fp:
        json.dump({"name": "tiny-nbt", "weights": "weights-nbt",
                   "config": cfg}, fp)
    shutil.copy(os.path.join(REPO, "azbench", "limits",
                             "c4nbt-selfplay.json"),
                os.path.join(bench_dir, "limits", "tiny-nbt-selfplay.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        b = json.load(fp)
    b["configs"].append({"name": "tiny-nbt", "source": "test",
                         "file": "azbench/configs/tiny-nbt.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-nbt-selfplay", "config": "tiny-nbt",
                           "traffic": "selfplay_seeded_nbt", "chips": 1,
                           "why": "test"})
    for metric in b["end_to_end"] + b["per_layer"]:
        if "c4nbt-selfplay" in metric.get("workloads", ()):
            metric["workloads"].append("tiny-nbt-selfplay")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(b, fp)
    return root


def test_nbt_selfplay_driver_end_to_end(tmp_path):
    """The c4nbt-selfplay cell's driver on a tiny nested-bottleneck
    configuration: correct, every compared number within its limit, the
    weights the recipe's (the pooled branch's leaves drawn by the plain
    kinds; set-up twice from one seed gives the same tree)."""
    from azbench.drivers import selfplay_nbt

    torch.set_num_threads(1)
    root = _nbt_root(tmp_path)
    seed = 2**31 + 17
    out = harness.run_cell(root, "tiny-nbt-selfplay", seed=seed,
                           seconds=0.5, trace=False, device="cpu")
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"selfplay_faults", "ring_faults",
                                    "noise_mean_z", "search_faults",
                                    "logit_gap"}
    assert out["compared"]["logit_gap"]["value"] < 1e-4
    assert out["metrics"]["selfplay_positions_per_s"]["value"] > 0

    bench = harness._load_json(os.path.join(root, "BENCHMARK.json"))
    run_ = harness.Run(root, bench, "tiny-nbt-selfplay", seed, 0.0, False,
                       "cpu", 0.0)
    lrn, (params, _) = selfplay_nbt.learner(run_)
    again = selfplay_nbt.seeded_tree(run_, seed)
    flat = ref_net.flatten(again["params"])
    assert all(np.array_equal(flat[k], params[k].numpy()) for k in flat)
    dense = flat[f"NestedBottleneckBlock_0/InnerBlock_0/{GPOOL}/Dense_0/"
                 "kernel"]
    assert dense.shape == (12, 4)
    assert f"NestedBottleneckBlock_1/InnerBlock_0/{GPOOL}/Dense_0/kernel" \
        not in flat


@pytest.mark.parametrize("case", ["no option", "classic blocks",
                                  "pooled elsewhere", "configuration"])
def test_nbt_selfplay_driver_refuses_what_it_cannot_compare(tmp_path,
                                                            monkeypatch,
                                                            case):
    """Set-up refuses a program whose ModelConfig has no ``mid_filters``
    (as the parent's, whose ``from_json`` drops the key) before it builds
    anything, a program whose built blocks are not nested bottlenecks or
    pool elsewhere, and a configuration without nested bottlenecks."""
    from azbench.drivers import selfplay_nbt
    from custom_alphazero_tpu_torch import config as port_config

    torch.set_num_threads(1)
    root = _nbt_root(tmp_path)
    bench = harness._load_json(os.path.join(root, "BENCHMARK.json"))
    run_ = harness.Run(root, bench, "tiny-nbt-selfplay", 5, 0.0, False,
                       "cpu", 0.0)
    if case == "no option":
        fields = [f for f in dataclasses.fields(port_config.ModelConfig)
                  if f.name not in selfplay_nbt.OPTIONS]
        old = dataclasses.make_dataclass(
            "ModelConfig", [(f.name, f.type, f) for f in fields],
            frozen=True)
        monkeypatch.setattr(port_config, "ModelConfig", old)
        with pytest.raises(RuntimeError, match="mid_filters"):
            selfplay_nbt.setup(run_)
        return
    if case == "configuration":
        run_.config["config"]["model"]["mid_filters"] = 0
        with pytest.raises(ValueError, match="mid_filters"):
            selfplay_nbt.refuse_other_net(run_)
        return
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    lrn = Learner(run_.program_config(), device="cpu")
    selfplay_nbt.refuse_other_net(run_, lrn)
    if case == "classic blocks":
        lrn.best.blocks[1] = PolicyValueNet(7, ModelConfig(
            depth=1, filters=16, residual_projection=False)).blocks[0]
    else:
        lrn.candidate.blocks[1].inner[0].gpool = (
            lrn.candidate.blocks[0].inner[0].gpool)
    with pytest.raises(RuntimeError, match="pooled"):
        selfplay_nbt.refuse_other_net(run_, lrn)


@pytest.mark.parametrize("control", ["float8", "no_gpool", "no_inner_skip"])
def test_nbt_cell_controls_fail_its_limits(monkeypatch, control):
    """The c4nbt-selfplay cell's controls at the configuration's own
    shapes (b18c384nbt): the recipe's weights for one seed (calibrated on
    64 positions, where the cell takes 1,024), 16 positions, the port's
    bf16 forward (its plain version, loaded through the converter) within
    the cell's limits (the logit gap: the value gap has none), and in the
    program's place the reference one precision below bf16 (float8),
    without its pooled biases (no_gpool) or without its inner skips
    (no_inner_skip) outside them."""
    from azbench.drivers import selfplay_nbt as driver
    from azbench.drivers import selfplay_seeded as seeded

    torch.set_num_threads(4)
    bench = harness._load_json(os.path.join(REPO, "BENCHMARK.json"))

    def new_run():
        return harness.Run(REPO, bench, "c4nbt-selfplay", 2**31 + 7, 0.0,
                           False, "cpu", 0.0)

    def judged(priors, values):
        run_ = new_run()
        for name, value in zip(("logit_gap", "value_gap"),
                               seeded.forward_gaps(priors, values, *ref)):
            if name in run_.limits:
                run_.compare(name, value)
        return run_

    run_ = new_run()
    recipe = seeded._recipe(run_)
    recipe["calibration"]["positions"] = 64
    monkeypatch.setattr(seeded, "_recipe", lambda _: recipe)
    tree = driver.seeded_tree(run_, run_.seed)
    params = ref_net.to_device(ref_net.flatten(tree["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), "cpu")
    obs = _obs("7x6", 16, 8)
    depth = run_.config["config"]["model"]["depth"]
    ref = driver.reference_forward(params, stats, depth, obs)
    _, quantize, gpool, inner_skip = {
        c[0]: c for c in driver.CONTROLS}[control]
    low_logits, low_values = driver.reference_forward(
        params, stats, depth, obs, quantize, gpool, inner_skip)
    judged_control = judged(torch.softmax(low_logits, -1), low_values)
    assert not judged_control.correct, judged_control.compared

    model = run_.config["config"]["model"]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in model.items()
                         if k not in ("lr_boundaries", "lr_values")})
    net = from_jax_variables(tree["params"], tree["batch_stats"], 7, cfg,
                             device="cpu")
    with torch.inference_mode():
        logits, values = fused_net.forward_plain(net, obs)
    sound = judged(torch.softmax(logits.float(), -1), values.float())
    assert sound.correct, sound.compared
