"""The port's losses, optimizer and train step against the JAX package's,
from identical weights (through the converters) and identical batches made
from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.models import losses as jax_losses
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.runtime import train as jax_train
from custom_alphazero_tpu_torch.config import ModelConfig
from custom_alphazero_tpu_torch.models import losses, policy_value
from custom_alphazero_tpu_torch.models.convert import (
    to_jax_variables,
    train_state_from_jax,
    train_state_to_jax,
)
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)

SMALL = dict(depth=2, filters=8, value_hidden=16, lr_boundaries=(2, 4),
             lr_values=(5e-2, 2e-2, 1e-2))
OBS_SHAPE = (6, 7, 4)
A = 7


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((n,) + OBS_SHAPE).astype(np.float32)
    pi = rng.random((n, A)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    z = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    return obs, pi, z


def _flat(tree, prefix=""):
    """{path: array} of a nested dict of arrays."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _max_abs(got_tree, want_tree):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _jax_state(cfg, seed=0):
    """A JAX train state with non-trivial running statistics and momentum
    (two warm-up steps on a separate batch)."""
    net = JaxPolicyValueNet(A, cfg)
    state = jax_train.init_train_state(net, cfg, jax.random.PRNGKey(seed),
                                       OBS_SHAPE)
    step = jax.jit(jax_train.make_train_step(net, cfg))
    for i in range(2):
        state, _ = step(state, *map(jnp.asarray, _batch(16, 100 + i)))
    return net, state


# ---------------------------------------------------------------------------
# Losses, schedule, clip
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(32, A)).astype(np.float32) * 3
    _, pi, z = _batch(32, 1)
    value = np.tanh(rng.normal(size=32)).astype(np.float32)
    np.testing.assert_allclose(
        losses.policy_loss(torch.from_numpy(logits), torch.from_numpy(pi)),
        jax_losses.policy_loss(jnp.asarray(logits), jnp.asarray(pi)),
        rtol=1e-6)
    np.testing.assert_allclose(
        losses.value_loss(torch.from_numpy(value), torch.from_numpy(z)),
        jax_losses.value_loss(jnp.asarray(value), jnp.asarray(z)),
        rtol=1e-6)


def test_l2_penalty_covers_kernels_only():
    cfg = JaxModelConfig(**SMALL, compute_dtype="float32")
    _, state = _jax_state(cfg)
    tree = serialization.to_state_dict(jax.device_get(state))
    port = train_state_from_jax(tree, A, ModelConfig(**SMALL,
                                                     compute_dtype="float32"),
                                device="cpu")
    kernels = losses.kernel_parameters(port.net)
    # 3 convs per block + stem + two head convs, and three dense layers.
    assert len(kernels) == 3 * SMALL["depth"] + 3 + 3
    assert all(k.dim() in (2, 4) for k in kernels)
    np.testing.assert_allclose(
        losses.l2_penalty(kernels, 1e-4).item(),
        float(jax_losses.l2_penalty(state.params, 1e-4)), rtol=1e-6)


@pytest.mark.parametrize("boundaries, values", [
    ((150_000, 300_000), (1e-2, 1e-3, 1e-4)),
    ((10_000, 13_000), (5e-4, 2.5e-4, 1e-4)),
    ((), (0.1,)),
])
def test_learning_rate_schedule_matches_optax(boundaries, values):
    cfg = ModelConfig(lr_boundaries=boundaries, lr_values=values)
    schedule = jax_losses.learning_rate_schedule(
        JaxModelConfig(lr_boundaries=boundaries, lr_values=values))
    steps = {0, 10_000_000}
    for b in boundaries:
        steps |= {b - 1, b, b + 1}
    for step in sorted(steps):
        assert losses.learning_rate(cfg, step) == float(schedule(step)), step


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0],
                         ids=["below", "at", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((4, 3), (5,), (2, 2, 2))]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))
    max_norm = 2.0
    grads = [g * np.float32(scale * max_norm / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = losses.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                     max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    total = float(torch.sqrt(sum(g.square().sum() for g in got)))
    assert total <= max_norm * (1 + 1e-6)
    if scale < 1.0:
        assert all(np.array_equal(g.numpy(), x) for g, x in zip(got, grads))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _run_both(cfg_kwargs, clip, aux_value, aux_policy, steps=5):
    """``steps`` train steps in both packages from one state and the same
    batches (aux rows injected); returns per-step metric pairs and the two
    final state dicts."""
    jcfg = JaxModelConfig(**cfg_kwargs, grad_clip_norm=clip)
    cfg = ModelConfig(**cfg_kwargs, grad_clip_norm=clip)
    net, state = _jax_state(jcfg)
    port = train_state_from_jax(
        serialization.to_state_dict(jax.device_get(state)), A, cfg,
        device="cpu")
    assert port.steps == 2

    rng = np.random.default_rng(7)
    aux_obs, aux_pi, aux_z = _batch(40, 8)
    aux_pi = np.eye(A, dtype=np.float32)[aux_pi.argmax(-1)]
    use_aux = aux_value > 0 or aux_policy > 0

    # The JAX step draws its aux rows from a key: draw them the same way
    # and inject them into the port's step.
    jstep = jax.jit(jax_train.make_train_step(
        net, jcfg, aux_value_weight=aux_value, aux_value_batch=12,
        aux_policy_weight=aux_policy))
    pstep = make_train_step(cfg, aux_value_weight=aux_value,
                            aux_value_batch=12, aux_policy_weight=aux_policy)
    pairs = []
    for i in range(steps):
        obs, pi, z = _batch(16, 200 + i)
        if use_aux:
            key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
            idx = np.asarray(jax.random.randint(key, (12,), 0, 40))
            state, jm = jstep(state, jnp.asarray(obs), jnp.asarray(pi),
                              jnp.asarray(z), key, jnp.asarray(aux_obs),
                              jnp.asarray(aux_z), jnp.asarray(aux_pi))
            port, pm = pstep(
                port, torch.from_numpy(obs), torch.from_numpy(pi),
                torch.from_numpy(z), None, torch.from_numpy(aux_obs),
                torch.from_numpy(aux_z), torch.from_numpy(aux_pi),
                torch.from_numpy(idx.copy()).long())
        else:
            state, jm = jstep(state, jnp.asarray(obs), jnp.asarray(pi),
                              jnp.asarray(z))
            port, pm = pstep(port, torch.from_numpy(obs),
                             torch.from_numpy(pi), torch.from_numpy(z))
        pairs.append((pm, jm))
    assert not port.net.training
    return (pairs, train_state_to_jax(port, cfg),
            serialization.to_state_dict(jax.device_get(state)))


FP32 = dict(SMALL, compute_dtype="float32")


@pytest.mark.parametrize("clip, aux_value, aux_policy", [
    (0.0, 0.0, 0.0),
    (0.5, 0.0, 0.0),
    (0.0, 0.25, 0.0),
    (0.5, 0.25, 0.5),
], ids=["plain", "clip", "aux_value", "clip_aux_value_aux_policy"])
def test_train_steps_match_jax_fp32(clip, aux_value, aux_policy):
    """5 float32 steps across two learning-rate boundaries: every loss term
    within 1e-5, every parameter, momentum buffer, running mean and running
    variance within 1e-5 max-abs (observed below 2e-6), ``steps`` and the
    learning rate equal."""
    pairs, got, want = _run_both(FP32, clip, aux_value, aux_policy)
    for i, (pm, jm) in enumerate(pairs):
        for term in ("loss", "policy_loss", "value_loss", "l2",
                     "solver_value_loss", "solver_policy_loss"):
            assert abs(float(getattr(pm, term))
                       - float(getattr(jm, term))) < 1e-5, (i, term)
        assert pm.steps == int(jm.steps) == 3 + i
        assert pm.learning_rate == float(jm.learning_rate)
    # The schedule was crossed: steps 2, 3 at 2e-2, steps 4.. at 1e-2.
    assert [pm.learning_rate for pm, _ in pairs] == pytest.approx(
        [2e-2, 2e-2, 1e-2, 1e-2, 1e-2])
    if aux_value > 0:
        assert float(pairs[0][0].solver_value_loss) > 0
    assert _max_abs(got["params"], want["params"]) < 1e-5
    assert _max_abs(got["batch_stats"], want["batch_stats"]) < 1e-5
    assert _max_abs(got["opt_state"], want["opt_state"]) < 1e-5
    assert int(got["steps"]) == int(want["steps"]) == 7
    # The optimizer state has optax's tree, with and without the clip.
    assert _flat(got["opt_state"]).keys() == _flat(want["opt_state"]).keys()


def test_train_step_bf16_matches_jax_loosely():
    """bf16: autocast rounds at other points than Flax's bf16 modules (the
    net tests hold the outputs to 1e-2), and a loss of order 1 carries that
    through a square: loss terms within 3e-2 (observed 6.4e-3), parameters
    after 3 small steps within 3e-3 (observed 4.9e-4), running statistics
    within 1e-3 (observed 2.6e-5)."""
    cfg = dict(SMALL, compute_dtype="bfloat16", lr_values=(5e-3, 2e-3, 1e-3))
    pairs, got, want = _run_both(cfg, 0.0, 0.25, 0.0, steps=3)
    for pm, jm in pairs:
        for term in ("loss", "policy_loss", "value_loss",
                     "solver_value_loss"):
            assert abs(float(getattr(pm, term))
                       - float(getattr(jm, term))) < 3e-2, term
        assert pm.learning_rate == float(jm.learning_rate)
    assert _max_abs(got["params"], want["params"]) < 3e-3
    assert _max_abs(got["batch_stats"], want["batch_stats"]) < 1e-3


def test_running_variance_is_the_biased_one():
    """Flax feeds the running variance the biased batch variance. The
    port's BatchNorm matches it to 1e-6 on an 8-sample batch; stock
    ``nn.BatchNorm2d`` (unbiased, 8/7 of it) fails the same check."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 2, 2, 3)).astype(np.float32) * 2 + 1  # NHWC
    ref = nn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_y, mutated = ref.apply(variables, jnp.asarray(x),
                                mutable=["batch_stats"])
    want = jax.device_get(mutated["batch_stats"])
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)

    def errors(bn):
        y = bn.train()(x_nchw).permute(0, 2, 3, 1)
        return (float((y.detach().numpy() - np.asarray(want_y)).max()),
                float(np.abs(bn.running_mean.numpy() - want["mean"]).max()),
                float(np.abs(bn.running_var.numpy() - want["var"]).max()))

    y_err, mean_err, var_err = errors(policy_value.BatchNorm(3))
    assert y_err < 1e-5 and mean_err < 1e-6 and var_err < 1e-6
    stock = torch.nn.BatchNorm2d(3, eps=1e-3, momentum=0.01)
    y_err, mean_err, var_err = errors(stock)
    assert y_err < 1e-5 and mean_err < 1e-6
    assert var_err > 1e-3  # the unbiased variance: the check above fails
    # Eval mode normalises with the running statistics and leaves them.
    bn = policy_value.BatchNorm(3)
    before = bn.running_var.clone()
    bn.eval()(x_nchw)
    assert torch.equal(bn.running_var, before)


def test_aux_forward_leaves_running_stats_and_flows_gradients():
    cfg = ModelConfig(**FP32)
    gen = torch.Generator().manual_seed(0)
    obs, pi, z = map(torch.from_numpy, _batch(16, 1))
    aux_obs, aux_pi, aux_z = map(torch.from_numpy, _batch(40, 2))

    def stats_after(weight, aux):
        state = init_train_state(A, cfg, torch.Generator().manual_seed(1),
                                 OBS_SHAPE, device="cpu")
        step = make_train_step(cfg, aux_value_weight=weight,
                               aux_value_batch=12)
        state, m = step(state, obs, pi, z, gen, aux, aux_z)
        return state, m

    plain, _ = stats_after(0.0, None)
    with_aux, m = stats_after(0.5, aux_obs)
    # The aux batch did not touch the running statistics ...
    for a, b in zip(plain.net.buffers(), with_aux.net.buffers()):
        assert torch.equal(a, b)
    # ... but its gradient moved the parameters.
    assert float(m.solver_value_loss) > 0
    assert any(not torch.equal(a, b) for a, b in
               zip(plain.net.parameters(), with_aux.net.parameters()))
    # Aux rows are drawn with replacement: 64 draws from 40 rows work.
    state = init_train_state(A, cfg, gen, OBS_SHAPE, device="cpu")
    make_train_step(cfg, aux_value_weight=0.5, aux_value_batch=64)(
        state, obs, pi, z, gen, aux_obs[:3], aux_z[:3])


def test_train_step_reduces_loss_in_place():
    """As tests/test_runtime.py::test_train_step_reduces_loss; and the step
    updates the net's tensors in place (a captured graph stays valid)."""
    cfg = ModelConfig(depth=1, filters=8, value_hidden=16,
                      compute_dtype="float32")
    state = init_train_state(A, cfg, torch.Generator().manual_seed(0),
                             OBS_SHAPE, device="cpu")
    pointers = [p.data_ptr() for p in state.net.parameters()]
    pointers += [b.data_ptr() for b in state.net.buffers()]
    obs, pi, z = map(torch.from_numpy, _batch(32, 0))
    z = torch.where(z == 0, 1.0, z)
    step = make_train_step(cfg)
    state, m0 = step(state, obs, pi, z)
    for _ in range(30):
        state, m = step(state, obs, pi, z)
    assert float(m.loss) < float(m0.loss)
    assert m.steps == 31 and state.steps == 31
    assert m.learning_rate == pytest.approx(1e-2)
    assert pointers == [p.data_ptr() for p in state.net.parameters()] + [
        b.data_ptr() for b in state.net.buffers()]
    assert "num_batches_tracked" not in "".join(state.net.state_dict())


def test_init_train_state_follows_flax_initialisers():
    cfg = ModelConfig(depth=1, filters=64, value_hidden=64)
    state = init_train_state(A, cfg, torch.Generator().manual_seed(0),
                             OBS_SHAPE, device="cpu")
    params, batch_stats = to_jax_variables(state.net)
    ref = JaxPolicyValueNet(A, JaxModelConfig(depth=1, filters=64,
                                              value_hidden=64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + OBS_SHAPE), train=False)
    got, want = _flat(params), _flat(jax.device_get(ref["params"]))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        if key.endswith("kernel") and got[key].size > 2000:
            # Same distribution: truncated normal of variance 1 / fan_in.
            assert got[key].std() == pytest.approx(want[key].std(), rel=0.1)
            assert np.abs(got[key]).max() <= 2.3 * want[key].std()
        elif not key.endswith("kernel"):
            np.testing.assert_array_equal(got[key], want[key])
    assert all(torch.count_nonzero(t) == 0 for t in state.trace)
    assert state.steps == 0
    probs, value = make_evaluate_fn(state.net)(torch.rand(3, *OBS_SHAPE))
    assert probs.shape == (3, A) and value.shape == (3,)


def test_train_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(A, ModelConfig(**FP32), torch.Generator(), OBS_SHAPE)


def test_train_state_converters_roundtrip():
    """Flax state dict -> port -> Flax state dict is the identity, with and
    without the clip's wrapper around the optimizer state."""
    for clip in (0.0, 1.0):
        jcfg = JaxModelConfig(**FP32, grad_clip_norm=clip)
        _, state = _jax_state(jcfg)
        want = serialization.to_state_dict(jax.device_get(state))
        cfg = ModelConfig(**FP32, grad_clip_norm=clip)
        got = train_state_to_jax(
            train_state_from_jax(want, A, cfg, device="cpu"), cfg)
        assert _max_abs(got, want) == 0.0
        assert ("0" in got["opt_state"]["1"]) == (clip > 0)
        restored = serialization.from_state_dict(jax.device_get(state), got)
        assert int(restored.steps) == 2
        assert dataclasses.is_dataclass(restored)
