"""The port's policy-value net, weight conversion and checkpoint reader
against the Flax net and Flax's msgpack restore."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.models.policy_value import (
    masked_policy as jax_masked_policy,
)
from custom_alphazero_tpu_torch.config import ModelConfig
from custom_alphazero_tpu_torch.io.checkpoint import (
    load_jax_checkpoint,
    msgpack_restore,
)
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.models.policy_value import masked_policy
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn

C4R5 = os.path.join(os.path.dirname(__file__), "..", "artifacts", "c4-r5",
                    "iteration_11600")
SMALL = dict(depth=2, filters=16, value_hidden=32)


def _flax_variables(cfg, obs):
    """Flax net variables with non-trivial batch stats (a few train-mode
    updates), as numpy trees."""
    net = JaxPolicyValueNet(7, cfg)
    variables = net.init(jax.random.PRNGKey(7), obs[:1], train=False)
    for _ in range(3):
        _, mutated = net.apply(variables, obs, train=True,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": mutated["batch_stats"]}
    return net, jax.device_get(variables)


def _obs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((batch, 6, 7, 4)).astype(np.float32)


@pytest.mark.parametrize("dtype, rtol, atol", [
    ("float32", 2e-4, 2e-5),
    # bf16: Flax rounds inside its bf16 BatchNorm, torch autocast keeps
    # BatchNorm in float32, so outputs agree to bf16 resolution only
    # (observed 8e-4 here, against 2.7e-3 between Flax's bf16 and fp32).
    ("bfloat16", 0.0, 1e-2),
])
def test_net_matches_flax(dtype, rtol, atol):
    obs = _obs(16)
    jcfg = dataclasses.replace(JaxModelConfig(**SMALL), compute_dtype=dtype)
    net, variables = _flax_variables(
        dataclasses.replace(jcfg, compute_dtype="float32"), jnp.asarray(obs)
    )
    ref_logits, ref_value = jax.device_get(
        JaxPolicyValueNet(7, jcfg).apply(variables, jnp.asarray(obs),
                                         train=False)
    )
    port = from_jax_variables(
        variables["params"], variables["batch_stats"], 7,
        ModelConfig(**SMALL, compute_dtype=dtype), device="cpu",
    )
    with torch.no_grad():
        logits, value = port(torch.from_numpy(obs))
    assert logits.dtype == torch.float32 and value.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(value.numpy(), ref_value, rtol=rtol,
                               atol=atol)


def test_evaluate_fn_is_softmax_of_net():
    obs = torch.from_numpy(_obs(4))
    cfg = ModelConfig(**SMALL, compute_dtype="float32")
    _, variables = _flax_variables(
        JaxModelConfig(**SMALL, compute_dtype="float32"), jnp.asarray(obs)
    )
    net = from_jax_variables(variables["params"], variables["batch_stats"],
                             7, cfg, device="cpu")
    probs, value = make_evaluate_fn(net)(obs)
    with torch.no_grad():
        logits, ref_value = net(obs)
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=0,
                               atol=0)
    torch.testing.assert_close(value, ref_value, rtol=0, atol=0)


def test_masked_policy_matches_flax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    legal = rng.random((5, 7)) > 0.4
    legal[0] = False  # no legal move: uniform
    want = np.asarray(jax_masked_policy(jnp.asarray(logits),
                                        jnp.asarray(legal)))
    got = masked_policy(torch.from_numpy(logits), torch.from_numpy(legal))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    assert type(got) is type(want), path
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_checkpoint_reader_matches_flax_restore():
    with open(os.path.join(C4R5, "train_state.msgpack"), "rb") as fp:
        payload = fp.read()
    _assert_trees_equal(msgpack_restore(payload),
                        serialization.msgpack_restore(payload))
    params, batch_stats, meta = load_jax_checkpoint(C4R5)
    assert meta["steps"] == 11600
    assert params["ResidualBlock_3"]["ConvBlock_0"]["Conv_0"][
        "kernel"].shape == (3, 3, 128, 128)
    assert batch_stats["ConvBlock_0"]["BatchNorm_0"]["var"].shape == (128,)


def test_checkpoint_reader_rejects_bad_hash_and_missing_sentinel(tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(C4R5, bad)
    meta = json.loads((bad / "meta.json").read_text())
    meta["hash"] = "0" * 64
    (bad / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="hash mismatch"):
        load_jax_checkpoint(str(bad))
    (bad / "MODEL_SAVED_SUCCESSFULLY").unlink()
    with pytest.raises(FileNotFoundError):
        load_jax_checkpoint(str(bad))


def test_trained_checkpoint_forward_matches_flax():
    """The committed c4-r5 weights through both nets, fp32."""
    params, batch_stats, _ = load_jax_checkpoint(C4R5)
    cfg = dict(depth=4, filters=128, value_hidden=256,
               compute_dtype="float32")
    obs = _obs(8, seed=1)
    ref_logits, ref_value = jax.device_get(
        JaxPolicyValueNet(7, JaxModelConfig(**cfg)).apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(obs), train=False,
        )
    )
    net = from_jax_variables(params, batch_stats, 7, ModelConfig(**cfg),
                             device="cpu")
    with torch.no_grad():
        logits, value = net(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(value.numpy(), ref_value, rtol=2e-4,
                               atol=2e-5)
