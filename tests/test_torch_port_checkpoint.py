"""The port's checkpoint writer against the JAX package's protocol: a
checkpoint written by either package restores in the other and the next
train step agrees."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.io import checkpoint as jax_checkpoint
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.replay import buffer as jax_buffer
from custom_alphazero_tpu.replay import codec as jax_codec
from custom_alphazero_tpu.runtime import train as jax_train
from custom_alphazero_tpu.runtime.selfplay import SelfPlayBatch as JaxBatch
from custom_alphazero_tpu_torch.config import ModelConfig
from custom_alphazero_tpu_torch.io.checkpoint import (
    checkpoint_exists,
    latest_evaluation_iteration,
    list_evaluation_iterations,
    load_checkpoint,
    load_replay,
    load_jax_checkpoint,
    msgpack_restore,
    msgpack_serialize,
    save_checkpoint,
    save_checkpoint_async,
)
from custom_alphazero_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_to_jax,
)
from custom_alphazero_tpu_torch.replay.buffer import (
    replay_add,
    replay_from_state_dict,
    replay_init,
    replay_state_dict,
)
from custom_alphazero_tpu_torch.replay.codec import BitplaneCodec
from custom_alphazero_tpu_torch.runtime.selfplay import SelfPlayBatch
from custom_alphazero_tpu_torch.runtime.train import make_train_step

SMALL = dict(depth=1, filters=8, value_hidden=16, compute_dtype="float32")
OBS_SHAPE = (6, 7, 4)
A = 7
C4R5_STATE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                          "c4-r5", "final_training_state")


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    obs = (rng.random((n,) + OBS_SHAPE) > 0.5).astype(np.float32)
    pi = rng.random((n, A)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    z = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return obs, pi, z


def _flat(tree, prefix=""):
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
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _jax_setup(clip):
    cfg = JaxModelConfig(**SMALL, grad_clip_norm=clip)
    net = JaxPolicyValueNet(A, cfg)
    state = jax_train.init_train_state(net, cfg, jax.random.PRNGKey(0),
                                       OBS_SHAPE)
    step = jax.jit(jax_train.make_train_step(net, cfg))
    for i in range(2):
        state, _ = step(state, *map(jnp.asarray, _batch(16, i)))
    return state, step


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no_clip", "clip"])
def test_port_checkpoint_restores_in_jax_and_next_step_agrees(tmp_path, clip):
    state, jstep = _jax_setup(clip)
    cfg = ModelConfig(**SMALL, grad_clip_norm=clip)
    port = train_state_from_jax(
        serialization.to_state_dict(jax.device_get(state)), A, cfg,
        device="cpu")
    pstep = make_train_step(cfg)
    batch = _batch(16, 10)
    port, _ = pstep(port, *map(torch.from_numpy, batch))  # step 3 in the port

    path = str(tmp_path / "ckpt")
    meta = save_checkpoint(path, train_state_to_jax(port, cfg), 0.01,
                           extra_meta={"note": "x"})
    assert meta["steps"] == 3 and meta["learning_rate"] == 0.01
    assert sorted(os.listdir(path)) == [
        "MODEL_SAVED_SUCCESSFULLY", "meta.json", "train_state.msgpack"]
    with open(os.path.join(path, "meta.json")) as fp:
        assert json.load(fp) == meta and meta["note"] == "x"

    # The JAX package restores it into its own template ...
    restored, meta2 = jax_checkpoint.load_checkpoint(path, state)
    assert meta2 == meta and int(restored.steps) == 3
    # ... and its next step equals the port's next step.
    batch = _batch(16, 11)
    restored, jm = jstep(restored, *map(jnp.asarray, batch))
    port, pm = pstep(port, *map(torch.from_numpy, batch))
    assert abs(float(pm.loss) - float(jm.loss)) < 1e-5
    assert pm.steps == int(jm.steps) == 4
    got = train_state_to_jax(port, cfg)
    want = serialization.to_state_dict(jax.device_get(restored))
    assert _max_abs(got, want) < 1e-5


def test_jax_checkpoint_restores_in_port_and_next_step_agrees(tmp_path):
    state, jstep = _jax_setup(0.0)
    path = str(tmp_path / "ckpt")
    meta = jax_checkpoint.save_checkpoint(path, state, 0.01)
    tree, meta2 = load_checkpoint(path)
    assert meta2 == meta and int(tree["steps"]) == 2
    cfg = ModelConfig(**SMALL)
    port = train_state_from_jax(tree, A, cfg, device="cpu")
    batch = _batch(16, 12)
    state, jm = jstep(state, *map(jnp.asarray, batch))
    port, pm = make_train_step(cfg)(port, *map(torch.from_numpy, batch))
    assert abs(float(pm.loss) - float(jm.loss)) < 1e-5
    assert _max_abs(train_state_to_jax(port, cfg),
                    serialization.to_state_dict(jax.device_get(state))) < 1e-5
    params, batch_stats, meta3 = load_jax_checkpoint(path)
    assert meta3 == meta and "ConvBlock_0" in params and batch_stats


def test_committed_training_state_resumes_with_momentum():
    """artifacts/c4-r5/final_training_state reads into a port TrainState
    with its momentum and writes back to the same arrays, in the bytes Flax
    writes for them."""
    tree, meta = load_checkpoint(C4R5_STATE)
    cfg = ModelConfig(depth=4, filters=128, value_hidden=256)
    state = train_state_from_jax(tree, A, cfg, device="cpu")
    assert state.steps == meta["steps"] == 11600
    assert max(float(t.abs().max()) for t in state.trace) > 0
    payload = msgpack_serialize(train_state_to_jax(state, cfg))
    assert payload == serialization.msgpack_serialize(tree)
    got, want = _flat(msgpack_restore(payload)), _flat(tree)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_encoder_matches_flax_bytes():
    tree = {
        "a": np.arange(5, dtype=np.uint32),
        "b": {"0": {}, "1": np.float32(3.0), "2": np.array(7, np.int32)},
        "c": [5, -300, 70000, -(1 << 40), 1.5, True, None],
        "d": np.zeros((3, 30000), np.int8),
        "e": "x" * 300,
        "f": {str(i): i for i in range(20)},
    }
    mine = msgpack_serialize(tree)
    assert mine == serialization.msgpack_serialize(tree)
    back = msgpack_restore(mine)
    assert back["c"] == tree["c"] and back["b"]["0"] == {}
    np.testing.assert_array_equal(back["d"], tree["d"])
    with pytest.raises(TypeError):
        msgpack_serialize({"x": object()})


def test_corrupt_payload_and_missing_sentinel_raise(tmp_path):
    state, _ = _jax_setup(0.0)
    tree = serialization.to_state_dict(jax.device_get(state))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree, 0.01)
    assert checkpoint_exists(path)
    load_checkpoint(path)
    model_file = os.path.join(path, "train_state.msgpack")
    with open(model_file, "r+b") as fp:
        fp.seek(100)
        byte = fp.read(1)
        fp.seek(100)
        fp.write(bytes([byte[0] ^ 0x01]))  # one flipped bit
    with pytest.raises(ValueError, match="hash mismatch"):
        load_checkpoint(path)
    with pytest.raises(ValueError, match="hash mismatch"):
        jax_checkpoint.load_checkpoint(path, state)
    os.remove(os.path.join(path, "MODEL_SAVED_SUCCESSFULLY"))
    assert not checkpoint_exists(path)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(path)


def test_save_replaces_and_async_saves_serialise(tmp_path):
    state, _ = _jax_setup(0.0)
    tree = serialization.to_state_dict(jax.device_get(state))
    path = str(tmp_path / "training")
    save_checkpoint(path, tree, 0.01)
    threads = []
    for steps in (5, 6, 7):
        newer = dict(tree, steps=np.array(steps, np.int32))
        threads.append(save_checkpoint_async(path, newer, 0.02))
    for thread in threads:
        thread.join()
    loaded, meta = load_checkpoint(path)
    assert meta["steps"] in (5, 6, 7) and int(loaded["steps"]) == meta["steps"]
    # No temporary or retired directory is left behind.
    assert os.listdir(tmp_path) == ["training"]


def test_replay_ring_roundtrips_through_both_packages(tmp_path):
    codec = BitplaneCodec(OBS_SHAPE, (0, 1, 2, 3))
    ref_codec = jax_codec.BitplaneCodec(OBS_SHAPE, (0, 1, 2, 3))
    ring = replay_init(32, OBS_SHAPE, A, codec, device="cpu")
    ref = jax_buffer.replay_init(32, OBS_SHAPE, A, ref_codec)
    for seed, n in ((1, 20), (2, 25)):
        obs, pi, z = _batch(n, seed)
        valid = np.random.default_rng(seed).random(n) < 0.8
        ring = replay_add(ring, SelfPlayBatch(
            *map(torch.from_numpy, (obs, pi, z, valid))), codec)
        ref = jax_buffer.replay_add(ref, JaxBatch(
            *map(jnp.asarray, (obs, pi, z, valid))), ref_codec)
    state, _ = _jax_setup(0.0)
    tree = serialization.to_state_dict(jax.device_get(state))

    # Port-written: the JAX package restores the ring into its template.
    path = str(tmp_path / "port")
    save_checkpoint(path, tree, 0.01, replay_state_dict(ring))
    _, _, restored = jax_checkpoint.load_checkpoint(
        path, state, jax_buffer.replay_init(32, OBS_SHAPE, A, ref_codec))
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # JAX-written: the port restores the same ring.
    path = str(tmp_path / "jax")
    jax_checkpoint.save_checkpoint(path, state, 0.01, ref)
    saved = load_replay(path)
    back = replay_from_state_dict(saved, device="cpu")
    assert back.capacity == 32
    assert int(back.head) == int(ring.head) == int(ref.head)
    assert int(back.size) == int(ring.size)
    assert torch.equal(back.obs.words[:32], ring.obs.words[:32])
    assert torch.equal(back.policy[:32], ring.policy[:32])
    assert torch.equal(back.value[:32], ring.value[:32])
    # A checkpoint without a ring gives None.
    save_checkpoint(path, tree, 0.01)
    assert load_replay(path) is None


def test_latest_evaluation_iteration(tmp_path):
    state, _ = _jax_setup(0.0)
    tree = serialization.to_state_dict(jax.device_get(state))
    evaluation = tmp_path / "evaluation"
    assert list_evaluation_iterations(str(evaluation)) == []
    assert latest_evaluation_iteration(str(evaluation)) is None
    for n in (20, 100, 4):
        save_checkpoint(str(evaluation / f"iteration_{n}"), tree, 0.01)
    (evaluation / "iteration_x").mkdir()
    (evaluation / "iteration_200").mkdir()  # no sentinel: not completed
    (evaluation / "notes").mkdir()
    lineage = list_evaluation_iterations(str(evaluation))
    assert [n for n, _ in lineage] == [4, 20, 100]
    assert lineage == jax_checkpoint.list_evaluation_iterations(
        str(evaluation))
    assert latest_evaluation_iteration(str(evaluation)) == (
        100, str(evaluation / "iteration_100"))
