"""The port's mesh, data-parallel train step, column-sharded dense layer and
sharded phases against the JAX package's on its 8 virtual CPU devices.

The port's side runs as two processes joined by Gloo on the CPU
(parallel/launch.py), each with one torch thread; the JAX side runs the JAX
package's functions unchanged on a mesh of this process's devices. Inputs
are made from numpy seeds and handed over in files."""

import io
import json
import os
import textwrap
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from custom_alphazero_tpu.config import Config as JaxConfig
from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MeshConfig as JaxMeshConfig
from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.config import apply_overrides as jax_overrides
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.parallel import mesh as jax_mesh
from custom_alphazero_tpu.parallel import sharded as jax_sharded
from custom_alphazero_tpu.replay import codec as jax_codec
from custom_alphazero_tpu.runtime import loop as jax_loop
from custom_alphazero_tpu.runtime import train as jax_train
from custom_alphazero_tpu.runtime.selfplay import SelfPlayBatch as JaxBatch
from custom_alphazero_tpu.runtime.selfplay import SelfPlayStats as JaxStats
from custom_alphazero_tpu_torch.config import (
    Config,
    MeshConfig,
    apply_overrides,
)
from custom_alphazero_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_replay,
    save_checkpoint,
)
from custom_alphazero_tpu_torch.parallel import launch, mesh, sharded
from custom_alphazero_tpu_torch.runtime import loop

A = 7
OBS_SHAPE = (6, 7, 4)
SMALL = dict(depth=1, filters=8, value_hidden=16, compute_dtype="float32")

# The port's side of every case: ``python -c CHILD <task> <dir>`` on each
# of two ranks; inputs and outputs are files in <dir>.
CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from custom_alphazero_tpu_torch.config import MeshConfig, ModelConfig
    from custom_alphazero_tpu_torch.io.checkpoint import (
        load_checkpoint, load_replay, save_checkpoint)
    from custom_alphazero_tpu_torch.models.convert import (
        train_state_from_jax, train_state_to_jax)
    from custom_alphazero_tpu_torch.models.policy_value import (
        PolicyValueNet, data_parallel)
    from custom_alphazero_tpu_torch.parallel import distributed, sharded
    from custom_alphazero_tpu_torch.parallel.mesh import (
        full_tensors, make_mesh, shard_batch, shard_params)
    from custom_alphazero_tpu_torch.replay.buffer import (
        replay_add, replay_from_state_dict, replay_init, replay_sample,
        replay_sample_indices)
    from custom_alphazero_tpu_torch.replay.codec import codec_for_env
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.runtime.selfplay import (
        SelfPlayBatch, SelfPlayStats)
    from custom_alphazero_tpu_torch.runtime.train import (
        TrainState, make_train_step)

    task, work = sys.argv[1], sys.argv[2]
    distributed.initialize(device="cpu")
    rank = distributed.rank()
    with open(os.path.join(work, "spec.json")) as fp:
        spec = json.load(fp)
    mesh = make_mesh(MeshConfig(**spec["mesh"]))
    inputs = np.load(os.path.join(work, "inputs.npz"))

    def tensor(name):
        return torch.from_numpy(inputs[name].copy())

    if task in ("train", "mp"):
        cfg = ModelConfig(**spec["model"])
        tree, _ = load_checkpoint(os.path.join(work, "start"))
        state = train_state_from_jax(tree, 7, cfg, device="cpu")
        net = state.net
        shard_params(net, mesh, state.trace)
        data_parallel(net, mesh.data_group, mesh.dp)
        if task == "mp":
            logits, value = net(tensor("fwd_obs"))
            np.savez(os.path.join(work, f"fwd{rank}.npz"),
                     logits=logits.detach().numpy(),
                     value=value.detach().numpy())
        step = make_train_step(cfg, mesh=mesh, **spec["aux"])
        terms = []
        for i in range(spec["steps"]):
            rows = shard_batch(tuple(tensor(f"{k}{i}") for k in "opz"), mesh)
            aux = ()
            if spec["aux"]:
                aux = (None, tensor("aux_obs"), tensor("aux_z"), None,
                       tensor(f"aux_idx{i}").long())
            _, m = step(state, *rows, *aux)
            terms.append([float(m.loss), float(m.policy_loss),
                          float(m.value_loss), float(m.l2),
                          float(m.solver_value_loss)])
        # The full-size state: a plain net holding the gathered shards.
        params = full_tensors(net, list(net.parameters()))
        trace = full_tensors(net, state.trace)
        plain = PolicyValueNet(7, cfg).eval()
        with torch.no_grad():
            for mine, p in zip(plain.parameters(), params):
                mine.copy_(p)
            for mine, b in zip(plain.buffers(), net.buffers()):
                mine.copy_(b)
        out = train_state_to_jax(TrainState(plain, trace, state.steps), cfg)
        save_checkpoint(os.path.join(work, f"out{rank}"), out, 0.0)
        with open(os.path.join(work, f"terms{rank}.json"), "w") as fp:
            json.dump(terms, fp)

    if task == "replay":
        env = ConnectN(ConnectNConfig())
        codec = codec_for_env(env)
        # Each rank's ring and share of a batch, as the Learner sizes them.
        ring = replay_init(spec["capacity"] // mesh.dp, env.obs_shape, 7,
                           codec, device="cpu")
        for i in range(spec["adds"]):
            batch = SelfPlayBatch(
                *shard_batch(tuple(tensor(f"{k}{i}") for k in
                                   ("obs", "policy", "value", "valid")),
                             mesh))
            ring = replay_add(ring, batch, codec)
        fetched = sharded.fetch(ring, mesh)
        assert (fetched is None) == (rank > 0)
        if rank == 0:
            save_checkpoint(os.path.join(work, "port_ring"),
                            {"steps": np.array(0, np.int32)}, 0.0, fetched)
        # A sample comes from this rank's own ring.
        gen = torch.Generator().manual_seed(rank)
        idx = replay_sample_indices(ring, gen, spec["batch"] // mesh.dp)
        obs, pi, z = replay_sample(ring, torch.Generator().manual_seed(rank),
                                   spec["batch"] // mesh.dp, codec)
        own = bool((idx < ring.size).all()) and bool(
            torch.equal(z, ring.value[idx]))
        # JAX's fetched ring restores this rank's shard of it.
        back = replay_from_state_dict(
            load_replay(os.path.join(work, "jax_ring")), "cpu",
            (mesh.data_index, mesh.dp))
        # (The spare rows differ: the ring's took its dropped writes.)
        mine, back = ring.rows(), back.rows()
        same = all(torch.equal(a, b) for a, b in zip(
            (*back.obs, back.policy, back.value, back.head, back.size),
            (*mine.obs, mine.policy, mine.value, mine.head, mine.size)))
        stats = SelfPlayStats(*(tensor(name)[rank] for name in (
            "games", "plies", "w1", "w2", "draws", "mean")))
        reduced = sharded.reduce_stats(stats, mesh)
        with open(os.path.join(work, f"replay{rank}.json"), "w") as fp:
            json.dump({"own": own, "restored": same, "stats": [
                t.item() for t in reduced],
                "total": sharded.replay_total_size(ring, mesh),
                "min": sharded.replay_min_shard_size(ring, mesh)}, fp)
    distributed.shutdown()
""")


def _launch(task, work, spec, inputs):
    with open(os.path.join(work, "spec.json"), "w") as fp:
        json.dump(spec, fp)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    return launch.launch(2, ["-c", CHILD, task, str(work)], timeout_s=120,
                         env={"OMP_NUM_THREADS": "1"})


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _assert_close(got, want, rtol, atol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp, mp", [(8, 1), (4, 2), (8, 2)])
def test_make_mesh_matches_jax(dp, mp):
    """The grid of ranks is JAX's grid of device ids; a mesh larger than
    the world raises JAX's ValueError; local_batch_size as in
    tests/test_parallel.py."""
    devices = jax.devices()
    assert len(devices) == 8
    cfg = dict(data_parallelism=dp, model_parallelism=mp)
    if dp * mp > 8:
        with pytest.raises(ValueError) as want:
            jax_mesh.make_mesh(JaxMeshConfig(**cfg), devices)
        with pytest.raises(ValueError) as got:
            mesh.make_mesh(MeshConfig(**cfg), world=8)
        assert str(got.value) == str(want.value)
        return
    want = jax_mesh.make_mesh(JaxMeshConfig(**cfg), devices)
    got = mesh.make_mesh(MeshConfig(**cfg), world=8)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.grid, ids - ids.min())
    assert mesh.local_batch_size(256, got) == jax_mesh.local_batch_size(
        256, want) == 256 // dp
    for bad in (255, 4 * dp + 1):
        with pytest.raises(ValueError):
            mesh.local_batch_size(bad, got)
    # The automatic data axis takes every rank the model axis leaves.
    auto = mesh.make_mesh(MeshConfig(model_parallelism=mp), world=8)
    assert auto.shape == dict(jax_mesh.make_mesh(
        JaxMeshConfig(model_parallelism=mp), devices).shape)


def test_auto_data_parallelism_matches_jax():
    table = [
        ({}, 8), ({}, 1), ({"self_play.games_per_generation": "6"}, 8),
        ({"model.batch_size": "12", "self_play.games_per_generation": "16"},
         8),
        ({"replay.capacity": "1000"}, 16),
        ({"self_play.games_per_generation": "1024", "model.batch_size":
          "1024", "replay.capacity": "400000"}, 2),
        ({"self_play.games_per_generation": "7"}, 4), ({}, 0),
    ]
    for overrides, available in table:
        want = jax_loop._auto_data_parallelism(
            jax_overrides(JaxConfig(), overrides), available)
        got = loop._auto_data_parallelism(
            apply_overrides(Config(), overrides), available)
        assert got == want, (overrides, available)


@pytest.mark.parametrize("games, dp, total", [(150, 8, 160), (4, 8, 16),
                                              (16, 8, 16), (6, 2, 8)])
def test_arena_rounding_matches_jax(games, dp, total):
    """Ceil, then even per shard, with JAX's printed lines word for word."""
    jmesh = jax_mesh.make_mesh(JaxMeshConfig(data_parallelism=dp),
                               jax.devices()[:dp])
    want = io.StringIO()
    with redirect_stdout(want):
        jax_sharded.make_sharded_arena(lambda *a: None, lambda *a: None,
                                       jmesh, games, 0.55)
    got = io.StringIO()
    with redirect_stdout(got):
        local = sharded.arena_games_per_shard(games, dp)
    assert local * dp == total
    assert got.getvalue() == want.getvalue()
    assert ("WARNING" in got.getvalue()) == (total > 2 * games)


# ---------------------------------------------------------------------------
# The train step and the forward over two ranks
# ---------------------------------------------------------------------------

def _batch(n, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((n,) + OBS_SHAPE).astype(np.float32)
    pi = rng.random((n, A)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    z = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    return obs, pi, z


def _jax_start(cfg):
    """A JAX train state with moved running statistics and momentum (two
    single-device steps), and its state dict."""
    net = JaxPolicyValueNet(A, cfg)
    state = jax_train.init_train_state(net, cfg, jax.random.PRNGKey(0),
                                       OBS_SHAPE)
    step = jax.jit(jax_train.make_train_step(net, cfg))
    for i in range(2):
        state, _ = step(state, *map(jnp.asarray, _batch(16, 100 + i)))
    return net, state


STEPS = 2


@pytest.mark.parametrize("aux", [False, True], ids=["plain", "aux_value"])
def test_dp2_train_step_matches_jax(tmp_path, aux):
    """Two float32 steps on two ranks (dp=2, BatchNorm over the global
    batch) against JAX's step on a dp=2 mesh of the global batch of 32:
    parameters, running statistics, momentum and loss terms within rtol
    1e-4, atol 1e-6 (tests/test_parallel.py's bound); both ranks hold the
    same bits. The auxiliary case draws one row subset for all ranks."""
    cfg = JaxModelConfig(**SMALL)
    net, state = _jax_start(cfg)
    save_checkpoint(str(tmp_path / "start"),
                    serialization.to_state_dict(jax.device_get(state)), 0.0)
    jmesh_cfg = JaxMeshConfig(data_parallelism=2, model_parallelism=1)
    jmesh = jax_mesh.make_mesh(jmesh_cfg, jax.devices()[:2])
    aux_kwargs = (dict(aux_value_weight=0.25, aux_value_batch=12)
                  if aux else {})
    step = jax.jit(jax_train.make_train_step(net, cfg, **aux_kwargs))
    state = state.replace(params=jax_mesh.shard_params(
        state.params, jmesh, jmesh_cfg))
    inputs = {}
    aux_obs, _, aux_z = _batch(40, 8)
    inputs.update(aux_obs=aux_obs, aux_z=aux_z)
    want_terms = []
    for i in range(STEPS):
        obs, pi, z = _batch(32, 200 + i)
        inputs.update({f"o{i}": obs, f"p{i}": pi, f"z{i}": z})
        rows = [jax_mesh.shard_batch(jnp.asarray(x), jmesh, jmesh_cfg)
                for x in (obs, pi, z)]
        extra = ()
        if aux:
            key = jax.random.PRNGKey(50 + i)
            inputs[f"aux_idx{i}"] = np.asarray(
                jax.random.randint(key, (12,), 0, 40))
            extra = (key, jnp.asarray(aux_obs), jnp.asarray(aux_z))
        state, m = step(state, *rows, *extra)
        want_terms.append([float(m.loss), float(m.policy_loss),
                           float(m.value_loss), float(m.l2),
                           float(m.solver_value_loss)])
    _launch("train", tmp_path, {
        "mesh": {"data_parallelism": 2}, "model": SMALL, "steps": STEPS,
        "aux": aux_kwargs}, inputs)
    want = serialization.to_state_dict(jax.device_get(state))
    got = [load_checkpoint(str(tmp_path / f"out{r}"))[0] for r in (0, 1)]
    assert _flat(got[0]).keys() == _flat(got[1]).keys()
    for key, value in _flat(got[0]).items():
        assert np.array_equal(value, _flat(got[1])[key]), key
    for part in ("params", "batch_stats", "opt_state"):
        _assert_close(got[0][part], want[part], 1e-4, 1e-6)
    assert int(got[0]["steps"]) == int(want["steps"]) == 2 + STEPS
    terms = [json.load(open(tmp_path / f"terms{r}.json")) for r in (0, 1)]
    assert terms[0] == terms[1]
    np.testing.assert_allclose(terms[0], want_terms, rtol=1e-4, atol=1e-6)
    if aux:
        assert all(t[4] > 0 for t in terms[0])


def test_mp2_forward_and_step_match_jax(tmp_path):
    """mp=2: the value head's hidden Dense column-sharded over two ranks
    (its 16 columns; the policy Dense's 7 and the final Dense(1) stay
    whole). The forward against JAX's tp-sharded forward within rtol 1e-4,
    atol 1e-5 (tests/test_parallel.py); two train steps against JAX's on a
    (1, 2) mesh within rtol 1e-4, atol 1e-6."""
    cfg = JaxModelConfig(**SMALL)
    net, state = _jax_start(cfg)
    save_checkpoint(str(tmp_path / "start"),
                    serialization.to_state_dict(jax.device_get(state)), 0.0)
    fwd_obs = np.random.default_rng(1).random((32,) + OBS_SHAPE).astype(
        np.float32)
    tp_cfg = JaxMeshConfig(data_parallelism=4, model_parallelism=2)
    tp = jax_mesh.make_mesh(tp_cfg, jax.devices())
    f = jax.jit(lambda v, o: net.apply(v, o, train=False))
    sharded_vars = {"params": jax_mesh.shard_params(state.params, tp, tp_cfg),
                    "batch_stats": state.batch_stats}
    specs = [str(leaf.sharding.spec)
             for leaf in jax.tree.leaves(sharded_vars["params"])
             if leaf.ndim == 2 and "model" in str(leaf.sharding.spec)]
    assert len(specs) == 1  # Dense_1 only
    want_logits, want_value = jax.device_get(f(
        sharded_vars, jax_mesh.shard_batch(jnp.asarray(fwd_obs), tp,
                                           tp_cfg)))

    mp_cfg = JaxMeshConfig(data_parallelism=1, model_parallelism=2)
    mp = jax_mesh.make_mesh(mp_cfg, jax.devices()[:2])
    step = jax.jit(jax_train.make_train_step(net, cfg))
    state = state.replace(params=jax_mesh.shard_params(state.params, mp,
                                                       mp_cfg))
    inputs = {"fwd_obs": fwd_obs}
    want_terms = []
    for i in range(STEPS):
        obs, pi, z = _batch(16, 300 + i)
        inputs.update({f"o{i}": obs, f"p{i}": pi, f"z{i}": z})
        state, m = step(state, jnp.asarray(obs), jnp.asarray(pi),
                        jnp.asarray(z))
        want_terms.append([float(m.loss), float(m.policy_loss),
                           float(m.value_loss), float(m.l2), 0.0])
    _launch("mp", tmp_path, {
        "mesh": {"data_parallelism": 1, "model_parallelism": 2},
        "model": SMALL, "steps": STEPS, "aux": {}}, inputs)
    for r in (0, 1):
        got = np.load(tmp_path / f"fwd{r}.npz")
        np.testing.assert_allclose(got["logits"], want_logits, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["value"], want_value, rtol=1e-4,
                                   atol=1e-5)
    want = serialization.to_state_dict(jax.device_get(state))
    got = load_checkpoint(str(tmp_path / "out0"))[0]
    for part in ("params", "batch_stats", "opt_state"):
        _assert_close(got[part], want[part], 1e-4, 1e-6)
    terms = json.load(open(tmp_path / "terms0.json"))
    np.testing.assert_allclose(terms, want_terms, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Replay rings, generation stats and the checkpoint layout
# ---------------------------------------------------------------------------

def _rows(n, seed):
    """A generation batch of n rows (Connect-4 planes, some rows invalid)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 3, size=(n, 6, 7))
    obs = np.zeros((n, 6, 7, 4), np.float32)
    for c in range(3):
        obs[..., c] = cells == c
    obs[..., 3] = rng.integers(0, 2, size=(n, 1, 1))
    policy = rng.random((n, A)).astype(np.float32)
    policy /= policy.sum(-1, keepdims=True)
    value = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    valid = rng.random(n) < 0.8
    return obs, policy, value, valid


def test_sharded_replay_stats_and_checkpoint_match_jax(tmp_path):
    """Two ranks, each adding its half of three shard-contiguous batches to
    a packed ring of 2 x 24 rows (it wraps): the gathered ring is byte-equal
    to JAX's ``make_sharded_replay_ops`` add on a dp=2 mesh (rows, ``head``
    (2,), ``size`` (2,)); each rank samples from its own ring; JAX's
    fetched ring restores on the port's two ranks; the port's checkpoint of
    its ring restores through JAX's ``load_checkpoint`` with JAX's dp=2
    template; the reduced generation stats equal JAX's psum reduction of
    the same per-shard stats, bit for bit."""
    capacity, adds, n = 48, 3, 40
    env = JaxConnectN(JaxConnectNConfig())
    codec = jax_codec.codec_for_env(env)
    jmesh = jax_mesh.make_mesh(JaxMeshConfig(data_parallelism=2),
                               jax.devices()[:2])
    ring = jax_sharded.sharded_replay_init(capacity, env.obs_shape, A, jmesh,
                                           codec=codec)
    add, _ = jax_sharded.make_sharded_replay_ops(jmesh, 8, codec=codec)
    inputs = {}
    for i in range(adds):
        obs, policy, value, valid = _rows(n, 10 + i)
        inputs.update({f"obs{i}": obs, f"policy{i}": policy,
                       f"value{i}": value, f"valid{i}": valid})
        batch = JaxBatch(obs=jnp.asarray(obs), policy=jnp.asarray(policy),
                         value=jnp.asarray(value), valid=jnp.asarray(valid))
        ring = jax.jit(add)(ring, jax.tree.map(
            lambda x: jax.device_put(x, jax.sharding.NamedSharding(
                jmesh, jax.sharding.PartitionSpec("data"))), batch))
    jax_ring = serialization.to_state_dict(jax_sharded.fetch(ring))
    save_checkpoint(str(tmp_path / "jax_ring"),
                    {"steps": np.array(0, np.int32)}, 0.0, jax_ring)
    # Per-shard generation stats, reduced by JAX's sharded generate.
    table = dict(games=np.array([5, 3], np.int32),
                 plies=np.array([61, 40], np.int32),
                 w1=np.array([2, 1], np.int32), w2=np.array([1, 2], np.int32),
                 draws=np.array([2, 0], np.int32),
                 mean=np.array([12.2, 13.333333], np.float32))
    inputs.update(table)

    def fake_selfplay(evaluate, key, games):
        d = jax.lax.axis_index("data")
        return (jnp.zeros((games,)), JaxStats(
            *(jnp.asarray(table[k])[d] for k in (
                "games", "plies", "w1", "w2", "draws", "mean"))))

    generate = jax.jit(jax_sharded.make_sharded_generate(
        fake_selfplay, lambda p, s, o: None, jmesh, 8))
    want_stats = [x.item() for x in jax.device_get(
        generate({}, {}, jax.random.PRNGKey(0))[1])]

    _launch("replay", tmp_path, {"mesh": {"data_parallelism": 2},
                                 "capacity": capacity, "batch": 8,
                                 "adds": adds}, inputs)
    got = load_replay(str(tmp_path / "port_ring"))
    assert _flat(got).keys() == _flat(jax_ring).keys()
    for key, want in _flat(jax_ring).items():
        assert got_bytes(_flat(got)[key]) == got_bytes(want), key
    assert np.asarray(got["head"]).shape == (2,)
    assert np.asarray(got["size"]).shape == (2,)
    for r in (0, 1):
        out = json.load(open(tmp_path / f"replay{r}.json"))
        assert out["own"] and out["restored"], (r, out)
        assert out["stats"] == want_stats
        assert out["total"] == int(jax_sharded.replay_total_size(ring))
        assert out["min"] == int(jax_sharded.replay_min_shard_size(ring))
    # The port's checkpoint through JAX's reader and dp=2 template.
    from custom_alphazero_tpu.io.checkpoint import (
        load_checkpoint as jax_load_checkpoint,
    )

    template = jax_sharded.sharded_replay_init(capacity, env.obs_shape, A,
                                               jmesh, codec=codec)
    _, meta, restored = jax_load_checkpoint(
        str(tmp_path / "port_ring"), {"steps": np.int32(0)},
        jax.device_get(template))
    assert meta["steps"] == 0
    for key, want in _flat(jax_ring).items():
        value = _flat(serialization.to_state_dict(restored))[key]
        assert got_bytes(value) == got_bytes(want), key


def got_bytes(x):
    x = np.asarray(x)
    return x.shape, x.dtype.itemsize, x.tobytes()


def test_replay_restore_refuses_another_dp():
    """A ring written at another data parallelism raises (JAX's template
    restore has no such check: a deliberate divergence)."""
    from custom_alphazero_tpu_torch.replay.buffer import (
        replay_from_state_dict,
    )

    tree = {"obs": np.zeros((4, 6, 7, 4), np.float32),
            "policy": np.zeros((4, 7), np.float32),
            "value": np.zeros(4, np.float32),
            "head": np.zeros(2, np.int32), "size": np.array([1, 2], np.int32)}
    with pytest.raises(ValueError, match="written by 2 data shard"):
        replay_from_state_dict(tree, "cpu")
    back = replay_from_state_dict(tree, "cpu", (1, 2))
    assert int(back.size) == 2 and back.capacity == 2
    with pytest.raises(ValueError, match="data parallelism 4"):
        replay_from_state_dict(tree, "cpu", (0, 4))
    tree.update(head=np.int32(0), size=np.int32(3))
    with pytest.raises(ValueError, match="written by 1 data shard"):
        replay_from_state_dict(tree, "cpu", (0, 2))
