"""The port's replay codecs and ring against the JAX package's, byte for
byte, on inputs made from a numpy seed; and packed self-play generation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.replay import buffer as jax_buffer
from custom_alphazero_tpu.replay import codec as jax_codec
from custom_alphazero_tpu.runtime.selfplay import SelfPlayBatch as JaxBatch
from custom_alphazero_tpu.runtime.selfplay import (
    make_selfplay_fn as jax_make_selfplay_fn,
)
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.replay.buffer import (
    replay_add,
    replay_from_state_dict,
    replay_gather,
    replay_init,
    replay_sample,
    replay_sample_indices,
    replay_state_dict,
)
from custom_alphazero_tpu_torch.replay.codec import (
    BitplaneCodec,
    PackedObs,
    TopKPolicyCodec,
    codec_for_env,
)
from custom_alphazero_tpu_torch.runtime.selfplay import (
    SelfPlayBatch,
    make_selfplay_fn,
)

ENV = ConnectN(ConnectNConfig())
JENV = JaxConnectN(JaxConnectNConfig())
A = ENV.num_actions


def _connect4_obs(n, seed):
    """Random Connect-4 observations: one-hot board planes + a turn plane."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 3, size=(n, 6, 7))
    obs = np.zeros((n, 6, 7, 4), np.float32)
    for c in range(3):
        obs[..., c] = cells == c
    obs[..., 3] = rng.integers(0, 2, size=(n, 1, 1))
    return obs


def _same_bytes(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert got.dtype.itemsize == want.dtype.itemsize
    assert got.tobytes() == want.tobytes()


TOPK_RTOL = 3e-7  # top-K values: the renormalising sum's order differs

CODEC_CASES = {
    # Connect-4: all four planes binary, 168 bits -> 6 words (8 spare bits).
    "connect4": ((6, 7, 4), (0, 1, 2, 3), ()),
    # 5 x 4 x 37, all binary: 740 bits, not a multiple of 32.
    "all_binary_740_bits": ((5, 4, 37), tuple(range(37)), ()),
    # Mixed: scalar channels in the middle and at the end; bit 31 gets set.
    "scalars": ((4, 4, 6), (0, 2, 3, 5), (1, 4)),
}


@pytest.mark.parametrize("case", CODEC_CASES)
def test_bitplane_codec_bytes_equal_jax(case):
    shape, binary, scalars = CODEC_CASES[case]
    rng = np.random.default_rng(1)
    if case == "connect4":
        obs = _connect4_obs(64, 1)
    else:
        obs = (rng.random((2, 9) + shape) > 0.4).astype(np.float32)
        obs[0, 0] = 1.0  # every bit set: words are 0xFFFFFFFF
        for ch in scalars:
            obs[..., ch] = rng.normal(size=(2, 9, 1, 1))
    ref_codec = jax_codec.BitplaneCodec(shape, binary, scalars)
    codec = BitplaneCodec(shape, binary, scalars)
    assert (codec.n_bits, codec.n_words, codec.n_scalars) == (
        ref_codec.n_bits, ref_codec.n_words, ref_codec.n_scalars)
    want = ref_codec.encode(jnp.asarray(obs))
    got = codec.encode(torch.from_numpy(obs))
    assert got.words.dtype == torch.int32
    _same_bytes(got.words, want.words)
    _same_bytes(got.scalars, want.scalars)
    # Decode is exact, from the port's words and from JAX's.
    decoded = codec.decode(got)
    assert decoded.dtype == torch.float32
    np.testing.assert_array_equal(decoded.numpy(), obs)
    from_jax = PackedObs(
        torch.from_numpy(np.asarray(want.words).view(np.int32).copy()),
        torch.from_numpy(np.asarray(want.scalars).copy()))
    np.testing.assert_array_equal(codec.decode(from_jax).numpy(),
                                  np.asarray(ref_codec.decode(want)))
    zeros = codec.packed_zeros((3,), "cpu")
    assert zeros.words.shape == (3, codec.n_words)
    assert zeros.scalars.shape == (3, codec.n_scalars)


def test_bitplane_codec_rejects_bad_partition():
    with pytest.raises(ValueError, match="partition"):
        BitplaneCodec((2, 2, 3), (0, 1), ())


def test_codec_for_env():
    codec = codec_for_env(ENV)
    ref = jax_codec.codec_for_env(JENV)
    assert codec.obs_shape == tuple(ref.obs_shape) == (6, 7, 4)
    assert codec.binary_channels == ref.binary_channels == (0, 1, 2, 3)
    assert codec.scalar_channels == ref.scalar_channels == ()
    assert codec.n_words == 6

    class WithScalars:
        obs_shape = (8, 8, 5)
        obs_scalar_channels = (3, 4)

    codec = codec_for_env(WithScalars())
    assert codec.binary_channels == (0, 1, 2)
    assert codec.scalar_channels == (3, 4)


@pytest.mark.parametrize("k", [3, 7])
def test_topk_policy_codec_matches_jax_with_ties(k):
    rng = np.random.default_rng(2)
    policy = rng.random((12, 7)).astype(np.float32)
    policy[0] = 1.0 / 7                      # all tied
    policy[1] = [0.2, 0.3, 0.3, 0.0, 0.2, 0.0, 0.0]  # ties at the cut
    policy[2] = 0.0                          # empty row: total clamps
    policy[3] = [0, 0, 1, 0, 0, 0, 0]        # one-hot: zero-valued padding
    policy[4:] /= policy[4:].sum(-1, keepdims=True)
    ref_codec = jax_codec.TopKPolicyCodec(7, k)
    codec = TopKPolicyCodec(7, k)
    want = ref_codec.encode(jnp.asarray(policy))
    got = codec.encode(torch.from_numpy(policy))
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    # The row total is summed in another order than XLA's: one ulp.
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=TOPK_RTOL, atol=0)
    np.testing.assert_allclose(codec.decode(got).numpy(),
                               np.asarray(ref_codec.decode(want)),
                               rtol=TOPK_RTOL, atol=0)
    with pytest.raises(ValueError):
        TopKPolicyCodec(7, 8)


def _batches(seed):
    """The same sequence of sample batches for both rings: partly valid,
    wrapping a capacity of 40, and one batch larger than the capacity."""
    rng = np.random.default_rng(seed)
    out = []
    for n, p_valid in ((24, 1.0), (10, 0.5), (30, 0.8), (100, 0.9), (7, 0.0),
                       (13, 1.0)):
        policy = rng.random((n, A)).astype(np.float32)
        policy[rng.random((n, A)) < 0.4] = 0.0
        policy /= np.maximum(policy.sum(-1, keepdims=True), 1e-9)
        out.append(dict(
            obs=_connect4_obs(n, int(rng.integers(1 << 30))),
            policy=policy,
            value=rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
            valid=rng.random(n) < p_valid,
        ))
    return out


def _leaves(ring):
    """The arrays of a ring (either package's), codec fields flattened."""
    out = []
    for field in (ring.obs, ring.policy, ring.value):
        out += list(field) if isinstance(field, tuple) else [field]
    return out


def _assert_rings_equal(ring, ref, topk=False):
    """Byte-equal arrays, ``head`` and ``size``; with the top-K policy codec
    the float arrays agree to ``TOPK_RTOL`` instead."""
    for got, want in zip(_leaves(ring.rows()), _leaves(ref), strict=True):
        if topk and got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOPK_RTOL, atol=0)
        else:
            _same_bytes(got, want)
    assert int(ring.head) == int(ref.head)
    assert int(ring.size) == int(ref.size)


@pytest.mark.parametrize("codecs", ["raw", "packed_obs", "packed_obs_topk"])
def test_ring_equals_jax_after_same_batches(codecs):
    capacity = 40
    ref_codec = jax_codec.codec_for_env(JENV) if codecs != "raw" else None
    codec = codec_for_env(ENV) if codecs != "raw" else None
    ref_pc = (jax_codec.TopKPolicyCodec(A, 4)
              if codecs == "packed_obs_topk" else None)
    pc = TopKPolicyCodec(A, 4) if codecs == "packed_obs_topk" else None
    ref = jax_buffer.replay_init(capacity, JENV.obs_shape, A, ref_codec,
                                 ref_pc)
    ring = replay_init(capacity, ENV.obs_shape, A, codec, pc, device="cpu")
    assert ring.capacity == capacity
    for fields in _batches(3):
        ref = jax_buffer.replay_add(
            ref, JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            ref_codec, ref_pc)
        ring = replay_add(
            ring,
            SelfPlayBatch(**{k: torch.from_numpy(v)
                             for k, v in fields.items()}),
            codec, pc)
        _assert_rings_equal(ring, ref, topk=pc is not None)
    assert int(ring.size) == capacity

    # Injected indices: the port's gather returns JAX's rows.
    idx = np.random.default_rng(4).permutation(capacity)[:16]
    ref_rows = (jax.tree.map(lambda a: a[idx], ref.obs),
                jax.tree.map(lambda a: a[idx], ref.policy), ref.value[idx])
    if ref_codec is not None:
        ref_rows = (ref_codec.decode(ref_rows[0]),) + ref_rows[1:]
    if ref_pc is not None:
        ref_rows = (ref_rows[0], ref_pc.decode(ref_rows[1]), ref_rows[2])
    got_rows = replay_gather(ring, torch.from_numpy(idx), codec, pc)
    for got, want in zip(got_rows, ref_rows):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0,
                                   rtol=TOPK_RTOL if pc is not None else 0)

    # The checkpoint's state dict holds JAX's arrays and comes back equal.
    tree = replay_state_dict(ring)
    if codecs != "raw":
        assert tree["obs"]["words"].dtype == np.uint32
        np.testing.assert_array_equal(tree["obs"]["words"],
                                      np.asarray(ref.obs.words))
    back = replay_from_state_dict(tree, device="cpu")
    _assert_rings_equal(back, ref, topk=pc is not None)


def test_ring_overflow_keeps_newest():
    """One add larger than the capacity keeps exactly its newest rows, as
    the JAX ring does."""
    cap, n = 8, 20
    fields = dict(obs=np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1),
                  policy=np.zeros((n, 3), np.float32),
                  value=np.arange(n, dtype=np.float32),
                  valid=np.ones((n,), bool))
    ref = jax_buffer.replay_add(
        jax_buffer.replay_init(cap, (1, 1, 1), 3),
        JaxBatch(**{k: jnp.asarray(v) for k, v in fields.items()}))
    ring = replay_add(
        replay_init(cap, (1, 1, 1), 3, device="cpu"),
        SelfPlayBatch(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    assert sorted(ring.rows().value.tolist()) == list(range(n - cap, n))
    _assert_rings_equal(ring, ref)


def test_ring_sampling_without_replacement():
    ring = replay_init(64, (1, 1, 1), 3, device="cpu")
    n = 24
    ring = replay_add(ring, SelfPlayBatch(
        obs=torch.arange(n, dtype=torch.float32).reshape(n, 1, 1, 1),
        policy=torch.full((n, 3), 1 / 3),
        value=torch.arange(n, dtype=torch.float32),
        valid=torch.ones(n, dtype=torch.bool)))
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        idx = replay_sample_indices(ring, gen, 16)
        assert len(set(idx.tolist())) == 16          # distinct
        assert int(idx.max()) < n and int(idx.min()) >= 0  # filled region
        seen.update(idx.tolist())
    assert seen == set(range(n))  # every filled row is reachable
    obs, pi, z = replay_sample(ring, gen, n)
    assert sorted(z.tolist()) == list(range(n))
    assert torch.equal(obs[:, 0, 0, 0], z)
    # The same generator state gives the same draw.
    a = replay_sample_indices(ring, torch.Generator().manual_seed(5), 8)
    b = replay_sample_indices(ring, torch.Generator().manual_seed(5), 8)
    assert torch.equal(a, b)


def test_replay_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replay_init(8, (1, 1, 1), 3)


def _torch_row_dyadic(obs):
    stones = (obs[..., 1] + obs[..., 2]).sum(dim=(1, 2))
    row = torch.arange(obs.shape[0], dtype=torch.float32)[:, None]
    a = torch.arange(A, dtype=torch.float32)[None, :]
    return ((1.0 + torch.remainder(stones[:, None] + a + row, 4.0)) / 16.0,
            stones / 64.0)


def _jax_row_dyadic(obs):
    stones = jnp.sum(obs[..., 1] + obs[..., 2], axis=(1, 2))
    row = jnp.arange(obs.shape[0], dtype=jnp.float32)[:, None]
    a = jnp.arange(A, dtype=jnp.float32)[None, :]
    return ((1.0 + jnp.mod(stones[:, None] + a + row, 4.0)) / 16.0,
            stones / 64.0)


def test_packed_generation_equals_raw_and_jax():
    """``make_selfplay_fn(obs_codec=...)`` at Connect-4 size: the packed
    batch decodes to the raw path's observations, its words are the bytes
    the JAX codec packs from the JAX generation (whose own packed mode
    cannot flatten Connect-4's empty scalars array), and ``replay_add``
    accepts it as it is."""
    mcts = dict(simulations=8, greedy_from_move=0)
    sp = dict(continuous=False, exclude_draws=False)
    codec = codec_for_env(ENV)
    raw_fn = make_selfplay_fn(ENV, MCTSConfig(**mcts), SelfPlayConfig(**sp),
                              10, device="cpu")
    packed_fn = make_selfplay_fn(ENV, MCTSConfig(**mcts),
                                 SelfPlayConfig(**sp), 10, device="cpu",
                                 obs_codec=codec)
    raw, _ = raw_fn(_torch_row_dyadic, torch.Generator().manual_seed(0), 6)
    packed, _ = packed_fn(_torch_row_dyadic,
                          torch.Generator().manual_seed(0), 6)
    assert isinstance(packed.obs, PackedObs)
    assert packed.obs.words.shape == (60, 6)
    assert torch.equal(codec.decode(packed.obs), raw.obs)
    for name in ("policy", "value", "valid"):
        assert torch.equal(getattr(packed, name), getattr(raw, name)), name

    ref_fn = jax_make_selfplay_fn(
        JENV, JaxMCTSConfig(**mcts), JaxSelfPlayConfig(**sp), 10,
        fused=False)
    ref, _ = jax.jit(lambda k: ref_fn(_jax_row_dyadic, k, 6))(
        jax.random.PRNGKey(0))
    _same_bytes(packed.obs.words,
                jax_codec.codec_for_env(JENV).encode(ref.obs).words)
    _same_bytes(packed.policy, ref.policy)

    ring = replay_init(64, ENV.obs_shape, A, codec, device="cpu")
    ring_packed = replay_add(ring, packed, codec)
    words = ring_packed.obs.words.clone()
    ring_raw = replay_add(
        replay_init(64, ENV.obs_shape, A, codec, device="cpu"), raw, codec)
    assert torch.equal(words[:64], ring_raw.obs.words[:64])
    assert int(ring_packed.size) == int(ring_raw.size) == 60
