"""The port's self-play generation against JAX's, byte for byte: the fused
path in plain and continuous mode, and the general-search path.

Moves are made deterministic with ``greedy_from_move=0`` and no root noise
(torch cannot replay JAX's sampling stream). The dyadic evaluator also
depends on the game's row, so the games of a batch differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.runtime.selfplay import (
    make_selfplay_fn as jax_make_selfplay_fn,
)
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn


def _jax_row_dyadic(num_actions):
    def evaluate(obs):
        stones = jnp.sum(obs[..., 1] + obs[..., 2], axis=(1, 2))
        row = jnp.arange(obs.shape[0], dtype=jnp.float32)[:, None]
        a = jnp.arange(num_actions, dtype=jnp.float32)[None, :]
        probs = (1.0 + jnp.mod(stones[:, None] + a + row, 4.0)) / 16.0
        return probs, (stones - 2.0 * jnp.mod(row[:, 0], 3.0)) / 64.0

    return evaluate


def _torch_row_dyadic(num_actions):
    def evaluate(obs):
        stones = (obs[..., 1] + obs[..., 2]).sum(dim=(1, 2))
        row = torch.arange(obs.shape[0], dtype=torch.float32)[:, None]
        a = torch.arange(num_actions, dtype=torch.float32)[None, :]
        probs = (1.0 + torch.remainder(stones[:, None] + a + row, 4.0)) / 16.0
        return probs, (stones - 2.0 * torch.remainder(row[:, 0], 3.0)) / 64.0

    return evaluate


def _assert_matches_jax(mcts, sp, fused, batch=8, max_plies=20):
    """Port and JAX self-play at 5x4 connect-3: equal sample bytes and
    stats. ``fused`` is passed to both (None lets each choose)."""
    jenv = JaxConnectN(JaxConnectNConfig(width=5, height=4, n=3))
    jgen = jax_make_selfplay_fn(jenv, JaxMCTSConfig(**mcts),
                                JaxSelfPlayConfig(**sp), max_plies,
                                fused=fused)
    ref_batch, ref_stats = jax.jit(
        lambda r: jgen(_jax_row_dyadic(5), r, batch)
    )(jax.random.PRNGKey(0))

    env = ConnectN(ConnectNConfig(width=5, height=4, n=3))
    gen = make_selfplay_fn(env, MCTSConfig(**mcts), SelfPlayConfig(**sp),
                           max_plies, device="cpu", fused=fused)
    got_batch, got_stats = gen(_torch_row_dyadic(5),
                               torch.Generator().manual_seed(0), batch)

    for name, got, want in zip(got_batch._fields, got_batch, ref_batch):
        want = np.asarray(want)
        got = got.numpy()
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        assert got.tobytes() == want.tobytes(), name
    for name, got, want in zip(got_stats._fields, got_stats, ref_stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert int(got_stats.games) > 0
    assert len(set(map(tuple, got_batch.policy[:batch].tolist()))) > 1


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["plain", "continuous"])
def test_selfplay_matches_jax(continuous):
    _assert_matches_jax(
        dict(simulations=10, greedy_from_move=0),
        dict(continuous=continuous, discount=0.5,
             exclude_draws=not continuous),
        fused=True,
    )


def test_selfplay_samples_noise_on():
    """Continuous generation with root noise and sampled moves (no JAX
    counterpart for torch's stream): well-formed samples."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=8, greedy_from_move=4, use_dirichlet=True,
                     dirichlet_alpha=1.0)
    gen = make_selfplay_fn(env, cfg, SelfPlayConfig(continuous=True,
                                                    exclude_draws=False),
                           24, device="cpu")
    samples, stats = gen(_torch_row_dyadic(7),
                         torch.Generator().manual_seed(1), 6)
    assert samples.obs.shape == (24 * 6, 6, 7, 4)
    torch.testing.assert_close(samples.policy.sum(-1),
                               torch.ones(24 * 6))
    assert set(samples.value[samples.valid].tolist()) <= {-1.0, 0.0, 1.0}
    assert int(stats.games) == int(stats.wins_first_mover
                                   + stats.wins_second_mover + stats.draws)
    assert int(stats.plies) == 24 * 6


@pytest.mark.parametrize("override, item", [
    (dict(reuse_tree=True), "Subtree reuse"),
    (dict(use_gumbel=True), "Gumbel search"),
    (dict(max_nodes=64), "General search path"),
])
def test_unported_modes_raise(override, item):
    """Every mode is ported now. Subtree reuse and the general search path
    (a config that the fused search rejects, max_nodes > 0) run and match
    JAX's self-play (tests/test_torch_port_reuse.py holds reuse further).
    Gumbel search is ported (tests/test_torch_port_gumbel.py holds it to
    JAX): it builds, and refuses the fused kernel."""
    if item in ("General search path", "Subtree reuse"):
        _assert_matches_jax(dict(simulations=8, greedy_from_move=0,
                                 **override),
                            dict(continuous=True, exclude_draws=False),
                            fused=None, batch=6, max_plies=14)
        return
    env = ConnectN(ConnectNConfig())
    if item == "Gumbel search":
        make_selfplay_fn(env, MCTSConfig(**override), SelfPlayConfig(), 4,
                         device="cpu")
        with pytest.raises(ValueError, match="no fused kernel"):
            make_selfplay_fn(env, MCTSConfig(**override), SelfPlayConfig(),
                             4, device="cpu", fused=True)
        return
    raise AssertionError(f"unknown mode {item}")


def test_non_fused_request_raises():
    """``fused=False`` no longer raises: it runs the general search and
    matches JAX's ``make_selfplay_fn(fused=False)``."""
    _assert_matches_jax(dict(simulations=8, greedy_from_move=0),
                        dict(continuous=False, discount=0.5,
                             exclude_draws=True),
                        fused=False, batch=6, max_plies=14)


def test_general_and_fused_selfplay_agree():
    """The port's general and fused self-play from one generator seed, with
    root noise and sampled moves: byte-equal samples and equal stats."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=12, greedy_from_move=4, use_dirichlet=True,
                     dirichlet_alpha=1.0)
    sp = SelfPlayConfig(exclude_draws=True)
    outs = []
    for fused in (False, True):
        gen = make_selfplay_fn(env, cfg, sp, 12, device="cpu", fused=fused)
        outs.append(gen(_torch_row_dyadic(7),
                        torch.Generator().manual_seed(11), 8))
    (ref_batch, ref_stats), (got_batch, got_stats) = outs
    for name, got, want in zip(got_batch._fields, got_batch, ref_batch):
        assert got.numpy().tobytes() == want.numpy().tobytes(), name
    for name, got, want in zip(got_stats._fields, got_stats, ref_stats):
        assert torch.equal(got, want), name
    assert len(set(map(tuple, got_batch.policy[:8].tolist()))) > 1
