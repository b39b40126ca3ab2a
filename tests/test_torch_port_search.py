"""The port's fused search against JAX, bit for bit.

- ``wave_reference`` (the plain PyTorch version of the CUDA wave kernel)
  against the JAX Pallas wave kernel run in interpret mode: all 12 carry
  arrays and the leaf board after every wave.
- ``FusedConnectNSearchV2.search_root_stats`` against JAX's fused and
  general searches: root visits and value sums, with noise off and with
  JAX's per-wave Gamma draws injected.

Evaluators are dyadic (every float the programs compute independently is
exactly representable), as in tests/test_fused_mcts.py, so the comparisons
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dyadic_evaluate as torch_dyadic
from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.ops import fused_mcts_v2 as jax_fused
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN, ConnectNState
from custom_alphazero_tpu_torch.ops import fused_mcts_v2
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
    FusedConnectNSearchV2,
    supports,
)


def _random_midgame_states(env, rng, batch, plies):
    states = jax.vmap(lambda _: env.init())(jnp.arange(batch))
    for _ in range(plies):
        rng, k = jax.random.split(rng)
        legal = jax.vmap(env.legal_mask)(states)
        actions = jax.random.categorical(
            k, jnp.where(legal, 0.0, -jnp.inf), axis=-1
        )
        states, _ = jax.vmap(env.step)(states, actions)
    return states


def _to_torch(jstates) -> ConnectNState:
    return ConnectNState(
        *(torch.from_numpy(np.array(getattr(jstates, f)))
          for f in ("board", "heights", "fullmove", "terminal", "won"))
    )


def _jax_dyadic(num_actions):
    def evaluate(obs):
        stones = jnp.sum(obs[..., 1] + obs[..., 2], axis=(1, 2))
        a = jnp.arange(num_actions, dtype=jnp.float32)[None, :]
        return (1.0 + jnp.mod(stones[:, None] + a, 4.0)) / 16.0, stones / 64.0

    return evaluate


def jax_wave_gammas(jenv, jcfg, rng, batch, sims):
    """JAX's per-wave root noise of a search with key ``rng``: the (S, B, A)
    draws its fused and general paths consume."""
    _, k_plan = jax.random.split(rng)
    mcts = JaxMCTS(jenv, jcfg)
    return torch.from_numpy(np.stack([
        np.asarray(mcts.wave_noise(k_plan, w, batch)) for w in range(sims)
    ]))


def _pair(geometry, **mcts):
    jenv = JaxConnectN(JaxConnectNConfig(**geometry))
    env = ConnectN(ConnectNConfig(**geometry))
    return jenv, env, JaxMCTSConfig(**mcts), MCTSConfig(**mcts)


@pytest.mark.parametrize("use_dirichlet", [False, True])
def test_wave_reference_matches_pallas_kernel(use_dirichlet):
    """Every carry array and the leaf board after every wave."""
    jenv, env, jcfg, cfg = _pair({}, simulations=12,
                                 use_dirichlet=use_dirichlet,
                                 dirichlet_alpha=1.0)
    batch, sims = 8, 12
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(1), batch, 8)
    states = _to_torch(jstates)
    search = FusedConnectNSearchV2(env, cfg, device="cpu")
    geom = search.geometry(sims)
    call = jax.jit(jax_fused.FusedConnectNSearchV2(
        jenv, jcfg, block_games=8
    )._kernel_call(sims + 1, batch, sims))
    gamma = jax_wave_gammas(jenv, jcfg, jax.random.PRNGKey(2), batch, sims)

    root_board = fused_mcts_v2.padded_board(states.board)
    carry = fused_mcts_v2.init_carry(env, states, sims + 1)
    jcarry = [jnp.asarray(t.numpy()) for t in carry]
    root_live = ~states.terminal
    evaluate = torch_dyadic(env.num_actions)
    leaf_board = torch.zeros((batch, 64))
    probs = torch.zeros((batch, env.num_actions))
    value = torch.zeros((batch, 1))
    root_prior = torch.zeros_like(probs)
    for w in range(sims + 1):
        gamma_w = gamma[w] if use_dirichlet and w < sims else None
        renormed, mixed, root_prior = search.wave_inputs(
            w, sims, leaf_board, carry.leaf_terminal, probs, root_prior,
            root_live, gamma_w,
        )
        outs = call(jnp.full((1,), w, jnp.int32), jnp.asarray(mixed.numpy()),
                    jnp.asarray(renormed.numpy()), jnp.asarray(value.numpy()),
                    jnp.asarray(root_board.numpy()), *jcarry)
        carry, leaf_board = fused_mcts_v2.wave_reference(
            w, mixed, renormed, value, root_board, carry, geom
        )
        for name, got, want in zip(carry._fields + ("leaf_board",),
                                   list(carry) + [leaf_board], outs):
            np.testing.assert_array_equal(
                got.numpy().view(np.int32), np.asarray(want).view(np.int32),
                err_msg=f"wave {w}: {name}",
            )
        jcarry = list(outs[:12])
        probs, v = evaluate(fused_mcts_v2.observe_board(leaf_board, 6, 7))
        value = v[:, None]


@pytest.mark.parametrize("use_dirichlet", [False, True])
@pytest.mark.parametrize("plies", [0, 6, 20])
def test_search_matches_jax_fused_and_general(use_dirichlet, plies):
    jenv, env, jcfg, cfg = _pair({}, simulations=24,
                                 use_dirichlet=use_dirichlet)
    batch, sims = 16, 24
    jstates = _random_midgame_states(
        jenv, jax.random.PRNGKey(3 + plies), batch, plies
    )
    rng = jax.random.PRNGKey(7)
    jeval = _jax_dyadic(jenv.num_actions)
    mcts = JaxMCTS(jenv, jcfg)
    tree = jax.jit(lambda s, r: mcts.search(s, jeval, r, sims))(jstates, rng)
    jfused = jax_fused.FusedConnectNSearchV2(jenv, jcfg, block_games=8)
    fused_visits, fused_wsum = jax.jit(
        lambda s, r: jfused.search_root_stats(s, jeval, r, sims)
    )(jstates, rng)

    gamma = (jax_wave_gammas(jenv, jcfg, rng, batch, sims)
             if use_dirichlet else None)
    search = FusedConnectNSearchV2(env, cfg, device="cpu")
    visits, wsum = search.search_root_stats(
        _to_torch(jstates), torch_dyadic(env.num_actions), None, sims,
        gamma=gamma,
    )
    for ref_visits, ref_wsum in (
        (mcts.root_child_visits(tree), mcts.root_child_value_sums(tree)),
        (fused_visits, fused_wsum),
    ):
        np.testing.assert_array_equal(visits.numpy(), np.asarray(ref_visits))
        np.testing.assert_array_equal(wsum.numpy(), np.asarray(ref_wsum))


def test_search_variant_geometry():
    """5x4 connect-3: padded-window win detection and action space."""
    geometry = dict(width=5, height=4, n=3)
    jenv, env, jcfg, cfg = _pair(geometry, simulations=20)
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(2), 16, 5)
    rng = jax.random.PRNGKey(4)
    jeval = _jax_dyadic(jenv.num_actions)
    mcts = JaxMCTS(jenv, jcfg)
    tree = jax.jit(lambda s, r: mcts.search(s, jeval, r, 20))(jstates, rng)
    visits, wsum = FusedConnectNSearchV2(env, cfg, device="cpu") \
        .search_root_stats(_to_torch(jstates), torch_dyadic(5), None, 20)
    np.testing.assert_array_equal(visits.numpy(),
                                  np.asarray(mcts.root_child_visits(tree)))
    np.testing.assert_array_equal(
        wsum.numpy(), np.asarray(mcts.root_child_value_sums(tree))
    )


def test_search_terminal_root():
    """A terminal root gets zero visits, as in JAX."""
    jenv, env, jcfg, cfg = _pair({}, simulations=8)
    state = jenv.init()
    for a in (0, 1, 0, 1, 0, 1, 0):
        state, _ = jenv.step(state, jnp.int32(a))
    jstates = jax.tree.map(lambda x: jnp.stack([x] * 4), state)
    mcts = JaxMCTS(jenv, jcfg)
    tree = jax.jit(
        lambda s, r: mcts.search(s, _jax_dyadic(7), r, 8)
    )(jstates, jax.random.PRNGKey(0))
    visits, _ = FusedConnectNSearchV2(env, cfg, device="cpu") \
        .search_root_stats(_to_torch(jstates), torch_dyadic(7), None, 8)
    np.testing.assert_array_equal(visits.numpy(),
                                  np.asarray(mcts.root_child_visits(tree)))
    np.testing.assert_array_equal(visits.numpy(), 0)


def test_search_visit_conservation():
    """After k simulations the root's children hold k-1 visits (the first
    simulation only expands the root), with root noise on."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=32, use_dirichlet=True, dirichlet_alpha=1.0)
    search = FusedConnectNSearchV2(env, cfg, device="cpu")
    visits, _ = search.search_root_stats(
        env.init(8, device="cpu"), torch_dyadic(7),
        torch.Generator().manual_seed(0), 32,
    )
    np.testing.assert_array_equal(visits.sum(-1).numpy(), 31)


def test_supports_and_rejects():
    env = ConnectN(ConnectNConfig())
    assert supports(env, MCTSConfig())
    assert not supports(env, MCTSConfig(max_nodes=64))
    flat = ConnectN(ConnectNConfig(gravity=False))
    assert not supports(flat, MCTSConfig())
    with pytest.raises(ValueError):
        FusedConnectNSearchV2(flat, MCTSConfig(), device="cpu")


def test_wave_rejects_non_cuda_accelerators():
    """CPU tensors take the plain version; other devices raise."""
    env = ConnectN(ConnectNConfig())
    states = env.init(2, device="meta")
    carry = fused_mcts_v2.init_carry(env, states, 3)
    geom = fused_mcts_v2.WaveGeometry(6, 7, 4, 1.5, 2)
    buffers = fused_mcts_v2.new_buffers(2, 7, geom, False, "meta")
    with pytest.raises(ValueError, match="no wave kernel"):
        fused_mcts_v2.wave_step(buffers, carry, geom)
