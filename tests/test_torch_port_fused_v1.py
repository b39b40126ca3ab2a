"""The port's v1 fused search (kernel K2's layout) against JAX, bit for bit.

- ``fused_mcts.wave_reference`` (the plain PyTorch version of the CUDA
  kernel csrc/fused_mcts.cu) against JAX's v1 Pallas wave kernel run in
  interpret mode: all 12 carry arrays and the leaf board after every wave.
- ``FusedConnectNSearch.search_root_stats`` against JAX's v1 fused and
  general searches, and against the port's v2 search.

Evaluators are dyadic, so the comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dyadic_evaluate as torch_dyadic
from chip_smoke import random_positions
from custom_alphazero_tpu.ops import fused_mcts as jax_fused
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.ops import fused_mcts, fused_mcts_v2
from custom_alphazero_tpu_torch.ops.fused_mcts import FusedConnectNSearch
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from tests.test_torch_port_search import (
    _jax_dyadic,
    _pair,
    _random_midgame_states,
    _to_torch,
    jax_wave_gammas,
)

GEOMETRIES = [dict(width=7, height=6, n=4), dict(width=5, height=4, n=3)]
GEOMETRY_IDS = ["7x6n4", "5x4n3"]


@pytest.mark.parametrize("use_dirichlet", [False, True],
                         ids=["no-noise", "noise"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_wave_reference_matches_pallas_kernel(geometry, use_dirichlet):
    """Every carry array and the leaf board after every wave."""
    jenv, env, jcfg, cfg = _pair(geometry, simulations=12,
                                 use_dirichlet=use_dirichlet,
                                 dirichlet_alpha=1.0)
    batch, sims, a = 8, 12, env.num_actions
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(1), batch, 6)
    states = _to_torch(jstates)
    search = FusedConnectNSearch(env, cfg, device="cpu")
    geom = search.geometry(sims)
    call = jax.jit(jax_fused.FusedConnectNSearch(
        jenv, jcfg, block_games=8
    )._kernel_call(sims + 1, batch, sims))
    gamma = jax_wave_gammas(jenv, jcfg, jax.random.PRNGKey(2), batch, sims)

    root_board = fused_mcts_v2.padded_board(states.board).view(batch, 8, 8)
    carry = fused_mcts.init_carry(env, states, sims + 1)
    assert carry.prior.shape == (batch, (sims + 1) * a)
    jcarry = [jnp.asarray(t.numpy()) for t in carry]
    root_live = ~states.terminal
    evaluate = torch_dyadic(a)
    leaf_board = torch.zeros((batch, 8, 8))
    probs = torch.zeros((batch, a))
    value = torch.zeros((batch, 1))
    root_prior = torch.zeros_like(probs)
    for w in range(sims + 1):
        gamma_w = gamma[w] if use_dirichlet and w < sims else None
        renormed, mixed, root_prior = search.wave_inputs(
            w, sims, leaf_board.view(batch, 64), carry.leaf_terminal, probs,
            root_prior, root_live, gamma_w,
        )
        outs = call(jnp.full((1,), w, jnp.int32), jnp.asarray(mixed.numpy()),
                    jnp.asarray(renormed.numpy()), jnp.asarray(value.numpy()),
                    jnp.asarray(root_board.numpy()), *jcarry)
        carry, leaf_board = fused_mcts.wave_reference(
            w, mixed, renormed, value, root_board, carry, geom
        )
        for name, got, want in zip(carry._fields + ("leaf_board",),
                                   list(carry) + [leaf_board], outs):
            np.testing.assert_array_equal(
                got.numpy().view(np.int32), np.asarray(want).view(np.int32),
                err_msg=f"wave {w}: {name}",
            )
        jcarry = list(outs[:12])
        probs, v = evaluate(fused_mcts_v2.observe_board(
            leaf_board, geometry["height"], geometry["width"]))
        value = v[:, None]
    assert float(carry.node_count.min()) > 1


@pytest.mark.parametrize("use_dirichlet", [False, True],
                         ids=["no-noise", "noise"])
@pytest.mark.parametrize("plies", [0, 14])
def test_search_matches_jax_fused_and_general(use_dirichlet, plies):
    jenv, env, jcfg, cfg = _pair({}, simulations=24,
                                 use_dirichlet=use_dirichlet)
    batch, sims = 16, 24
    jstates = _random_midgame_states(
        jenv, jax.random.PRNGKey(11 + plies), batch, plies
    )
    rng = jax.random.PRNGKey(7)
    jeval = _jax_dyadic(jenv.num_actions)
    mcts = JaxMCTS(jenv, jcfg)
    tree = jax.jit(lambda s, r: mcts.search(s, jeval, r, sims))(jstates, rng)
    jfused = jax_fused.FusedConnectNSearch(jenv, jcfg, block_games=8)
    fused_visits, fused_wsum = jax.jit(
        lambda s, r: jfused.search_root_stats(s, jeval, r, sims)
    )(jstates, rng)

    gamma = (jax_wave_gammas(jenv, jcfg, rng, batch, sims)
             if use_dirichlet else None)
    visits, wsum = FusedConnectNSearch(env, cfg, device="cpu") \
        .search_root_stats(_to_torch(jstates), torch_dyadic(7), None, sims,
                           gamma=gamma)
    for ref_visits, ref_wsum in (
        (mcts.root_child_visits(tree), mcts.root_child_value_sums(tree)),
        (fused_visits, fused_wsum),
    ):
        np.testing.assert_array_equal(visits.numpy(), np.asarray(ref_visits))
        np.testing.assert_array_equal(wsum.numpy().view(np.int32),
                                      np.asarray(ref_wsum).view(np.int32))


def test_search_visit_conservation():
    """After k simulations the root's children hold k-1 visits (the first
    simulation only expands the root), with root noise on."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=32, use_dirichlet=True, dirichlet_alpha=1.0)
    visits, _ = FusedConnectNSearch(env, cfg, device="cpu").search_root_stats(
        env.init(8, device="cpu"), torch_dyadic(7),
        torch.Generator().manual_seed(0), 32,
    )
    np.testing.assert_array_equal(visits.sum(-1).numpy(), 31)


def test_search_terminal_root():
    """A terminal root gets zero visits, as in JAX."""
    jenv, env, jcfg, cfg = _pair({}, simulations=8)
    state = jenv.init()
    for a in (0, 1, 0, 1, 0, 1, 0):
        state, _ = jenv.step(state, jnp.int32(a))
    jstates = jax.tree.map(lambda x: jnp.stack([x] * 4), state)
    jfused = jax_fused.FusedConnectNSearch(jenv, jcfg, block_games=4)
    ref, _ = jax.jit(
        lambda s, r: jfused.search_root_stats(s, _jax_dyadic(7), r, 8)
    )(jstates, jax.random.PRNGKey(0))
    visits, wsum = FusedConnectNSearch(env, cfg, device="cpu") \
        .search_root_stats(_to_torch(jstates), torch_dyadic(7), None, 8)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(visits.numpy(), 0)
    np.testing.assert_array_equal(wsum.numpy(), 0.0)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_v1_and_v2_searches_agree(geometry):
    """K2's and K1's searches from one generator seed each: equal root
    stats, and the generators end in the same state (both draw one (B, A)
    Gamma per simulation)."""
    env = ConnectN(ConnectNConfig(**geometry))
    cfg = MCTSConfig(simulations=24, use_dirichlet=True, dirichlet_alpha=1.0)
    states = random_positions(env, 16, 12, torch.Generator().manual_seed(3),
                              "cpu")
    results = []
    for impl in (FusedConnectNSearch, FusedConnectNSearchV2):
        gen = torch.Generator().manual_seed(8)
        stats = impl(env, cfg, device="cpu").search_root_stats(
            states, torch_dyadic(env.num_actions), gen, 24)
        results.append((stats, gen.get_state()))
    ((v1, w1), g1), ((v2, w2), g2) = results
    assert torch.equal(v1, v2)
    assert torch.equal(w1.view(torch.int32), w2.view(torch.int32))
    assert torch.equal(g1, g2)
    assert int(v1.sum()) > 0


@pytest.mark.parametrize("geometry, mcts", [
    (dict(), dict()),
    (dict(width=5, height=4, n=3), dict()),
    (dict(), dict(max_nodes=64)),
    (dict(gravity=False), dict()),
])
def test_supports_matches_jax(geometry, mcts):
    """Which (env, config) pairs the v1 fused search takes, as in JAX; the
    rest are refused by its constructor."""
    jenv, env, jcfg, cfg = _pair(geometry, **mcts)
    ok = fused_mcts.supports(env, cfg)
    assert ok == jax_fused.supports(jenv, jcfg)
    if not ok:
        with pytest.raises(ValueError):
            FusedConnectNSearch(env, cfg, device="cpu")


def test_wave_rejects_non_cuda_accelerators():
    """CPU tensors take the plain version; other devices raise."""
    env = ConnectN(ConnectNConfig())
    states = env.init(2, device="meta")
    carry = fused_mcts.init_carry(env, states, 3)
    geom = fused_mcts.WaveGeometry(6, 7, 4, 1.5, 2)
    buffers = fused_mcts_v2.new_buffers(2, 7, geom, False, "meta", (8, 8))
    with pytest.raises(ValueError, match="no wave kernel"):
        fused_mcts.wave_step(buffers, carry, geom)
