"""The port's general search ``MCTS.search`` against JAX's, field by field.

Both run from the same positions with dyadic evaluators (every float the
two programs compute independently is exact), at full width and with top-K
priors (``topk_actions=3``, with and without ``fast_edge_stats``), with root
noise off and with JAX's per-wave Gamma draws injected. Every ``Tree``
field must be equal bit for bit (float fields as int32 views), and so must
the root outputs. The port's three searches (general, K1's, K2's) agree
with each other from one generator seed, and each draws its root noise as
one (S, B, A) block.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import FusedNetCount, random_positions
from chip_smoke import dyadic_evaluate as torch_dyadic
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.ops.fused_mcts import FusedConnectNSearch
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from custom_alphazero_tpu_torch.ops.rng import safe_gamma
from custom_alphazero_tpu_torch.search.mcts import MCTS
from tests.test_torch_port_search import (
    _jax_dyadic,
    _pair,
    _random_midgame_states,
    _to_torch,
    jax_wave_gammas,
)

TREE_FIELDS = ("parent", "parent_action", "visits", "value_sum", "prior",
               "expanded", "is_terminal", "reward", "value_evaluated",
               "node_count", "prior_acts", "parent_slot", "root_prior",
               "root_visits", "root_value_sum", "child_index")


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert got.dtype == want.dtype, name
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


LAYOUTS = {
    "full": dict(),
    "topk3": dict(topk_actions=3),
    "topk3-fast": dict(topk_actions=3, fast_edge_stats=True),
}


@pytest.mark.parametrize("use_dirichlet", [False, True],
                         ids=["no-noise", "noise"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_search_tree_matches_jax(layout, use_dirichlet):
    batch, sims = 12, 24
    jenv, env, jcfg, cfg = _pair({}, simulations=sims,
                                 use_dirichlet=use_dirichlet,
                                 dirichlet_alpha=1.0, **LAYOUTS[layout])
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(5), batch, 7)
    rng = jax.random.PRNGKey(9)
    jmcts = JaxMCTS(jenv, jcfg)
    jtree = jax.jit(
        lambda s, r: jmcts.search(s, _jax_dyadic(7), r, sims)
    )(jstates, rng)
    gamma = (jax_wave_gammas(jenv, jcfg, rng, batch, sims)
             if use_dirichlet else None)

    mcts = MCTS(env, cfg)
    tree = mcts.search(_to_torch(jstates), torch_dyadic(7), None, sims,
                       gamma=gamma)
    assert (tree.prior_acts is None) == (layout == "full")
    assert (tree.child_index is None) == (layout != "topk3-fast")
    for name in TREE_FIELDS:
        got, want = getattr(tree, name), getattr(jtree, name)
        assert (got is None) == (want is None), name
        if got is not None:
            _assert_same(got, want, name)
    for name in ("root_child_visits", "root_child_value_sums",
                 "root_q_values"):
        _assert_same(getattr(mcts, name)(tree),
                     getattr(jmcts, name)(jtree), name)
    assert int(tree.node_count.min()) > 1


def test_search_variant_geometry_and_capacity():
    """5x4 connect-3 with more node slots than simulations (max_nodes)."""
    batch, sims = 8, 16
    jenv, env, jcfg, cfg = _pair(dict(width=5, height=4, n=3),
                                 simulations=sims, max_nodes=24)
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(6), batch, 4)
    jmcts = JaxMCTS(jenv, jcfg)
    jtree = jax.jit(
        lambda s, r: jmcts.search(s, _jax_dyadic(5), r, sims)
    )(jstates, jax.random.PRNGKey(0))
    tree = MCTS(env, cfg).search(_to_torch(jstates), torch_dyadic(5), None,
                                 sims)
    assert tree.parent.shape == (batch, 24)
    for name in TREE_FIELDS[:10]:
        _assert_same(getattr(tree, name), getattr(jtree, name), name)


class _StubEnv:
    def __init__(self, num_actions):
        self.num_actions = num_actions


@pytest.mark.parametrize("actions, topk, sims, want", [
    (7, 0, 64, 7),        # small action space: never compressed
    (7, 0, 4, 4),         # auto K = min(simulations, A)
    (7, -1, 4, 7),        # forced full width
    (7, 3, 64, 3),        # explicit
    (1968, 0, 100, 100),  # chess-sized, below the clamp
    (1968, 0, 800, MCTS.AUTO_TOPK_CLAMP),  # auto K clamped
    (1968, 512, 800, 512),  # explicit overrides the clamp
    (1968, -1, 800, 1968),
])
def test_prior_width_matches_jax(actions, topk, sims, want):
    from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig

    got = MCTS(_StubEnv(actions), MCTSConfig(topk_actions=topk)) \
        .prior_width(sims)
    ref = JaxMCTS(_StubEnv(actions), JaxMCTSConfig(topk_actions=topk)) \
        .prior_width(sims)
    assert got == ref == want
    assert MCTS.AUTO_TOPK_CLAMP == JaxMCTS.AUTO_TOPK_CLAMP


@pytest.mark.parametrize("use_dirichlet, alpha", [
    (False, 1.0), (True, 1.0), (True, 0.3),
], ids=["no-noise", "noise", "noise-alpha0.3"])
def test_general_search_matches_fused_searches(use_dirichlet, alpha):
    """The port's general search, K1 and K2 searches: equal root stats from
    one generator seed each, and the generators end in the same state (at
    alpha 0.3 on the Marsaglia-Tsang path too)."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=20, use_dirichlet=use_dirichlet,
                     dirichlet_alpha=alpha)
    gen = torch.Generator().manual_seed(2)
    from chip_smoke import random_positions

    states = random_positions(env, 12, 16, gen, "cpu")
    results = []
    for search in (MCTS(env, cfg),
                   FusedConnectNSearchV2(env, cfg, device="cpu"),
                   FusedConnectNSearch(env, cfg, device="cpu")):
        g = torch.Generator().manual_seed(4)
        if isinstance(search, MCTS):
            tree = search.search(states, torch_dyadic(7), g, 20)
            stats = (search.root_child_visits(tree),
                     search.root_child_value_sums(tree))
        else:
            stats = search.search_root_stats(states, torch_dyadic(7), g, 20)
        results.append((stats, g.get_state()))
    (visits, wsum), g_state = results[0]
    assert int(visits.sum()) > 0
    for (v, s), g_other in results[1:]:
        assert torch.equal(v, visits)
        assert torch.equal(s.view(torch.int32), wsum.view(torch.int32))
        assert torch.equal(g_other, g_state)


SEARCHES = {
    "general": MCTS,
    "K1": lambda env, cfg: FusedConnectNSearchV2(env, cfg, device="cpu"),
    "K2": lambda env, cfg: FusedConnectNSearch(env, cfg, device="cpu"),
}


def _search_stats(search, states, generator, sims, gamma=None):
    if isinstance(search, MCTS):
        tree = search.search(states, torch_dyadic(7), generator, sims,
                             gamma=gamma)
        return search.root_child_visits(tree)
    return search.search_root_stats(states, torch_dyadic(7), generator, sims,
                                    gamma=gamma)[0]


@pytest.mark.parametrize("use_dirichlet", [False, True],
                         ids=["no-noise", "noise"])
@pytest.mark.parametrize("sims", [20, 1])
@pytest.mark.parametrize("kind", list(SEARCHES))
def test_search_draws_its_noise_as_one_block(kind, sims, use_dirichlet):
    """A noisy search makes one ``safe_gamma`` call, whatever its length,
    and draws nothing else from its generator; a search without noise
    makes none. A fused search's ``buffers.gamma`` holds the block that
    ``noise_plan`` draws from the same seed."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=sims, use_dirichlet=use_dirichlet,
                     dirichlet_alpha=1.0)
    states = random_positions(env, 12, 10, torch.Generator().manual_seed(2),
                              "cpu")
    search = SEARCHES[kind](env, cfg)
    gen = torch.Generator().manual_seed(5)
    before = safe_gamma.calls
    with FusedNetCount() as count:  # chip_smoke's count, as on the card
        _search_stats(search, states, gen, sims)
    assert safe_gamma.calls - before == int(use_dirichlet)
    counts = count.check(kind, 0)
    assert counts["noisy_searches"] == counts["safe_gamma_calls"] \
        == int(use_dirichlet)

    ref = torch.Generator().manual_seed(5)
    block = MCTS(env, cfg).noise_plan(ref, sims, 12, "cpu")
    assert (block is None) == (not use_dirichlet)
    assert torch.equal(gen.get_state(), ref.get_state())
    if use_dirichlet and kind != "general":
        assert block.shape == (sims, 12, 7)
        got = search.static(12, sims).buffers.gamma
        assert torch.equal(got.view(torch.int32), block.view(torch.int32))


@pytest.mark.parametrize("kind", list(SEARCHES))
def test_injected_gamma_copied_whole(kind):
    """Injected (S, B, A) draws: no ``safe_gamma`` call, and a fused search's
    ``buffers.gamma`` is a copy of them; each search's root stats equal
    those it reaches from the generator whose block the draws are."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=16, use_dirichlet=True, dirichlet_alpha=1.0)
    states = random_positions(env, 12, 10, torch.Generator().manual_seed(3),
                              "cpu")
    gamma = MCTS(env, cfg).noise_plan(torch.Generator().manual_seed(6), 16,
                                      12, "cpu")
    search = SEARCHES[kind](env, cfg)
    before = safe_gamma.calls
    injected = _search_stats(search, states, None, 16, gamma=gamma.clone())
    assert safe_gamma.calls == before
    if kind != "general":
        got = search.static(12, 16).buffers.gamma
        assert torch.equal(got.view(torch.int32), gamma.view(torch.int32))
    drawn = _search_stats(SEARCHES[kind](env, cfg), states,
                          torch.Generator().manual_seed(6), 16)
    assert torch.equal(injected, drawn)
    assert int(drawn.sum()) > 0


@pytest.mark.parametrize("shape", [(20, 12, 7), (250, 64, 7)])
def test_noise_block_equals_per_wave_draws_at_alpha_one(shape):
    """At alpha 1 on the CPU the (S, B, A) block is the S per-wave (B, A)
    draws from the same seed, bit for bit, and the generator ends in the
    same state: the stream order moved from per wave to block without
    moving a CPU value."""
    sims, batch, a = shape
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=sims, use_dirichlet=True,
                     dirichlet_alpha=1.0)
    block_gen = torch.Generator().manual_seed(4)
    block = MCTS(env, cfg).noise_plan(block_gen, sims, batch, "cpu")
    wave_gen = torch.Generator().manual_seed(4)
    waves = torch.stack([safe_gamma(wave_gen, 1.0, (batch, a), "cpu")
                         for _ in range(sims)])
    assert block.dtype == torch.float32 and block.shape == shape
    assert torch.equal(block.view(torch.int32), waves.view(torch.int32))
    assert torch.equal(block_gen.get_state(), wave_gen.get_state())
