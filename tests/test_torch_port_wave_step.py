"""The port's wave step (what the CUDA kernels K1 and K2 compute between
two net forwards) in its plain PyTorch version, and the search's reused
device memory.

- ``wave_step_reference`` against the separate calls it composes
  (``wave_inputs``, ``wave_reference``, ``observe_board``), bit for bit.
- The path a step records against the leaf's ``parent`` /
  ``parent_action`` chain, which the kernel's parallel backup replaces.
- Searches back to back on one search object against fresh objects.
- K2's, K1's and the general search's use of one generator.
- Root visits and value sums against JAX with JAX's Gamma draws injected:
  exact, on the dyadic evaluator.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import dyadic_evaluate as torch_dyadic
from chip_smoke import random_positions
from custom_alphazero_tpu.ops import fused_mcts as jax_fused_v1
from custom_alphazero_tpu.ops import fused_mcts_v2 as jax_fused_v2
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.ops import fused_mcts, fused_mcts_v2
from custom_alphazero_tpu_torch.ops.fused_mcts import FusedConnectNSearch
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
from custom_alphazero_tpu_torch.search.mcts import MCTS
from tests.test_torch_port_search import (
    _jax_dyadic,
    _pair,
    _random_midgame_states,
    _to_torch,
    jax_wave_gammas,
)

GEOMETRIES = [dict(width=7, height=6, n=4), dict(width=5, height=4, n=3)]
GEOMETRY_IDS = ["7x6n4", "5x4n3"]
LAYOUTS = [(fused_mcts_v2, FusedConnectNSearchV2),
           (fused_mcts, FusedConnectNSearch)]
LAYOUT_IDS = ["K1", "K2"]
BATCH, SIMS = 12, 20


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _noisy_search(impl, geometry, seed):
    """A CPU search object with root noise, its reset device memory with
    numpy-seeded Gamma draws, and its geometry."""
    env = ConnectN(ConnectNConfig(**geometry))
    cfg = MCTSConfig(simulations=SIMS, use_dirichlet=True,
                     dirichlet_alpha=1.0, dirichlet_fraction=0.25)
    states = random_positions(env, BATCH, 8,
                              torch.Generator().manual_seed(seed), "cpu")
    search = impl(env, cfg, device="cpu")
    static = search.static(BATCH, SIMS)
    search.reset(static, states)
    rng = np.random.default_rng(seed)
    static.buffers.gamma.copy_(torch.from_numpy(
        rng.gamma(1.0, size=(SIMS, BATCH, env.num_actions))
        .astype(np.float32)))
    return env, search, static, states


def _feed(evaluate, buffers):
    probs, value = evaluate(buffers.obs)
    buffers.probs.copy_(probs)
    buffers.value.copy_(value.reshape(-1, 1))


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
@pytest.mark.parametrize("module, impl", LAYOUTS, ids=LAYOUT_IDS)
def test_wave_step_equals_separate_calls(module, impl, geometry):
    """The composed step against wave_inputs + wave_reference +
    observe_board, every array after every wave."""
    env, search, static, states = _noisy_search(impl, geometry, seed=5)
    geom = search.geometry(SIMS)
    buffers, carry = static.buffers, static.carry
    evaluate = torch_dyadic(env.num_actions)

    ref_carry = module.init_carry(env, states, SIMS + 1)
    root_board = buffers.root_board.clone()
    leaf_board = torch.zeros_like(root_board)
    probs = torch.zeros((BATCH, env.num_actions))
    value = torch.zeros((BATCH, 1))
    root_prior = torch.zeros_like(probs)
    for w in range(SIMS + 1):
        gamma_w = buffers.gamma[w] if w < SIMS else None
        renormed, mixed, root_prior = search.wave_inputs(
            w, SIMS, leaf_board.view(BATCH, 64), ref_carry.leaf_terminal,
            probs, root_prior, ~states.terminal, gamma_w)
        ref_carry, leaf_board = module.wave_reference(
            w, mixed, renormed, value, root_board, ref_carry, geom)
        obs = fused_mcts_v2.observe_board(leaf_board, geometry["height"],
                                          geometry["width"])

        assert int(buffers.counter[0]) == w
        module.wave_step(buffers, carry, geom)
        assert int(buffers.counter[0]) == w + 1
        got = dict(zip(carry._fields, carry), renormed=buffers.renormed,
                   mixed=buffers.mixed, root_prior=buffers.root_prior,
                   leaf_board=buffers.leaf_board, obs=buffers.obs)
        want = dict(zip(carry._fields, ref_carry), renormed=renormed,
                    mixed=mixed, root_prior=root_prior,
                    leaf_board=leaf_board, obs=obs)
        for name in got:
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                          err_msg=f"wave {w}: {name}")
        probs, v = evaluate(obs)
        value = v[:, None]
        _feed(evaluate, buffers)
    assert float(carry.node_count.max()) > SIMS // 2
    assert module.wave_step_reference.calls >= SIMS + 1


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
@pytest.mark.parametrize("module, impl", LAYOUTS, ids=LAYOUT_IDS)
def test_recorded_path_is_parent_chain(module, impl, geometry):
    """After every wave, ``path`` holds the edges from the root to the new
    leaf: the leaf's parent / parent_action chain, reversed."""
    env, search, static, _ = _noisy_search(impl, geometry, seed=6)
    geom = search.geometry(SIMS)
    buffers, carry = static.buffers, static.carry
    evaluate = torch_dyadic(env.num_actions)
    a = env.num_actions
    deepest = 0
    for w in range(SIMS):
        module.wave_step(buffers, carry, geom)
        for b in range(BATCH):
            chain, node = [], int(carry.leaf[b, 0])
            while node > 0:
                parent = int(carry.parent[b, node])
                chain.append(parent * a + int(carry.parent_action[b, node]))
                node = parent
            count = int(buffers.path[b, 0])
            assert count == len(chain), f"wave {w}, game {b}"
            assert buffers.path[b, 1:1 + count].tolist() == chain[::-1], \
                f"wave {w}, game {b}"
            deepest = max(deepest, count)
        _feed(evaluate, buffers)
    assert deepest >= 2
    assert buffers.path.shape[1] == 1 + min(
        SIMS + 1, geometry["height"] * geometry["width"] + 1)


def _won_position(env, batch):
    """Boards after 0,1,0,1,0,1,0: the first mover has won."""
    states = env.init(batch, device="cpu")
    for a in (0, 1, 0, 1, 0, 1, 0):
        states, _ = env.step(states, torch.full((batch,), a))
    return states


@pytest.mark.parametrize("impl", [FusedConnectNSearchV2, FusedConnectNSearch],
                         ids=LAYOUT_IDS)
def test_search_object_reuse(impl):
    """Two searches back to back on one object (its memory reset in place;
    different roots, the second batch with terminal roots) give what two
    fresh objects give, and the results are copies."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=16, use_dirichlet=True, dirichlet_alpha=1.0)
    first = random_positions(env, 8, 10, torch.Generator().manual_seed(1),
                             "cpu")
    second = random_positions(env, 8, 16, torch.Generator().manual_seed(2),
                              "cpu")
    second = _won_position(env, 8).where(torch.arange(8) >= 4, second)
    assert int(env.is_terminal(second).sum()) >= 4
    evaluate = torch_dyadic(7)

    def run(search, states, seed):
        return search.search_root_stats(
            states, evaluate, torch.Generator().manual_seed(seed), 16)

    reused = impl(env, cfg, device="cpu")
    got_first = run(reused, first, 3)
    kept = [t.clone() for t in got_first]
    got_second = run(reused, second, 4)
    for got, want in ((got_first, run(impl(env, cfg, device="cpu"), first, 3)),
                      (got_second,
                       run(impl(env, cfg, device="cpu"), second, 4))):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
    # The second search did not write into the first one's results.
    assert torch.equal(got_first[0], kept[0])
    assert torch.equal(got_first[1], kept[1])
    assert torch.equal(got_second[0][4:], torch.zeros((4, 7),
                                                      dtype=torch.int32))
    assert len(reused._static) == 1


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_three_searches_share_generator_state(geometry):
    """K2's, K1's and the general search from one generator seed each:
    equal root stats, and the generators end in one state (each draws one
    (B, A) Gamma per simulation, in order)."""
    env = ConnectN(ConnectNConfig(**geometry))
    cfg = MCTSConfig(simulations=SIMS, use_dirichlet=True,
                     dirichlet_alpha=1.0)
    states = random_positions(env, BATCH, 10,
                              torch.Generator().manual_seed(3), "cpu")
    evaluate = torch_dyadic(env.num_actions)
    results = []
    for impl in (FusedConnectNSearch, FusedConnectNSearchV2):
        gen = torch.Generator().manual_seed(8)
        stats = impl(env, cfg, device="cpu").search_root_stats(
            states, evaluate, gen, SIMS)
        results.append((stats, gen.get_state()))
    gen = torch.Generator().manual_seed(8)
    mcts = MCTS(env, cfg)
    tree = mcts.search(states, evaluate, gen, SIMS)
    results.append(((mcts.root_child_visits(tree),
                     mcts.root_child_value_sums(tree)), gen.get_state()))
    (visits, wsum), state = results[0]
    for (other_visits, other_wsum), other_state in results[1:]:
        assert torch.equal(visits, other_visits)
        assert torch.equal(wsum.view(torch.int32),
                           other_wsum.view(torch.int32))
        assert torch.equal(state, other_state)
    assert int(visits.sum()) > 0


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
@pytest.mark.parametrize("impl, jax_module", [
    (FusedConnectNSearchV2, jax_fused_v2), (FusedConnectNSearch, jax_fused_v1),
], ids=LAYOUT_IDS)
def test_search_matches_jax_with_injected_gamma(impl, jax_module, geometry):
    """Root visits and value sums against JAX's fused search of the same
    layout, root noise on, JAX's draws injected: exact (dyadic evaluator).
    The search runs twice on one object: the second run reuses its memory."""
    jenv, env, jcfg, cfg = _pair(geometry, simulations=SIMS,
                                 use_dirichlet=True)
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(21), BATCH, 5)
    rng = jax.random.PRNGKey(9)
    jimpl = getattr(jax_module, impl.__name__)(jenv, jcfg, block_games=4)
    jeval = _jax_dyadic(jenv.num_actions)
    want_visits, want_wsum = jax.jit(
        lambda s, r: jimpl.search_root_stats(s, jeval, r, SIMS)
    )(jstates, rng)
    gamma = jax_wave_gammas(jenv, jcfg, rng, BATCH, SIMS)
    search = impl(env, cfg, device="cpu")
    for _ in range(2):
        visits, wsum = search.search_root_stats(
            _to_torch(jstates), torch_dyadic(env.num_actions), None, SIMS,
            gamma=gamma)
        np.testing.assert_array_equal(visits.numpy(), np.asarray(want_visits))
        np.testing.assert_array_equal(
            wsum.numpy().view(np.int32),
            np.asarray(want_wsum).view(np.int32))
    assert int(visits.sum()) > 0


def test_graph_needs_the_card():
    """A CPU search never reaches a CUDA graph: asking for one raises, in
    the search and through self-play; graph=False is the CPU's path."""
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=4)
    states = env.init(2, device="cpu")
    search = FusedConnectNSearchV2(env, cfg, device="cpu")
    with pytest.raises(ValueError, match="no CUDA graph"):
        search.search_root_stats(states, torch_dyadic(7), None, 4, graph=True)
    visits, _ = search.search_root_stats(states, torch_dyadic(7), None, 4,
                                         graph=False)
    assert visits.sum(-1).tolist() == [3, 3]
    generate = make_selfplay_fn(env, cfg, SelfPlayConfig(), 2, device="cpu",
                                graph=True)
    with pytest.raises(ValueError, match="no CUDA graph"):
        generate(torch_dyadic(7), torch.Generator().manual_seed(0), 2)


@pytest.mark.parametrize("kernel", LAYOUT_IDS)
def test_chip_smoke_comparison_runs_on_cpu(kernel):
    """chip_smoke's lockstep comparison of a kernel with its plain version,
    rehearsed on the CPU, where the wrapper takes the plain version too."""
    env = ConnectN(ConnectNConfig(width=5, height=4, n=3))
    cfg = MCTSConfig(simulations=10, use_dirichlet=True, dirichlet_alpha=1.0)
    gen = torch.Generator().manual_seed(0)
    states = random_positions(env, 6, 6, gen, "cpu")
    max_err, *_ = chip_smoke.kernel_vs_plain(env, cfg, states, 10, gen,
                                             timed=False, kernel=kernel)
    assert max_err == 0.0
