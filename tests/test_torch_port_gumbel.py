"""The port's Gumbel search (search/gumbel.py) against JAX's.

- ``halving_schedule`` equals JAX's over a grid of (m, simulations).
- ``GumbelMCTS.search_select`` with JAX's Gumbel draws injected: the same
  action and root visits, every integer tree field equal, the improved
  policy within 1e-5 (the softmax's exp and log are each library's own, so
  the last bits may differ). Connect-4 fixtures of tests/test_gumbel.py
  with JAX's uniform evaluator, random midgames with a non-uniform one, and
  the chess case at full width and with top-K priors.
- Gumbel self-play: valid samples, and the same games as JAX's
  ``make_selfplay_fn`` when it is fed JAX's per-ply draws.

Evaluator outputs are computed by JAX and handed to the port as arrays, so
both searches see the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ChessConfig as JaxChessConfig
from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from custom_alphazero_tpu.envs.chess.engine import Chess as JaxChess
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.runtime.selfplay import (
    make_selfplay_fn as jax_make_selfplay_fn,
)
from custom_alphazero_tpu.search.gumbel import GumbelMCTS as JaxGumbelMCTS
from custom_alphazero_tpu.search.gumbel import (
    halving_schedule as jax_halving_schedule,
)
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
from custom_alphazero_tpu_torch.search import gumbel as gumbel_module
from custom_alphazero_tpu_torch.search.gumbel import (
    GumbelMCTS,
    halving_schedule,
)
from tests.test_topk_search import _pseudo_net
from tests.test_torch_port_chess import to_torch as chess_to_torch
from tests.test_torch_port_search import _random_midgame_states, _to_torch

INT_FIELDS = ("parent", "parent_action", "expanded", "is_terminal",
              "node_count", "prior_acts", "parent_slot", "visits")


def _uniform(num_actions):
    def evaluate(obs):
        b = obs.shape[0]
        return jnp.ones((b, num_actions)) / num_actions, jnp.zeros((b,))

    return evaluate


def _linear(num_actions, seed=1):
    def evaluate(obs):
        flat = obs.reshape(obs.shape[0], -1)
        w = jnp.asarray(np.random.default_rng(seed).normal(
            size=(flat.shape[1], num_actions + 1)).astype(np.float32) * 0.3)
        out = flat @ w
        return jax.nn.softmax(out[:, :-1], -1), jnp.tanh(out[:, -1])

    return evaluate


def _through_jax(jax_evaluate):
    """The port's evaluator: JAX's outputs on the same observations."""
    def evaluate(obs):
        probs, value = jax_evaluate(jnp.asarray(obs.numpy()))
        return (torch.from_numpy(np.array(probs)),
                torch.from_numpy(np.array(value)))

    return evaluate


def jax_search_gumbels(key, batch, num_actions):
    """The (B, A) draws JAX's ``search_select`` takes from ``key``."""
    _, k_gumbel = jax.random.split(key)
    return torch.from_numpy(np.array(
        jax.random.gumbel(k_gumbel, (batch, num_actions))))


def _compare(jenv, env, jstates, states, cfg, jax_evaluate, key):
    sims = cfg["simulations"]
    jsearch = JaxGumbelMCTS(jenv, JaxMCTSConfig(**cfg))
    jtree, jaction, jpi = jax.jit(
        lambda s, k: jsearch.search_select(s, jax_evaluate, k, sims)
    )(jstates, key)
    search = GumbelMCTS(env, MCTSConfig(**cfg))
    batch = np.asarray(jaction).shape[0]
    tree, action, pi = search.search_select(
        states, _through_jax(jax_evaluate), None, sims,
        gumbels=jax_search_gumbels(key, batch, env.num_actions))
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    np.testing.assert_array_equal(search.root_child_visits(tree).numpy(),
                                  np.asarray(jsearch.root_child_visits(jtree)))
    for name in INT_FIELDS:
        got, want = getattr(tree, name), getattr(jtree, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    np.testing.assert_allclose(pi.numpy(), np.asarray(jpi), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pi.sum(-1).numpy(), 1.0, atol=1e-5)
    return action, search.root_child_visits(tree), pi


def test_halving_schedule_matches_jax():
    for m in (1, 2, 3, 4, 7, 8, 16, 32):
        for sims in (1, 2, 5, 8, 15, 16, 33, 49, 99, 200):
            for got, want in zip(halving_schedule(m, sims),
                                 jax_halving_schedule(m, sims)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        halving_schedule(0, 4)


def test_selection_pieces_match_jax():
    """completedQ, the improved policy and the non-root choice on random
    (B, N, 7) rows with illegal slots, unvisited and visited edges."""
    rng = np.random.default_rng(8)
    prior = rng.random((5, 6, 7)).astype(np.float32)
    prior[rng.random(prior.shape) < 0.3] = 0.0
    prior /= np.maximum(prior.sum(-1, keepdims=True), 1e-30)
    nv = rng.integers(0, 4, prior.shape).astype(np.float32) * (prior > 0)
    w = (rng.random(prior.shape).astype(np.float32) - 0.5) * nv
    v_node = (rng.random((5, 6)).astype(np.float32) - 0.5)
    cfg = dict(gumbel_c_visit=50.0, gumbel_c_scale=0.5)
    jsearch = JaxGumbelMCTS(None, JaxMCTSConfig(**cfg))
    search = GumbelMCTS(None, MCTSConfig(**cfg))
    args = (prior, nv, w, v_node)
    targs = tuple(torch.from_numpy(x) for x in args)
    jargs = tuple(jnp.asarray(x) for x in args)
    np.testing.assert_array_equal(search._completed_q(*targs).numpy(),
                                  np.asarray(jsearch._completed_q(*jargs)))
    np.testing.assert_allclose(search._improved_policy(*targs).numpy(),
                               np.asarray(jsearch._improved_policy(*jargs)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        search._nonroot_action(*targs).numpy(),
        np.asarray(jsearch._nonroot_action(*jargs)))


# tests/test_gumbel.py's fixtures: an empty board, a win in one (column 2),
# a loss to block (column 3), a full column.
FIXTURES = ([], [2, 0, 2, 0, 2, 1], [3, 0, 3, 0, 3], [0, 0, 0, 0, 0, 0])


def _c4_fixture_states(jenv, copies):
    states = []
    for moves in FIXTURES:
        state = jenv.init()
        for mv in moves:
            state, _ = jenv.step(state, jnp.int32(mv))
        states += [state] * copies
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *states)


@pytest.mark.parametrize("sims, m, evaluator", [
    (33, 4, "uniform"), (32, 7, "uniform"), (200, 7, "uniform"),
    (16, 4, "uniform"), (8, 7, "uniform"), (32, 7, "linear"),
    (2, 4, "linear"), (1, 4, "linear"),
])
def test_search_select_matches_jax_connect4(sims, m, evaluator):
    """The fixtures (three Gumbel draws each) and 8 random midgames."""
    jenv = JaxConnectN(JaxConnectNConfig())
    env = ConnectN(ConnectNConfig())
    fixtures = _c4_fixture_states(jenv, 3)
    midgames = _random_midgame_states(jenv, jax.random.PRNGKey(sims), 8, 9)
    jstates = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), fixtures,
                           midgames)
    jax_evaluate = _uniform(7) if evaluator == "uniform" else _linear(7)
    action, visits, pi = _compare(
        jenv, env, jstates, _to_torch(jstates),
        dict(simulations=sims, gumbel_max_considered=m), jax_evaluate,
        jax.random.PRNGKey(100 + sims))
    budget = max(sims - 1, 0)
    live = ~_to_torch(jstates).terminal
    assert (visits.sum(-1)[live] == budget).all()
    if sims >= 32 and m == 7 and evaluator == "uniform":
        # The win in one is found and the loss blocked, in every draw.
        assert (action[3:6] == 2).all() and (pi[3:6].argmax(-1) == 2).all()
        if sims == 200:
            assert (action[6:9] == 3).all()
    # A full column is outside the improved policy's support.
    if sims > 1:
        assert (pi[9:12, 0] == 0).all()


@pytest.mark.parametrize("layout, topk", [("full", -1), ("compressed", 64)])
def test_search_select_matches_jax_chess(layout, topk):
    """tests/test_gumbel.py's chess case: two roots, 24 simulations,
    m = 8, the pseudo net of tests/test_topk_search.py."""
    jenv, env = JaxChess(JaxChessConfig()), Chess()
    s0 = jenv.init()
    legal0 = np.nonzero(np.asarray(jenv.legal_mask(s0)))[0]
    s1, _ = jenv.step(s0, jnp.int32(int(legal0[0])))
    jstates = jax.tree.map(lambda a, b: jnp.stack([a, b]), s0, s1)
    cfg = dict(simulations=24, use_dirichlet=False, use_gumbel=True,
               gumbel_max_considered=8, topk_actions=topk)
    assert (GumbelMCTS(env, MCTSConfig(**cfg)).prior_width(24)
            < env.num_actions) == (layout == "compressed")
    _compare(jenv, env, jstates, chess_to_torch(jstates), cfg,
             _pseudo_net(jenv), jax.random.PRNGKey(3))


def test_compressed_matches_full_width_chess():
    """Top-K with K covering every node's legal set gives the full-width
    search's action, root visits and improved policy (the port alone)."""
    env = Chess()
    states = env.init(2, "cpu")
    states = states.where(torch.tensor([True, False]),
                          env.step(states, torch.tensor([1, 1]))[0])
    jenv = JaxChess(JaxChessConfig())
    evaluate = _through_jax(_pseudo_net(jenv))
    draws = gumbel_module.gumbel(torch.Generator().manual_seed(3),
                                 (2, env.num_actions), "cpu")
    outs = []
    for topk in (-1, 64):
        search = GumbelMCTS(env, MCTSConfig(
            simulations=24, gumbel_max_considered=8, topk_actions=topk))
        search.track_gaps = True
        tree, action, pi = search.search_select(states, evaluate, None, 24,
                                                gumbels=draws)
        outs.append((action, search.root_child_visits(tree), pi,
                     search.decision_gap))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][2], outs[1][2], rtol=0, atol=1e-5)
    assert (outs[0][3] > 0).all() and torch.equal(outs[0][3], outs[1][3])


def test_generator_draws_and_terminal_roots():
    """Draws from the generator when none are given (two calls with one
    seed agree); a terminal root plays action 0 and gets no visits."""
    env = ConnectN(ConnectNConfig())
    jenv = JaxConnectN(JaxConnectNConfig())
    state = jenv.init()
    for mv in (0, 1, 0, 1, 0, 1, 0):   # four in column 0: game over
        state, _ = jenv.step(state, jnp.int32(mv))
    jstates = jax.tree.map(lambda a, b: jnp.stack([a, b]), jenv.init(), state)
    states = _to_torch(jstates)
    search = GumbelMCTS(env, MCTSConfig(simulations=16,
                                        gumbel_max_considered=4))
    evaluate = _through_jax(_linear(7))
    runs = [search.search_select(states, evaluate,
                                 torch.Generator().manual_seed(5), 16)
            for _ in range(2)]
    (tree, action, pi), (_, action2, pi2) = runs
    assert torch.equal(action, action2) and torch.equal(pi, pi2)
    assert int(action[1]) == 0
    visits = search.root_child_visits(tree)
    assert int(visits[0].sum()) == 15 and int(visits[1].sum()) == 0


def test_selfplay_gumbel_generates_valid_samples():
    """tests/test_gumbel.py:111 on the port: 5x4 connect-3, 12 sims."""
    cfg = ConnectNConfig(width=5, height=4, n=3)
    env = ConnectN(cfg)
    plies = cfg.width * cfg.height
    sp = make_selfplay_fn(
        env, MCTSConfig(simulations=12, use_gumbel=True,
                        gumbel_max_considered=4),
        SelfPlayConfig(exclude_draws=False), plies, device="cpu")

    def uniform(obs):
        b = obs.shape[0]
        return torch.ones((b, cfg.num_actions)) / cfg.num_actions, \
            torch.zeros(b)

    batch, stats = sp(uniform, torch.Generator().manual_seed(0), 8)
    valid = batch.valid
    pi, z = batch.policy[valid], batch.value[valid]
    assert int(stats.games) == 8
    assert int(valid.sum()) >= 8 * (2 * cfg.n - 1)
    torch.testing.assert_close(pi.sum(-1), torch.ones(len(pi)), rtol=0,
                               atol=1e-5)
    assert set(z.abs().round(decimals=6).tolist()) <= {0.0, 1.0}
    # The improved-policy target is dense, not a visit-count one-hot.
    assert ((pi > 0).sum(-1) > 1).float().mean() > 0.5
    with pytest.raises(ValueError, match="no fused kernel"):
        make_selfplay_fn(env, MCTSConfig(use_gumbel=True), SelfPlayConfig(),
                         4, device="cpu", fused=True)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["plain", "continuous"])
def test_selfplay_gumbel_matches_jax(continuous, monkeypatch):
    """Gumbel self-play at 5x4 connect-3 fed JAX's per-ply draws: the same
    observations, values, validity and stats as JAX's; targets within
    1e-5."""
    batch, plies, sims = 6, 16, 10
    mcts = dict(simulations=sims, use_gumbel=True, gumbel_max_considered=4)
    sp = dict(continuous=continuous, exclude_draws=False)
    geometry = dict(width=5, height=4, n=3)
    jax_evaluate = _linear(5, seed=4)
    jgen = jax_make_selfplay_fn(
        JaxConnectN(JaxConnectNConfig(**geometry)), JaxMCTSConfig(**mcts),
        JaxSelfPlayConfig(**sp), plies, fused=False)
    key = jax.random.PRNGKey(0)
    ref_batch, ref_stats = jax.jit(lambda r: jgen(jax_evaluate, r, batch))(
        key)

    draws = []
    for _ in range(plies):
        key, k_search, _ = jax.random.split(key, 3)
        draws.append(jax_search_gumbels(k_search, batch, 5))
    monkeypatch.setattr(gumbel_module, "gumbel",
                        lambda generator, shape, device: draws.pop(0))
    gen = make_selfplay_fn(ConnectN(ConnectNConfig(**geometry)),
                           MCTSConfig(**mcts), SelfPlayConfig(**sp), plies,
                           device="cpu")
    got_batch, got_stats = gen(_through_jax(jax_evaluate), None, batch)
    assert not draws
    for name in ("obs", "value", "valid"):
        got, want = getattr(got_batch, name).numpy(), np.asarray(
            getattr(ref_batch, name))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            name
    np.testing.assert_allclose(got_batch.policy.numpy(),
                               np.asarray(ref_batch.policy), rtol=0,
                               atol=1e-5)
    for name, got, want in zip(got_stats._fields, got_stats, ref_stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert int(got_stats.games) > 0


def test_chess_gumbel_selfplay_smoke():
    """tests/test_chess_selfplay.py:65 on the port: Gumbel with the 1968
    actions (m << A), well-formed improved-policy targets."""
    env = Chess()
    sp = make_selfplay_fn(env, MCTSConfig(simulations=8, use_gumbel=True,
                                          gumbel_max_considered=8),
                          SelfPlayConfig(exclude_draws=False), 6,
                          device="cpu")

    def uniform(obs):
        b = obs.shape[0]
        return torch.ones((b, env.num_actions)) / env.num_actions, \
            torch.zeros(b)

    batch, stats = sp(uniform, torch.Generator().manual_seed(0), 2)
    assert int(batch.valid.sum()) == 12
    pi = batch.policy[batch.valid]
    torch.testing.assert_close(pi.sum(-1), torch.ones(12), rtol=1e-4,
                               atol=0)
    assert (pi >= 0).all()
