"""The port's subtree reuse against JAX's: ``MCTS.search_tree`` and
``MCTS.advance_root`` move by move, and self-play with ``mcts.reuse_tree``.

The cases of tests/test_reuse.py, each run through both packages from the
same boards. Every ``Tree`` field (float fields as int32 views) and ``free``
must be equal after every search and every advance. The evaluators give both
searches the same bits: the uniform one is computed alike, the linear one
is JAX's own forward handed to the port as tensors. Root noise uses JAX's
per-simulation Gamma draws, reproduced from its keys and injected through
``gamma=``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
from custom_alphazero_tpu_torch.search.mcts import MCTS
from tests.test_mcts import (
    batched_roots,
    make_linear_eval,
    play_random_board,
    uniform_eval_batch,
)
from tests.test_torch_port_mcts import _assert_same
from tests.test_torch_port_search import _to_torch
from tests.test_torch_port_selfplay import _assert_matches_jax

# One intra-op thread per test process, as tests/test_torch_port_misc.py
# sets it: the suite's workers share the cores.
torch.set_num_threads(1)

JENV = JaxConnectN()
ENV = ConnectN(ConnectNConfig())
A = ENV.num_actions
TREE_FIELDS = ("parent", "parent_action", "visits", "value_sum", "prior",
               "expanded", "is_terminal", "reward", "value_evaluated",
               "node_count")
STATE_FIELDS = ("board", "heights", "fullmove", "terminal", "won")


def torch_uniform(obs):
    b = obs.shape[0]
    return torch.ones((b, A)) / A, torch.zeros((b,))


def bridged(jax_eval):
    """JAX's evaluator as a torch one: the same output bits for the port."""
    forward = jax.jit(jax_eval)

    def evaluate(obs):
        probs, value = forward(jnp.asarray(obs.numpy()))
        return (torch.from_numpy(np.array(probs)),
                torch.from_numpy(np.array(value)))

    return evaluate


def jax_tree_gammas(rng, alpha, batch, sims):
    """The (S, B, A) root draws of JAX's ``search_tree`` with key ``rng``:
    one split per simulation, then ``jax.random.gamma`` of the subkey."""
    draw = jax.jit(lambda k: jax.random.gamma(k, alpha, (batch, A)))
    out = []
    for _ in range(sims):
        rng, knoise = jax.random.split(rng)
        out.append(np.asarray(draw(knoise)))
    return torch.from_numpy(np.stack(out))


def assert_trees_equal(tree, free, jtree, jfree, where: str) -> None:
    for name in TREE_FIELDS:
        _assert_same(getattr(tree, name), getattr(jtree, name),
                     f"{name} {where}")
    for name in STATE_FIELDS:
        _assert_same(getattr(tree.root_state, name),
                     getattr(jtree.root_state, name),
                     f"root_state.{name} {where}")
    _assert_same(free, jfree, f"free {where}")


def drive(boards, jax_eval, port_eval, sims, capacity, plies, noise=False,
          check=None):
    """Greedy games with reuse through both packages, compared after every
    search and advance. ``check(tree, free, ply, stage)`` adds per-case
    assertions. Returns the searches compared."""
    mcts_kw = dict(simulations=sims)
    if noise:
        mcts_kw.update(use_dirichlet=True, dirichlet_alpha=1.0)
    jmcts = JaxMCTS(JENV, JaxMCTSConfig(**mcts_kw))
    mcts = MCTS(ENV, MCTSConfig(**mcts_kw))
    keep_cap = capacity - sims
    jstates = batched_roots(boards)
    batch = len(boards)
    jtree = jax.vmap(lambda s: jmcts.init_tree(s, capacity))(jstates)
    jfree = jnp.ones((batch,), jnp.int32)
    states = _to_torch(jstates)
    tree = mcts.init_tree(states, capacity)
    free = torch.ones(batch, dtype=torch.int32)
    jsearch = jax.jit(
        lambda t, f, k: jmcts.search_tree(t, f, jax_eval, k, sims))
    jadvance = jax.jit(lambda t, a, s: jmcts.advance_root(t, a, keep_cap, s))
    jstep = jax.jit(jax.vmap(JENV.step))
    searches = 0
    for ply in range(plies):
        key = jax.random.PRNGKey(ply)
        jtree, jfree = jsearch(jtree, jfree, key)
        gamma = jax_tree_gammas(key, 1.0, batch, sims) if noise else None
        tree, free = mcts.search_tree(tree, free, port_eval, None, sims,
                                      gamma=gamma)
        assert_trees_equal(tree, free, jtree, jfree, f"after search {ply}")
        searches += 1
        if check is not None:
            check(tree, free, ply, "search")
        actions = np.asarray(jmcts.root_child_visits(jtree)).argmax(1)
        jstates, _ = jstep(jstates, jnp.asarray(actions, jnp.int32))
        states, _ = ENV.step(states, torch.from_numpy(actions))
        jtree, jfree = jadvance(jtree, jnp.asarray(actions, jnp.int32),
                                jstates)
        tree, free = mcts.advance_root(tree, torch.from_numpy(actions),
                                       keep_cap, states)
        assert_trees_equal(tree, free, jtree, jfree, f"after advance {ply}")
        if check is not None:
            check(tree, free, ply, "advance")
        if bool(np.asarray(jstates.terminal).all()):
            break
    return searches


def test_reuse_parity_uniform_eval():
    boards = [play_random_board(seed, seed % 4) for seed in range(3)]
    assert drive(boards, uniform_eval_batch, torch_uniform, sims=12,
                 capacity=12 * 14, plies=12) >= 7


def test_reuse_parity_linear_eval():
    jax_eval, _ = make_linear_eval(7)
    boards = [play_random_board(seed + 50, seed % 3) for seed in range(2)]
    assert drive(boards, jax_eval, bridged(jax_eval), sims=10,
                 capacity=10 * 14, plies=6) == 6


def test_reuse_parity_root_noise():
    """Noise on: JAX's per-simulation draws injected through ``gamma=``."""
    jax_eval, _ = make_linear_eval(3)
    boards = [play_random_board(seed + 20, seed % 5) for seed in range(4)]
    assert drive(boards, jax_eval, bridged(jax_eval), sims=10,
                 capacity=10 * 14, plies=5, noise=True) == 5


def test_reuse_visit_accumulation():
    """The first search leaves sims - 1 root visits (the root's evaluation
    backs nothing up); the advance keeps the played child's subtree visits;
    every simulation on the carried, expanded root backs up."""
    sims = 16
    totals = []

    def check(tree, free, ply, stage):
        totals.append(int(MCTS(ENV).root_child_visits(tree).sum()))

    drive([play_random_board(0, 0)], uniform_eval_batch, torch_uniform,
          sims=sims, capacity=sims * 14, plies=2, check=check)
    first, carried, second = totals[:3]
    assert first == sims - 1
    assert 0 < carried < first
    assert second == carried + sims


@pytest.mark.parametrize("keep", [8, 2])
def test_reuse_truncation_keeps_most_visited(keep):
    """A capacity of sims + keep cuts the kept subtree to ``keep`` nodes:
    still equal to JAX, no dangling parent, creation order kept. At keep=8
    (JAX's case) the uniform evaluator's subtrees fit (4 nodes); at keep=2
    every advance cuts."""
    sims = 24
    capacity = sims + keep
    cut = []

    def check(tree, free, ply, stage):
        parent = tree.parent[0].numpy()
        linked = np.nonzero(parent >= 0)[0]
        count = int(free[0])
        assert (parent[linked] < linked).all()
        assert (linked < count).all()
        if stage == "advance":
            assert count <= keep
            cut.append(count == keep)

    drive([play_random_board(3, 2)], uniform_eval_batch, torch_uniform,
          sims=sims, capacity=capacity, plies=6, check=check)
    assert all(cut) == (keep == 2)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["plain", "continuous"])
def test_selfplay_with_reuse_matches_jax(continuous):
    """``make_selfplay_fn`` with reuse, deterministic moves: samples and
    stats byte-equal to JAX's (5x4 connect-3, the row-dyadic evaluator)."""
    _assert_matches_jax(
        dict(simulations=12, reuse_tree=True, greedy_from_move=0),
        dict(continuous=continuous, discount=0.5,
             exclude_draws=not continuous),
        fused=None, batch=8, max_plies=20,
    )


@pytest.mark.parametrize("override, match", [
    (dict(topk_actions=3), "full-width priors"),
    (dict(use_gumbel=True), "Gumbel"),
    ("fused", "fused"),
])
def test_reuse_rejections(override, match):
    """Compressing top-K priors, Gumbel search and the fused kernel are
    refused with reuse, as JAX refuses them."""
    cfg = dict(simulations=8, reuse_tree=True)
    fused = None
    if override == "fused":
        fused = True
    else:
        cfg.update(override)
    with pytest.raises(ValueError, match=match):
        make_selfplay_fn(ENV, MCTSConfig(**cfg), SelfPlayConfig(), 4,
                         device="cpu", fused=fused)


def test_search_tree_refuses_top_k_trees():
    mcts = MCTS(ENV, MCTSConfig(simulations=4, topk_actions=3))
    tree = mcts.search(ENV.init(2, "cpu"), torch_uniform, None, 4)
    with pytest.raises(ValueError, match="full-width"):
        mcts.search_tree(tree, torch.ones(2, dtype=torch.int32),
                         torch_uniform, None, 4)
    with pytest.raises(ValueError, match="full-width"):
        mcts.advance_root(tree, torch.zeros(2, dtype=torch.long), 2,
                          ENV.init(2, "cpu"))


def test_search_tree_refuses_an_overfull_tree():
    """A tree without room for the search's new nodes raises (JAX would
    drop the overflowing nodes silently)."""
    mcts = MCTS(ENV, MCTSConfig(simulations=4))
    tree = mcts.init_tree(ENV.init(2, "cpu"), 6)
    with pytest.raises(ValueError, match="slots"):
        mcts.search_tree(tree, torch.tensor([1, 3], dtype=torch.int32),
                         torch_uniform, None, 4)
    mcts.search_tree(tree, torch.tensor([1, 2], dtype=torch.int32),
                     torch_uniform, None, 4)
