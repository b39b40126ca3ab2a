"""The port's arena against the JAX package's: with moves made
deterministic (torch cannot replay JAX's sampling stream) the game logs,
per-game results, score and promotion are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ArenaConfig as JaxArenaConfig
from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.runtime.arena import (
    make_arena_fn as jax_make_arena_fn,
)
from custom_alphazero_tpu.runtime.train import (
    make_evaluate_fn as jax_make_evaluate_fn,
)
from custom_alphazero_tpu_torch.config import (
    ArenaConfig,
    ConnectNConfig,
    MCTSConfig,
    ModelConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.runtime import arena as arena_module
from custom_alphazero_tpu_torch.runtime.arena import make_arena_fn
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn

ENV = ConnectN(ConnectNConfig())
JENV = JaxConnectN(JaxConnectNConfig())
A = 7
SMALL = dict(depth=1, filters=8, value_hidden=16, compute_dtype="float32")


def _run_both(arena_kwargs, mcts_kwargs, evaluators, jax_evaluators, games,
              max_plies):
    ref = jax.jit(lambda k: jax_make_arena_fn(
        JENV, JaxArenaConfig(**arena_kwargs), JaxMCTSConfig(**mcts_kwargs),
        max_plies)(*jax_evaluators, k, games))(jax.random.PRNGKey(0))
    got = make_arena_fn(ENV, ArenaConfig(**arena_kwargs),
                        MCTSConfig(**mcts_kwargs), max_plies, device="cpu")(
        *evaluators, torch.Generator().manual_seed(0), games)
    return got, jax.device_get(ref)


def _assert_results_equal(got, ref):
    for name in ("actions", "movers", "active"):
        np.testing.assert_array_equal(getattr(got.log, name).numpy(),
                                      getattr(ref.log, name), err_msg=name)
    np.testing.assert_array_equal(got.per_game.numpy(), ref.per_game)
    for name in ("wins", "losses", "draws"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    assert float(got.score) == float(ref.score)
    assert bool(got.promote) == bool(ref.promote)
    assert got.log.actions.dtype == torch.int32
    assert got.per_game.dtype == torch.int32


def _tagged(col, lib, seen=None):
    """An evaluator that always prefers column ``col``."""
    def evaluate(obs):
        b = obs.shape[0]
        if seen is not None:
            seen.append(b)
        if lib is torch:
            probs = torch.full((b, A), 1e-6)
            probs[:, col] = 1.0
            return probs, torch.zeros(b)
        return (jnp.full((b, A), 1e-6).at[:, col].set(1.0), jnp.zeros((b,)))

    return evaluate


def _row_dyadic(lib, shift):
    """A dyadic evaluator that also depends on the row within its batch, so
    the games of a half differ; ``shift`` tells the two models apart."""
    def evaluate(obs):
        if lib is torch:
            stones = (obs[..., 1] + obs[..., 2]).sum(dim=(1, 2))
            row = torch.arange(obs.shape[0], dtype=torch.float32)[:, None]
            a = torch.arange(A, dtype=torch.float32)[None, :]
            mod = torch.remainder
        else:
            stones = jnp.sum(obs[..., 1] + obs[..., 2], axis=(1, 2))
            row = jnp.arange(obs.shape[0], dtype=jnp.float32)[:, None]
            a = jnp.arange(A, dtype=jnp.float32)[None, :]
            mod = jnp.mod
        probs = (1.0 + mod(stones[:, None] + a * (1 + shift) + row, 4.0)) / 16
        return probs, (stones - 2.0 * mod(row[:, 0] + shift, 3.0)) / 64.0

    return evaluate


@pytest.mark.parametrize("games", [16, 9], ids=["even", "odd"])
def test_each_model_moves_only_its_games(games):
    """Tagged evaluators: the played action always matches the movers log,
    as in JAX. With an even count each model forwards half the batch per
    ply; with an odd count both forward all of it."""
    seen = []
    got, ref = _run_both(
        dict(evaluate_with_mcts=False, deterministic=True), {},
        (_tagged(1, torch, seen), _tagged(5, torch, seen)),
        (_tagged(1, jnp), _tagged(5, jnp)), games, 12)
    live = got.log.active.numpy()
    want = np.where(got.log.movers.numpy() == 0, 1, 5)
    assert (got.log.actions.numpy()[live] == want[live]).all()
    assert set(seen) == ({games // 2} if games % 2 == 0 else {games})
    _assert_results_equal(got, ref)
    movers = got.log.movers.numpy()
    if games % 2 == 0:
        assert (movers[0, :games // 2] == 0).all()
        assert (movers[0, games // 2:] == 1).all()
    else:
        assert (movers[0] == np.arange(games) % 2).all()
    assert (movers[1:] == 1 - movers[:-1]).all()
    assert (live[1:] <= live[:-1]).all()  # active masks are prefixes


def test_raw_policy_games_of_two_nets_equal_jax():
    obs = np.random.default_rng(0).random((8, 6, 7, 4)).astype(np.float32)
    jnet = JaxPolicyValueNet(A, JaxModelConfig(**SMALL))
    variables = [jax.device_get(jnet.init(jax.random.PRNGKey(seed),
                                          jnp.asarray(obs[:1]), train=False))
                 for seed in (1, 2)]
    jevaluate = jax_make_evaluate_fn(jnet)
    jax_evaluators = [
        (lambda o, v=v: jevaluate(v["params"], v["batch_stats"], o))
        for v in variables]
    evaluators = [make_evaluate_fn(from_jax_variables(
        v["params"], v["batch_stats"], A, ModelConfig(**SMALL), device="cpu"))
        for v in variables]
    got, ref = _run_both(dict(evaluate_with_mcts=False, deterministic=True),
                         {}, evaluators, jax_evaluators, 16, 42)
    _assert_results_equal(got, ref)
    assert int(got.wins + got.losses + got.draws) == 16
    assert int(got.log.active.sum()) >= 16 * 7


@pytest.mark.parametrize("games", [12, 7], ids=["even", "odd"])
def test_mcts_mode_equals_jax_on_dyadic_evaluators(games):
    """MCTS mode, root noise off, deterministic moves: the port's fused
    search (its plain version on the CPU) against JAX's general search."""
    got, ref = _run_both(
        dict(evaluate_with_mcts=True, deterministic=True),
        dict(simulations=10, greedy_from_move=3),
        (_row_dyadic(torch, 0), _row_dyadic(torch, 1)),
        (_row_dyadic(jnp, 0), _row_dyadic(jnp, 1)), games, 42)
    _assert_results_equal(got, ref)
    actions = got.log.actions.numpy()
    assert len({tuple(actions[:, g]) for g in range(games)}) > 2
    assert int(got.wins + got.losses) > 0


def test_mcts_mode_greedy_is_strict_and_general_search_agrees():
    """At fullmove == greedy_from_move the arena still plays from the visit
    distribution (strict ``>``); with sampled moves the fused search and
    the general one (a config the fused search rejects: ``max_nodes``) give
    the same games from one generator seed."""
    results = []
    for max_nodes in (0, 8):
        arena = make_arena_fn(
            ENV, ArenaConfig(evaluate_with_mcts=True),
            MCTSConfig(simulations=8, greedy_from_move=2,
                       max_nodes=max_nodes), 10, device="cpu")
        results.append(arena(_row_dyadic(torch, 0), _row_dyadic(torch, 1),
                             torch.Generator().manual_seed(3), 8))
    for name in ("actions", "movers", "active"):
        assert torch.equal(getattr(results[0].log, name),
                           getattr(results[1].log, name)), name
    assert torch.equal(results[0].per_game, results[1].per_game)


def _uniform(obs):
    return torch.full((obs.shape[0], A), 1.0 / A), torch.zeros(obs.shape[0])


def _strong(obs):
    probs = torch.full((obs.shape[0], A), 0.02)
    probs[:, 3] = 0.88
    return probs, torch.zeros(obs.shape[0])


@pytest.mark.parametrize("kwargs, promote", [
    (dict(), False),
    (dict(min_decisives=4, promote_when_inconclusive=True), True),
    (dict(min_decisives=4, promote_when_inconclusive=False), False),
    (dict(promote_threshold=0.5), True),
], ids=["reference_gate", "inconclusive_promotes", "inconclusive_keeps",
        "threshold_admits_half"])
def test_draws_only_series_scores_half(kwargs, promote):
    """A series cut at 6 plies cannot be won: every game draws, the score
    is 0.5, and ``min_decisives`` / ``promote_when_inconclusive`` decide."""
    arena = make_arena_fn(ENV, ArenaConfig(**kwargs),
                          MCTSConfig(simulations=4), 6, device="cpu")
    result = arena(_uniform, _uniform, torch.Generator().manual_seed(0), 8)
    assert int(result.draws) == 8 and float(result.score) == 0.5
    assert bool(result.promote) == promote
    assert result.per_game.tolist() == [0] * 8


def test_min_decisives_defers_to_threshold_on_a_conclusive_series():
    arena = make_arena_fn(
        ENV, ArenaConfig(promote_threshold=0.55, min_decisives=4,
                         promote_when_inconclusive=False),
        MCTSConfig(simulations=8), 42, device="cpu")
    gen = torch.Generator().manual_seed(0)
    win = arena(_strong, _uniform, gen, 64)
    lose = arena(_uniform, _strong, gen, 64)
    assert int(win.wins) + int(win.losses) >= 4
    assert int(win.wins + win.losses + win.draws) == 64
    assert float(win.score) > 0.5 > float(lose.score)
    assert bool(win.promote) and not bool(lose.promote)
    assert float(win.score) == pytest.approx(
        int(win.wins) / (int(win.wins) + int(win.losses)))


def test_mixed_evaluators_are_built_once_per_pair(monkeypatch):
    """The fused search caches its CUDA graph per evaluator object, so the
    arena must hand it the same two mixed evaluators (even ply, odd ply) on
    every ply of every arena of one pair of models."""
    built = []
    seen = set()
    original = arena_module._mixed_evaluators

    def counting(*args):
        built.append(args[:2])
        return original(*args)

    monkeypatch.setattr(arena_module, "_mixed_evaluators", counting)

    class Search:
        def __init__(self, *args):
            pass

        def search_root_stats(self, states, evaluate_fn, generator, sims):
            seen.add(evaluate_fn)
            visits = torch.zeros(states.board.shape[0], A, dtype=torch.int32)
            visits[:, 3] = sims
            return visits, None

    monkeypatch.setattr(arena_module.fused_mcts_v2, "FusedConnectNSearchV2",
                        Search)
    arena = make_arena_fn(ENV, ArenaConfig(evaluate_with_mcts=True),
                          MCTSConfig(simulations=4), 6, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        arena(_uniform, _strong, gen, 8)
    assert len(built) == 1 and len(seen) == 2
    arena(_strong, _uniform, gen, 8)  # another pair: two more
    assert len(built) == 2 and len(seen) == 4


def test_arena_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_arena_fn(ENV, ArenaConfig(), MCTSConfig(), 6)
