"""Chess through the port's general search, net and learner loop.

- The top-K PUCT search on chess (tests/test_topk_search.py's cases, with
  JAX's root noise injected) against JAX's: root visits and value sums
  equal, every integer tree field equal, priors within 1e-6 (the 1968-wide
  renormalising sum runs in torch's order, not XLA's).
- The committed chess-r5 net (artifacts/chess-r5/iteration_2400) through
  ``models/convert.py`` against the Flax net, float32, within 2e-5.
- The chess-r5 configuration's Learner (packed generation, top-K policy
  rows, the aux value and policy labels) and a tiny chess run end to end,
  resumed from its checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ChessConfig as JaxChessConfig
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.envs.chess.engine import Chess as JaxChess
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import (
    Config,
    MCTSConfig,
    ModelConfig,
    apply_overrides,
    from_json,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_jax_checkpoint,
    load_replay,
)
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.replay.codec import PackedObs
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.loop import Learner, run
from custom_alphazero_tpu_torch.search.mcts import MCTS
from tests.test_topk_search import _pseudo_net
from tests.test_torch_port_chess import to_torch
from tests.test_torch_port_gumbel import _through_jax

REPO = os.path.join(os.path.dirname(__file__), "..")
CHESS_R5 = os.path.join(REPO, "artifacts", "chess-r5")
LABELS = os.path.join(REPO, "data", "chess_tactic_labels.npz")


def _three_roots(jenv):
    """tests/test_topk_search.py's roots: the start and two openings."""
    s0 = jenv.init()
    legal0 = np.nonzero(np.asarray(jenv.legal_mask(s0)))[0]
    s1, _ = jenv.step(s0, jnp.int32(int(legal0[0])))
    legal1 = np.nonzero(np.asarray(jenv.legal_mask(s1)))[0]
    s2, _ = jenv.step(s1, jnp.int32(int(legal1[3])))
    return jax.tree.map(lambda a, b, c: jnp.stack([a, b, c]), s0, s1, s2)


@pytest.mark.parametrize("use_noise,fast", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_chess_topk_search_matches_jax(use_noise, fast):
    jenv, env = JaxChess(JaxChessConfig()), Chess()
    jstates = _three_roots(jenv)
    sims = 24
    cfg = dict(simulations=sims, use_dirichlet=use_noise, dirichlet_alpha=0.5,
               fast_edge_stats=fast)
    jax_evaluate = _pseudo_net(jenv)
    rng = jax.random.PRNGKey(0)
    jmcts = JaxMCTS(jenv, JaxMCTSConfig(**cfg))
    jtree = jax.jit(lambda s, r: jmcts.search(s, jax_evaluate, r, sims))(
        jstates, rng)
    gamma = None
    if use_noise:
        _, k_plan = jax.random.split(rng)
        gamma = torch.from_numpy(np.stack([
            np.asarray(jmcts.wave_noise(k_plan, w, 3)) for w in range(sims)]))
    mcts = MCTS(env, MCTSConfig(**cfg))
    assert mcts.prior_width(sims) == sims < env.num_actions
    tree = mcts.search(to_torch(jstates), _through_jax(jax_evaluate), None,
                       sims, gamma=gamma)
    for name in ("parent", "parent_action", "expanded", "is_terminal",
                 "node_count", "prior_acts", "parent_slot", "child_index",
                 "visits", "value_sum", "root_visits", "root_value_sum",
                 "value_evaluated"):
        got, want = getattr(tree, name), getattr(jtree, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    for name in ("prior", "root_prior"):
        np.testing.assert_allclose(getattr(tree, name).numpy(),
                                   np.asarray(getattr(jtree, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    for name in ("root_child_visits", "root_child_value_sums"):
        np.testing.assert_array_equal(getattr(mcts, name)(tree).numpy(),
                                      np.asarray(getattr(jmcts, name)(jtree)))
    assert int(tree.node_count.min()) > 1


def test_chess_r5_net_matches_flax():
    """The committed chess net, float32, on observations of random games."""
    params, batch_stats, meta = load_jax_checkpoint(
        os.path.join(CHESS_R5, "iteration_2400"))
    assert meta["steps"] == 2400
    widths = dict(depth=4, filters=128, value_hidden=256,
                  compute_dtype="float32")
    env = Chess()
    state = env.init(6, "cpu")
    rng = np.random.default_rng(0)
    for _ in range(7):
        legal = env.legal_mask(state).numpy()
        state, _ = env.step(state, torch.from_numpy(np.array(
            [rng.choice(np.nonzero(row)[0]) for row in legal])))
    obs = env.observe(state)
    logits, value = jax.device_get(
        JaxPolicyValueNet(1968, JaxModelConfig(**widths)).apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(obs.numpy()), train=False))
    net = from_jax_variables(params, batch_stats, 1968, ModelConfig(**widths),
                             in_channels=118, board_hw=(8, 8), device="cpu")
    probs, got_value = make_evaluate_fn(net)(obs)
    np.testing.assert_allclose(probs.numpy(),
                               np.asarray(jax.nn.softmax(logits, -1)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_value.numpy(), value, rtol=0, atol=2e-5)


def _chess_r5_tiny(tmp_path, run_id, **extra):
    """The committed chess-r5 configuration at a tiny size."""
    with open(os.path.join(CHESS_R5, "config.json")) as fp:
        cfg = from_json(fp.read())
    overrides = {
        "model.depth": "1", "model.filters": "8", "model.value_hidden": "16",
        "model.batch_size": "16", "mcts.simulations": "8",
        "self_play.games_per_generation": "4", "self_play.max_plies": "6",
        "self_play.continuous": "false", "replay.capacity": "200",
        "replay.min_size": "16", "loop.max_sample_reuse": "0",
        "loop.train_iterations_per_generation": "2",
        "loop.solver_labels_path": LABELS, "loop.solver_value_batch": "8",
        "arena.games": "4", "arena.evaluation_frequency": "2",
        "arena.checkpoint_frequency": "2",
        "run.results_dir": str(tmp_path), "run.run_id": run_id,
    }
    overrides.update(extra)
    return apply_overrides(cfg, overrides)


def test_chess_r5_learner_pieces(tmp_path):
    """The chess-r5 Learner: Gumbel generation packed ply by ply, top-K
    policy rows in the ring, the aux value and policy labels."""
    cfg = _chess_r5_tiny(tmp_path, "pieces")
    assert cfg.mcts.use_gumbel and cfg.replay.policy_topk == 128
    learner = Learner(cfg, device="cpu")
    assert isinstance(learner.env, Chess)
    assert learner.policy_codec is not None
    assert learner.solver_labels[0].shape == (1952, 8, 8, 118)
    assert learner.solver_labels_pi.shape == (1952, 1968)
    batch, stats = learner.generate()
    assert isinstance(batch.obs, PackedObs)
    assert batch.obs.words.shape == (24, 8 * 8 * 116 // 32)
    assert batch.obs.scalars.shape == (24, 2)
    ring = learner.replay_add(learner.init_replay(), batch)
    assert int(ring.size) == 24
    obs, pi, z = learner.replay_sample(ring)
    assert obs.shape == (16, 8, 8, 118) and pi.shape == (16, 1968)
    torch.testing.assert_close(pi.sum(-1), torch.ones(16), rtol=0, atol=1e-5)
    metrics = learner.train_step(obs, pi, z)
    assert all(np.isfinite(float(x)) for x in (
        metrics.loss, metrics.solver_value_loss, metrics.solver_policy_loss))
    result = learner.run_arena()
    assert int(result.wins + result.losses + result.draws) == 4


def test_chess_run_end_to_end_and_resume(tmp_path, capsys):
    cfg = _chess_r5_tiny(tmp_path, "c1")
    summary = run(cfg, generations=2, device="cpu")
    assert summary["iterations"] == 4
    assert summary["last_arena_score"] is not None
    out = capsys.readouterr().out
    assert "[iter 4] arena score=" in out and "solver aux policy" in out
    training = paths.training_path(str(tmp_path), "chess", "c1")
    tree, meta = load_checkpoint(training)
    replay = load_replay(training)
    assert meta["steps"] == 4 == int(tree["steps"])
    assert int(replay["size"]) == 48
    assert replay["policy"]["indices"].shape[1] == 128

    summary = run(cfg, generations=1, device="cpu")
    assert summary["iterations"] == 6
    out = capsys.readouterr().out
    assert "Resumed training state at step 4 (replay=48)" in out
    assert "Restored best model from iteration 4" in out


def test_chess_config_defaults_match_jax():
    """make_env and max_game_plies for chess, as in JAX."""
    from custom_alphazero_tpu.runtime import loop as jax_loop
    from custom_alphazero_tpu_torch.runtime import loop as port_loop

    cfg = apply_overrides(Config(), {"game": "chess"})
    assert port_loop.max_game_plies(cfg) == 512 == jax_loop.max_game_plies(
        jax_loop.Config(game="chess"))
    env = port_loop.make_env(cfg)
    assert env.num_actions == 1968 and env.obs_shape == (8, 8, 118)
    assert env.obs_scalar_channels == (116, 117)
