"""The port's chess tools against the JAX package's.

- ``_greedy_scores`` equal on random boards (integer-exact).
- The tactics labels recomputed from the committed sets equal their stored
  masks; a generated set's labels are real mates in JAX's engine.
- ``evaluate_tactics`` raw and searched (uniform evaluator) and the
  ``chess_tactics`` CLI with a tiny chess net equal to JAX's.
- ``--export_labels`` equal to JAX's export, and to the committed
  data/chess_tactic_labels.npz from the four sets that produced it.
- ``play_vs_opponent``'s counts (its random streams are torch's).
- The throughput probes' CLIs on the CPU.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ChessConfig as JaxChessConfig
from custom_alphazero_tpu.envs.chess.engine import Chess as JaxChess
from custom_alphazero_tpu.tools import chess_strength as jchess_strength
from custom_alphazero_tpu.tools import chess_tactics as jchess_tactics
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.tools import (
    bench_chess,
    chess_inloop_bench,
    chess_strength,
    chess_tactics,
    profile_chess,
    strength,
)
from tests.test_torch_port_evaltools import _jax_run

REPO = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(REPO, "data")
MATE1 = os.path.join(DATA, "chess_tactics_300.npz")
MATE2 = os.path.join(DATA, "chess_mate2_300.npz")
# The sets behind data/chess_tactic_labels.npz, in its row order.
AUX_SOURCES = ["chess_tactics_3k.npz", "chess_tactics_b2.npz",
               "chess_mate2_1500.npz", "chess_mate2_b2.npz"]
ENV = Chess()




def _rows(src, n, path):
    """The first ``n`` rows of a tactics set, written to ``path``."""
    with np.load(src) as data:
        np.savez(path, **{k: data[k][:n] for k in data})
    return str(path)


def _jax_uniform(obs):
    return (jnp.ones((obs.shape[0], 1968)) / 1968,
            jnp.zeros((obs.shape[0],)))


def test_greedy_scores_match_jax():
    """Random canonical boards (pieces -6..6): equal float32 scores, and
    the queen-takes-rook case of tests/test_chess_tools.py."""
    rng = np.random.default_rng(0)
    boards = rng.integers(-6, 7, (32, 64)).astype(np.int8)
    mine = chess_strength._greedy_scores(torch.from_numpy(boards))
    ref = np.asarray(jchess_strength._greedy_scores(jnp.asarray(boards)))
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), ref)
    board = np.zeros((8, 8), np.int8)
    board[0, 4], board[7, 7], board[3, 3], board[6, 3] = 6, -6, 5, -4
    state = ENV.state_from_arrays(board, [False] * 4, -1, 0, 10, "cpu")
    scores = chess_strength._greedy_scores(state.board.reshape(1, 64))[0]
    best = int(torch.where(state.legal[0], scores, -1e9).argmax())
    assert chess_strength.T.ACTION_UCI[best] == "d4d7"


@pytest.mark.parametrize("src,rows,fn,key", [
    (MATE1, 16, "mate_in_1_labels", "mate_mask"),
    (MATE2, 4, "mate_in_2_labels", "mate2_mask"),
], ids=["mate_in_1", "mate_in_2"])
def test_labels_equal_committed_masks(src, rows, fn, key):
    """The labels of the committed rows, recomputed in one batch from their
    arrays, equal the masks that JAX's generators stored."""
    with np.load(src) as data:
        data = {k: data[k][:rows] for k in data}
    states = chess_tactics.states_from_npz(ENV, data, "cpu")
    labels, legal = getattr(chess_tactics, fn)(ENV, states)
    np.testing.assert_array_equal(labels.numpy(), data[key])
    np.testing.assert_array_equal(legal.numpy(), data["legal_mask"])
    assert labels.any(-1).all()
    # A position without a mate-in-1 has no mate-in-1 labels; one with a
    # mate-in-1 has no mate-in-2 labels.
    opening = ENV.init(1, "cpu")
    assert not getattr(chess_tactics, fn)(ENV, opening)[0].any()
    if key == "mate_mask":
        assert not chess_tactics.mate_in_2_labels(ENV, states)[0].any()


def test_generators_save_real_mates(tmp_path, monkeypatch):
    """A generated mate-in-1 set: every labeled move mates in JAX's engine,
    every other legal move does not. The mate-in-2 generator's rollout and
    bookkeeping, run with the mate-in-1 screen (mate_in_2_labels itself is
    held to the committed set above): its rows are what the screen says."""
    path = str(tmp_path / "m1.npz")
    out = chess_tactics.generate_tactics(path, positions=1, seed=2,
                                         batch=16, device="cpu")
    data = np.load(path)
    assert out["positions"] == len(data["board"]) >= 1
    jenv = JaxChess(JaxChessConfig())
    jstates = jchess_tactics.states_from_npz(jenv, data)
    jstep = jax.jit(jax.vmap(jenv.step))
    for i in range(len(data["board"])):
        acts = np.nonzero(data["legal_mask"][i])[0]
        child, _ = jstep(jax.tree.map(lambda x: x[np.full(len(acts), i)],
                                      jstates), jnp.asarray(acts, jnp.int32))
        mates = np.asarray(child.terminal & child.won)
        np.testing.assert_array_equal(acts[mates],
                                      np.nonzero(data["mate_mask"][i])[0])
    monkeypatch.setattr(chess_tactics, "mate_in_2_labels",
                        chess_tactics.mate_in_1_labels)
    path2 = str(tmp_path / "m2.npz")
    chess_tactics.generate_mate_in_2(path2, positions=2, seed=2, batch=16,
                                     device="cpu")
    data2 = np.load(path2)
    assert len(data2["board"]) == 2
    states = chess_tactics.states_from_npz(ENV, data2, "cpu")
    labels, legal = chess_tactics.mate_in_1_labels(ENV, states)
    np.testing.assert_array_equal(labels.numpy(), data2["mate2_mask"])
    np.testing.assert_array_equal(legal.numpy(), data2["legal_mask"])


@pytest.mark.parametrize("use_mcts", [False, True], ids=["raw", "searched"])
def test_evaluate_tactics_matches_jax(tmp_path, use_mcts):
    """Uniform evaluator, 8 rows of the mate-in-1 set, 16 simulations."""
    path = _rows(MATE1, 8, tmp_path / "t.npz")
    kwargs = dict(use_mcts=use_mcts, sims=16, batch=8)
    ref = jchess_tactics.evaluate_tactics(_jax_uniform, path, **kwargs)
    mine = chess_tactics.evaluate_tactics(
        chess_tactics.uniform_evaluate(1968), path, device="cpu", **kwargs)
    assert mine == ref and mine["positions"] == 8


def test_tactics_cli_with_a_chess_run_matches_jax(tmp_path, capsys):
    """load_run_model's chess branch: a tiny float32 chess net written by
    JAX, through both tools' CLIs (raw policy on 8 rows of each set)."""
    from custom_alphazero_tpu.io.checkpoint import save_checkpoint
    from custom_alphazero_tpu.models.policy_value import PolicyValueNet
    from custom_alphazero_tpu.runtime.train import init_train_state

    cfg = _jax_run(tmp_path, "c", [], game="chess")
    jenv = JaxChess(cfg.chess)
    state = init_train_state(PolicyValueNet(jenv.num_actions, cfg.model),
                             cfg.model, jax.random.PRNGKey(5),
                             jenv.obs_shape).replace(steps=12)
    save_checkpoint(str(tmp_path / "chess" / "c" / "evaluation" /
                        "iteration_12"), state, 0.01)
    for src in (MATE1, MATE2):
        path = _rows(src, 8, tmp_path / "t.npz")
        argv = [f"--labels={path}", "--run_id=c", f"--results_dir={tmp_path}"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ref = jchess_tactics.main(argv)
        mine = chess_tactics.main(argv + ["--device=cpu"])
        assert mine == ref and mine["steps"] == 12
        assert capsys.readouterr().out == out.getvalue()
    env, _, loaded, meta = strength.load_run_model(
        "c", str(tmp_path), game="chess", device="cpu")
    assert isinstance(env, Chess) and meta["iteration"] == 12
    assert loaded.model.depth == 1


def test_export_labels_matches_jax_and_committed_file(tmp_path, capsys):
    """Eight rows of each committed set through both CLIs: equal arrays.
    The four sets behind data/chess_tactic_labels.npz give its arrays."""
    sources = ",".join(_rows(src, 8, tmp_path / f"{i}.npz")
                       for i, src in enumerate((MATE1, MATE2)))
    out = {}
    for name, tool, extra in (("jax", jchess_tactics, []),
                              ("port", chess_tactics, ["--device=cpu"])):
        out[name] = str(tmp_path / f"{name}.npz")
        tool.main([f"--labels={sources}", f"--export_labels={out[name]}"]
                  + extra)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace("jax.npz", "port.npz") == printed[1]
    mine, ref = np.load(out["port"]), np.load(out["jax"])
    assert sorted(mine) == sorted(ref) == ["obs", "pi", "z"]
    for key in ref:
        assert mine[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(mine[key], ref[key])
    assert mine["obs"].shape == (16, 8, 8, 118)
    n = chess_tactics.export_labels(
        [os.path.join(DATA, name) for name in AUX_SOURCES],
        str(tmp_path / "aux.npz"), "cpu")
    mine = np.load(tmp_path / "aux.npz")
    with np.load(os.path.join(DATA, "chess_tactic_labels.npz")) as committed:
        assert n == len(committed["z"]) == 1952
        for key in committed:
            np.testing.assert_array_equal(mine[key], committed[key])


@pytest.mark.parametrize("opponent", ["random", "greedy"])
def test_play_vs_opponent_counts(opponent):
    r = chess_strength.play_vs_opponent(
        ENV, chess_tactics.uniform_evaluate(1968), opponent=opponent,
        games=2, sims=4, seed=1, max_plies=6, device="cpu")
    assert r["wins"] + r["draws"] + r["losses"] == r["games"] == 2
    assert r["opponent"] == opponent and r["sims"] == 4
    assert 0.0 <= r["score"] <= 1.0 and 0 < r["mean_game_plies"] <= 6


@pytest.mark.parametrize("tool,argv,want", [
    (bench_chess, ["--sims=2", "--device=cpu", "2"],
     ["B=2 [net]:", "B=2 [uniform]:"]),
    (profile_chess, ["--batch=2", "--sims=2", "--iters=1", "--device=cpu"],
     ['"search2_ms_per_wave"']),
    (chess_inloop_bench, ["--sims=2", "--iters=1", "--max_plies=2",
                          "--device=cpu", "2"],
     ["gumbel=False B=2 sims=2:", "gumbel=True B=2 sims=2:"]),
], ids=["bench_chess", "profile_chess", "chess_inloop_bench"])
def test_probe_clis_run_on_the_cpu(capsys, tool, argv, want):
    tool.main(argv)
    out = capsys.readouterr().out
    for text in want:
        assert text in out


@pytest.mark.parametrize("opponent", ["random", "greedy"])
def test_play_vs_opponent_from_mates_matches_a_replay(opponent):
    """Games from two mate-in-1 rows end; the tool's W/D/L and lengths
    equal a replay of the moves it played, one game at a time on the
    engine (chip_smoke.py phase 21's check, here on the CPU)."""
    import chip_smoke

    with np.load(MATE1) as data:
        rows = {k: data[k][:2] for k in data}
    r, moves = chip_smoke.played_moves(
        lambda env: chess_strength.play_vs_opponent(
            env, chess_tactics.uniform_evaluate(1968), opponent=opponent,
            games=4, sims=16, seed=1, max_plies=6,
            device="cpu"), ENV.cfg, rows)
    replayed = chip_smoke.replay_on_cpu(ENV.cfg, rows, moves)
    assert {k: r[k] for k in replayed} == replayed
    assert r["games"] == 4 and r["wins"] + r["losses"] > 0
