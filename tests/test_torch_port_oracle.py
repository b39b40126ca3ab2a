"""The port's solver oracle and strength tool against the JAX package's.

Scores from the library and the CLI, the oracle API, the opening book, the
solve cache in both directions, the oracle evaluator inside the general
search, ``score_arena_log``, ``evaluate_strength`` and
``labeled_policy_accuracy``, all on the same numpy-seeded inputs. Exact
unless a tolerance is stated. Only positions from ply 12 on are solved
(near the opening a solve costs seconds). Every solver here keeps its cache
in the test's temporary directory.
"""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu import solver as jsv
from custom_alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu.tools import strength as jstrength
from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch import solver as sv
from custom_alphazero_tpu_torch.config import (
    ArenaConfig,
    Config,
    MCTSConfig,
    ModelConfig,
    apply_overrides,
    from_json,
    to_json,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.io.checkpoint import save_checkpoint
from custom_alphazero_tpu_torch.models.convert import train_state_to_jax
from custom_alphazero_tpu_torch.runtime.arena import make_arena_fn
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools import strength
from tests.test_torch_port_search import _pair

REPO = os.path.join(os.path.dirname(__file__), "..")
C4R5 = os.path.join(REPO, "artifacts", "c4-r5")
EVAL_LABELS = os.path.join(REPO, "data", "eval_labels.npz")
WIN_IN_ONE = [3, 0, 3, 0, 3, 1]  # the side to move wins in column 3


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("CAZ_SOLVER_CACHE", str(tmp_path / "cache.npz"))


def random_positions(n, seed, lo=12, hi=30):
    """``n`` live positions after ``lo``..``hi`` uniform random plies, as
    (1-indexed move string, canonical board)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        plies = int(rng.integers(lo, hi + 1))
        board, moves, ended = np.zeros((6, 7), np.int8), [], False
        for _ in range(plies):
            col = int(rng.choice(sv.legal_columns(board)))
            board, ended = sv.play_canonical(board, col)
            if ended:
                break
            moves.append(col)
        if not ended:
            out.append(("".join(str(c + 1) for c in moves), board))
    return out


def test_scores_match_jax_library_and_cli():
    """200 positions at plies 12-30: the port's library and CLI give JAX's
    scores; the CLIs print the same position, score and node count."""
    positions = random_positions(200, seed=0)
    stdin = "".join(m + "\n" for m, _ in positions)
    # Both CLIs solve in the background while the library solves here.
    clis = [subprocess.Popen([path, "-b", sv.DEFAULT_BOOK],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True)
            for path in (sv.cli_path(), jsv.cli_path())]
    for proc in clis:
        proc.stdin.write(stdin)
        proc.stdin.close()
    solver = sv.ConnectFourSolver(cache=None)
    library = [solver.solve_moves(m) for m, _ in positions]
    assert [solver.solve_board(b) for _, b in positions] == library
    port_out, jax_out = (proc.stdout.read().splitlines() for proc in clis)
    for proc in clis:
        assert proc.wait(timeout=120) == 0
    assert len(port_out) == len(jax_out) == len(positions)
    for (moves, _), score, mine, ref in zip(positions, library, port_out,
                                            jax_out):
        assert mine.split(" ")[:3] == ref.split(" ")[:3]
        assert mine.split(" ")[:2] == [moves, str(score)]
    assert sv.target_path("cli").parent == sv.BUILD_DIR
    assert sv.target_path("lib").parent == sv.BUILD_DIR


def test_oracle_api_matches_jax():
    mine = sv.ConnectFourSolver(cache=None)
    ref = jsv.ConnectFourSolver(cache=None)
    for _, board in random_positions(30, seed=1, lo=14):
        ranked, value = mine.ranked_moves_and_value(board)
        assert (ranked, value) == ref.ranked_moves_and_value(board)
        policy, value = mine.policy_and_value(board)
        ref_policy, ref_value = ref.policy_and_value(board)
        np.testing.assert_array_equal(policy, ref_policy)
        assert value == ref_value
        for col in sv.legal_columns(board):
            assert mine.move_rank_score(board, col) == ref.move_rank_score(
                board, col)
    assert sv.legal_columns(board) == jsv.legal_columns(board)
    assert sv.board_to_bitboard(board) == jsv.board_to_bitboard(board)
    assert sv._board_has_win(board) == jsv._board_has_win(board)
    with pytest.raises(ValueError):
        mine.solve_moves("1111111")  # column overflow
    with pytest.raises(ValueError):
        sv.board_to_bitboard(np.zeros((5, 7), np.int8))


def test_book_is_jax_book():
    with open(sv.DEFAULT_BOOK, "rb") as fp, open(jsv.DEFAULT_BOOK, "rb") as ref:
        data = fp.read()
        assert data == ref.read()
    assert len(data) == 513_061 and data[:4] == b"C4BK"
    mine, ref = sv.ConnectFourSolver(cache=None), jsv.ConnectFourSolver(
        cache=None)
    assert mine.book_depth == ref.book_depth == 16
    for line in ("", "4", "44", "4455", "445566", "44455556"):
        assert mine.solve_moves(line) == ref.solve_moves(line), line
    assert mine.solve_moves("") == 1  # a book probe: instant


def test_solve_cache_is_shared_with_jax(tmp_path):
    boards = [b for _, b in random_positions(6, seed=2, lo=12, hi=16)]
    mine = sv.ConnectFourSolver(cache=str(tmp_path / "port.npz"))
    scores = [mine.solve_board(b) for b in boards]
    mine.flush_cache()
    assert jsv.ConnectFourSolver(cache=str(tmp_path / "port.npz"))._cache \
        == mine._cache
    ref = jsv.ConnectFourSolver(cache=str(tmp_path / "jax.npz"))
    assert [ref.solve_board(b) for b in boards] == scores
    ref.flush_cache()
    back = sv.ConnectFourSolver(cache=str(tmp_path / "jax.npz"))
    assert back._cache == ref._cache == mine._cache and len(back._cache) == 6
    # "auto" reads $CAZ_SOLVER_CACHE (here a temporary file).
    assert sv.ConnectFourSolver()._cache_path == os.environ["CAZ_SOLVER_CACHE"]
    # Positions past CACHE_MAX_PLIES are never cached.
    deep = sv.ConnectFourSolver(cache=str(tmp_path / "deep.npz"))
    deep.solve_board(random_positions(1, seed=3, lo=20, hi=20)[0][1])
    deep.flush_cache()
    assert not os.path.exists(tmp_path / "deep.npz")


def test_build_goes_to_build_dir_and_failures_raise(tmp_path, monkeypatch):
    lib = sv.target_path("lib")
    assert sv.build("lib") == str(lib) and lib.parent.parts[-2:] == ("build", "solver")
    # The name moves with the source, so an edited solver is rebuilt.
    broken = tmp_path / "c4solver.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(sv, "SRC", broken)
    monkeypatch.setattr(sv, "BUILD_DIR", tmp_path / "build")
    assert sv.target_path("lib") != lib
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        sv.build("cli")
    assert os.listdir(tmp_path / "build") == []  # no half-written file
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        sv.build("lib")


def _win_in_one_states(jenv, env):
    jstate, state = jenv.init(), env.init(1, "cpu")
    for col in WIN_IN_ONE:
        jstate, _ = jenv.step(jstate, jnp.int32(col))
        state, _ = env.step(state, torch.tensor([col]))
    return jax.tree.map(lambda x: x[None], jstate), state


def test_oracle_evaluator_in_the_general_search_matches_jax():
    jenv, env, jcfg, cfg = _pair({}, simulations=16)
    jstates, states = _win_in_one_states(jenv, env)
    jmcts, mcts = JaxMCTS(jenv, jcfg), MCTS(env, cfg)
    jtree = jmcts.search(jstates, jsv.make_solver_evaluate_fn(7),
                         jax.random.PRNGKey(0), 16)
    oracle = sv.make_solver_evaluate_fn(7)
    tree = mcts.search(states, oracle, None, 16)
    for mine, ref in ((mcts.root_child_visits(tree),
                       jmcts.root_child_visits(jtree)),
                      (mcts.root_child_value_sums(tree),
                       jmcts.root_child_value_sums(jtree))):
        ref = np.array(ref)
        assert mine.dtype == torch.from_numpy(ref).dtype
        np.testing.assert_array_equal(mine.numpy().view(np.int32),
                                      ref.view(np.int32))
    assert int(mcts.root_child_visits(tree)[0].argmax()) == 3
    # The oracle's outputs are dyadic: one-hot policies, values in -1/0/1;
    # a finished board gets zeros.
    won, _ = env.step(states, torch.tensor([3]))
    obs = torch.cat([env.observe(states), env.observe(won)])
    probs, values = oracle(obs)
    assert probs.dtype == values.dtype == torch.float32
    assert probs.tolist() == [[0, 0, 0, 1, 0, 0, 0], [0] * 7]
    assert values.tolist() == [1.0, 0.0]


def test_score_arena_log_matches_jax():
    """One log from the port's arena on the CPU (12 games of random moves),
    scored by both packages from ply 14 with at most 20 positions."""
    env = ConnectN()
    arena = make_arena_fn(env, ArenaConfig(), MCTSConfig(), 42, device="cpu")

    def uniform(obs):
        return torch.full((obs.shape[0], 7), 1 / 7), torch.zeros(obs.shape[0])

    log = arena(uniform, uniform, torch.Generator().manual_seed(0), 12).log
    host = type(log)(*(t.numpy() for t in log))
    scoreable = host.active[14:] & (host.movers[14:] == 0)
    assert scoreable.sum() > 20  # the sample is drawn
    mine = strength.score_arena_log(log, min_ply=14, max_positions=20)
    ref = jstrength.score_arena_log(host, min_ply=14, max_positions=20)
    assert mine == ref and 0.0 < mine <= 1.0


def _uniform_pair():
    def jax_uniform(obs):
        return jnp.ones((obs.shape[0], 7)) / 7, jnp.zeros((obs.shape[0],))

    def uniform(obs):
        return torch.ones((obs.shape[0], 7)) / 7, torch.zeros(obs.shape[0])

    return jax_uniform, uniform


@pytest.mark.parametrize("opponent", ["random", "perfect"])
@pytest.mark.parametrize("use_mcts", [False, True], ids=["raw", "mcts"])
def test_evaluate_strength_matches_jax(use_mcts, opponent):
    jenv, env, _, _ = _pair({})
    jax_uniform, uniform = _uniform_pair()
    kwargs = dict(num_games=2, use_mcts=use_mcts, opponent=opponent, seed=4,
                  opening_plies=12)
    ref = jstrength.evaluate_strength(
        jenv, jax_uniform, mcts_cfg=JaxMCTSConfig(simulations=12), **kwargs)
    mine = strength.evaluate_strength(
        env, uniform, mcts_cfg=MCTSConfig(simulations=12), device="cpu",
        **kwargs)
    assert mine == ref and mine["positions"] > 0


def _write_run(results, run_id, config_text, best=None, last=None):
    run_dir = paths.run_path(str(results), "connect_n", run_id)
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, paths.CONFIG_FILE), "w") as fp:
        fp.write(config_text)
    if best is not None:
        shutil.copytree(best, paths.evaluation_iteration_path(
            str(results), "connect_n", run_id, 11600))
    if last is not None:
        shutil.copytree(last, paths.training_path(str(results), "connect_n",
                                                  run_id))


def test_labeled_policy_accuracy_and_load_run_model_match_jax(tmp_path):
    """The committed c4-r5 net (written by the JAX package) in float32 on
    the first 256 labelled positions: the same moves and value categories,
    so equal accuracies; the value correlation and the per-class means
    within 2e-5, the float32 bound of the two nets' values on these weights
    (tests/test_torch_port_net.py); the means differ by 1.6e-6 here."""
    with open(os.path.join(C4R5, "config.json")) as fp:
        cfg = apply_overrides(from_json(fp.read()),
                              {"model.compute_dtype": "float32"})
    _write_run(tmp_path, "r5", to_json(cfg),
               best=os.path.join(C4R5, "iteration_11600"))
    with np.load(EVAL_LABELS) as data:
        labels = {k: data[k][:256] for k in ("obs", "optimal", "z")}
    np.savez(tmp_path / "labels.npz", **labels)

    _, evaluate_fn, loaded, meta = strength.load_run_model(
        "r5", str(tmp_path), device="cpu")
    _, jax_evaluate, _, jax_meta = jstrength.load_run_model("r5",
                                                            str(tmp_path))
    assert loaded == cfg and meta == jax_meta and meta["iteration"] == 11600
    mine = strength.labeled_policy_accuracy(
        evaluate_fn, str(tmp_path / "labels.npz"), device="cpu")
    ref = jstrength.labeled_policy_accuracy(jax_evaluate,
                                            str(tmp_path / "labels.npz"))
    assert mine.keys() == ref.keys() and mine["positions"] == 256
    for key in ("move_accuracy", "value_accuracy", "value_sign_accuracy"):
        assert mine[key] == ref[key], key
    assert abs(mine["value_corr"] - ref["value_corr"]) <= 2e-5
    assert mine["value_mean_by_class"].keys() == ref[
        "value_mean_by_class"].keys()
    for c, value in mine["value_mean_by_class"].items():
        assert abs(value - ref["value_mean_by_class"][c]) <= 2e-5
    with pytest.raises(FileNotFoundError, match="missing sentinel"):
        strength.load_run_model("r5", str(tmp_path), which="last",
                                device="cpu")


def test_load_run_model_reads_a_port_run(tmp_path):
    model = ModelConfig(depth=1, filters=8, value_hidden=16,
                        compute_dtype="float32")
    cfg = apply_overrides(Config(), {"model.depth": "1", "model.filters": "8",
                                     "model.value_hidden": "16",
                                     "model.compute_dtype": "float32"})
    state = init_train_state(7, model, torch.Generator().manual_seed(0),
                             (6, 7, 4), device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), train_state_to_jax(state, model),
                    0.01)
    _write_run(tmp_path, "tiny", to_json(cfg), best=tmp_path / "ckpt",
               last=tmp_path / "ckpt")
    obs = torch.from_numpy(np.random.default_rng(0).random(
        (4, 6, 7, 4)).astype(np.float32))
    want = make_evaluate_fn(state.net.eval())(obs)
    for which in ("best", "last"):
        _, evaluate_fn, loaded, meta = strength.load_run_model(
            "tiny", str(tmp_path), which=which, device="cpu")
        assert loaded == cfg and meta["steps"] == 0
        for got, ref in zip(evaluate_fn(obs), want):
            assert torch.equal(got, ref)


def test_strength_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_run(tmp_path, "r", to_json(Config()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        strength.main([f"--results_dir={tmp_path}", "--run_id=r"])
    with pytest.raises(FileNotFoundError, match="No promoted model"):
        strength.load_run_model("r", str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="Chess engine"):
        strength.load_run_model("r", str(tmp_path), game="chess")
    # main() parses the JAX tool's flags.
    seen = {}
    _, uniform = _uniform_pair()
    monkeypatch.setattr(strength, "load_run_model", lambda *a: (
        ConnectN(), uniform, Config(), {"steps": 7, "iteration": 3}))
    monkeypatch.setattr(strength, "evaluate_strength", lambda *a, **k: (
        seen.update(k) or {"results": [1, 0, -1], "positions": 5}))
    strength.main(["--run_id=r", "--games=3", "--sims=9", "--raw_policy=true",
                   "--opponent=perfect", "--seed=2"])
    assert seen["num_games"] == 3 and seen["use_mcts"] is False
    assert seen["mcts_cfg"].simulations == 9
    assert (seen["opponent"], seen["seed"]) == ("perfect", 2)
    out = capsys.readouterr().out
    assert "steps=7, iteration=3" in out and "W/D/L=(1, 1, 1)" in out
