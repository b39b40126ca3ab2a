"""The port's Connect-4 evaluation battery against the JAX package's tools.

``run_report`` on the three committed metrics files, the ``book_from_cache``
bytes, the distillation datasets, ``final_eval`` and ``evaluate_strength``
(both search routes, both opponents) and ``lineage``, all on the same
numpy-seeded inputs; a small distillation fit; the chess-lineage KeyError
that both packages raise; the CLIs' usage errors; every new entry point on
the card unless asked otherwise. Exact unless a tolerance is stated.

The nets are float32. Their outputs differ from Flax's in the last bits
(tests/test_torch_port_net.py): moves, visits and accuracies are equal;
the value correlation and the per-class value means are held at 2e-5, as
in tests/test_torch_port_oracle.py. Every solver keeps its cache in a
temporary directory.
"""

import contextlib
import functools
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from custom_alphazero_tpu import paths as jpaths
from custom_alphazero_tpu import solver as jsv
from custom_alphazero_tpu.config import Config as JaxConfig
from custom_alphazero_tpu.config import apply_overrides as jax_overrides
from custom_alphazero_tpu.config import to_json as jax_to_json
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu.io.checkpoint import save_checkpoint as jax_save
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu.runtime.train import (
    init_train_state as jax_init_train_state,
)
from custom_alphazero_tpu.tools import book_from_cache as jbook
from custom_alphazero_tpu.tools import cli as jcli
from custom_alphazero_tpu.tools import distill as jdistill
from custom_alphazero_tpu.tools import final_eval as jfinal_eval
from custom_alphazero_tpu.tools import lineage as jlineage
from custom_alphazero_tpu.tools import run_report as jrun_report
from custom_alphazero_tpu.tools import strength as jstrength
from custom_alphazero_tpu_torch import solver as sv
from custom_alphazero_tpu_torch.config import MCTSConfig, ModelConfig
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.runtime.train import new_train_state
from custom_alphazero_tpu_torch.tools import (
    bench_chess,
    book_from_cache,
    chess_inloop_bench,
    chess_strength,
    chess_tactics,
    cli,
    distill,
    final_eval,
    lineage,
    profile_chess,
    run_report,
    strength,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
ARTIFACTS = os.path.join(REPO, "artifacts")
EVAL_LABELS = os.path.join(REPO, "data", "eval_labels.npz")
SOLVER_CACHE = os.path.join(ARTIFACTS, "solver_cache_warmed.npz")
TINY = {"model.depth": "1", "model.filters": "8", "model.value_hidden": "16",
        "model.compute_dtype": "float32"}
# float32 outputs of the two nets differ in the last bits.
VALUE_TOL = 2e-5
# Random opening plies of the searched games (the tools' default is 8):
# solving the positions of a shorter opening costs seconds each.
OPENING = 14


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("CAZ_SOLVER_CACHE", str(tmp_path / "cache.npz"))


# ---- run_report, book_from_cache -------------------------------------------

@pytest.mark.parametrize("run,game", [("c4-r4", "connect_n"),
                                      ("c4-r5", "connect_n"),
                                      ("chess-r5", "chess")])
def test_run_report_matches_jax(tmp_path, capsys, run, game):
    """The committed metrics: the same dict and the same printed lines; on
    c4-r4 the lines of the committed run_report.txt."""
    run_dir = jpaths.run_path(str(tmp_path), game, run)
    os.makedirs(jpaths.tensorboard_path(str(tmp_path), game, run))
    shutil.copy(os.path.join(ARTIFACTS, run, "metrics.jsonl"),
                jpaths.tensorboard_path(str(tmp_path), game, run))
    shutil.copy(os.path.join(ARTIFACTS, run, "config.json"), run_dir)
    argv = [f"--results_dir={tmp_path}", f"--game={game}", f"--run_id={run}"]
    ref = jrun_report.main(argv)
    ref_out = capsys.readouterr().out
    mine = run_report.main(argv)
    out = capsys.readouterr().out
    assert mine == ref and out == ref_out
    assert mine["arenas"] > 0 and "elo_history" in mine
    if run == "c4-r4":
        with open(os.path.join(ARTIFACTS, run, "run_report.txt")) as fp:
            assert out.splitlines() == fp.read().splitlines()
    assert run_report.elo_history([(10, 1.0), (20, 0.55)]) == \
        jrun_report.elo_history([(10, 1.0), (20, 0.55)])


def _board_of(current: int, mask: int) -> np.ndarray:
    """The canonical board of a solver bitboard (bit = col * 7 + row from
    the bottom; ``current`` holds the side to move's stones)."""
    board = np.zeros((6, 7), np.int8)
    for c in range(7):
        for r in range(6):
            bit = 1 << (c * 7 + r)
            if mask & bit:
                board[5 - r, c] = 1 if current & bit else -1
    return board


def test_book_from_cache_bytes_and_probes(tmp_path, capsys):
    """The committed warmed cache (57,216 keys): the port's book file is
    byte-equal to JAX's; the port's solver loads it and answers three
    probes (plies 12, 14, 16) as without a book and as the cache says."""
    mine, ref = tmp_path / "port.book", tmp_path / "jax.book"
    n = book_from_cache.main([f"--cache={SOLVER_CACHE}", f"--out={mine}"])
    assert capsys.readouterr().out == f"book: {n} entries -> {mine}\n"
    assert n == jbook.convert(SOLVER_CACHE, str(ref))
    assert mine.read_bytes() == ref.read_bytes() and n > 50_000
    data = np.load(SOLVER_CACHE)
    plies = np.array([bin(int(m)).count("1") for m in data["keys"][:, 1]])
    booked = sv.ConnectFourSolver(book=str(mine), cache=None)
    bare = sv.ConnectFourSolver(book=None, cache=None)
    assert booked.book_depth == 16
    for depth in (12, 14, 16):
        i = int(np.nonzero(plies == depth)[0][0])
        board = _board_of(*map(int, data["keys"][i]))
        assert booked.solve_board(board) == bare.solve_board(board) \
            == int(data["scores"][i])
    for current, mask in data["keys"][:200].tolist():
        assert book_from_cache.canonical_key(current, mask) == \
            jbook.canonical_key(current, mask)


# ---- distill ----------------------------------------------------------------

@pytest.mark.parametrize("dataset,kwargs", [
    ("labeled_dataset", dict(seed=5, min_ply=16)),
    ("strongline_dataset", dict(seed=6, opening_plies=16)),
])
def test_distill_datasets_byte_equal(dataset, kwargs):
    mine = getattr(distill, dataset)(
        6, solver=sv.ConnectFourSolver(cache=None), **kwargs)
    ref = getattr(jdistill, dataset)(
        6, solver=jsv.ConnectFourSolver(cache=None), **kwargs)
    assert list(mine) == list(ref) == ["obs", "pi", "z", "optimal"]
    for key in ref:
        assert mine[key].dtype == ref[key].dtype, key
        assert mine[key].tobytes() == ref[key].tobytes(), key
    assert mine["obs"].shape == (6, 6, 7, 4)


def test_run_distillation_fits_oracle_targets():
    """tests/test_distill.py's capacity check, small: a depth-1 float32 net
    fits the oracle moves of 32 labelled positions in 100 steps. Its value
    head reads 0.94 there (JAX's 0.95 bound is for 300 steps of a depth-2
    net on 64 positions), so the value bound here is 0.9."""
    data = distill.labeled_dataset(40, seed=11, min_ply=16, max_ply=30,
                                   solver=sv.ConnectFourSolver(cache=None))
    chosen = data["pi"].argmax(1)
    assert data["optimal"][np.arange(40), chosen].all()
    result = distill.run_distillation(
        {k: v[:32] for k, v in data.items()},
        {k: v[32:] for k, v in data.items()},
        ModelConfig(depth=1, filters=32, value_hidden=32,
                    compute_dtype="float32"),
        steps=100, batch_size=32, log_every=100, device="cpu",
    )
    assert result["train"]["move_accuracy"] == 1.0
    assert result["train"]["value_accuracy"] >= 0.9
    assert len(result["history"]) == 1 and result["state"].steps == 100


# ---- final_eval, evaluate_strength ------------------------------------------

def _jax_run(results, run_id, iterations, game="connect_n", extra=None):
    """A run directory written by the JAX package: a tiny float32 config
    and a promoted checkpoint per iteration (weights from PRNGKey(i + 1))."""
    cfg = jax_overrides(JaxConfig(), {**TINY, "game": game, **(extra or {})})
    jpaths.create_all_directories(str(results), game, run_id)
    with open(os.path.join(jpaths.run_path(str(results), game, run_id),
                           jpaths.CONFIG_FILE), "w") as fp:
        fp.write(jax_to_json(cfg))
    if iterations:
        env = JaxConnectN(cfg.connect_n)
        net = JaxPolicyValueNet(env.num_actions, cfg.model)
        for i, it in enumerate(iterations):
            state = jax_init_train_state(
                net, cfg.model, jax.random.PRNGKey(i + 1), env.obs_shape
            ).replace(steps=it)
            jax_save(jpaths.evaluation_iteration_path(
                str(results), game, run_id, it), state, 0.01)
    return cfg


def _labels_subset(path, n=64):
    with np.load(EVAL_LABELS) as data:
        np.savez(path, **{k: data[k][:n] for k in data})
    return str(path)


def _assert_labeled_equal(mine: dict, ref: dict) -> None:
    assert mine.keys() == ref.keys()
    for key, value in ref.items():
        if key == "value_corr":
            assert abs(mine[key] - value) <= VALUE_TOL
        elif key == "value_mean_by_class":
            assert mine[key].keys() == value.keys()
            for c, v in value.items():
                assert abs(mine[key][c] - v) <= VALUE_TOL
        else:
            assert mine[key] == value, key


FINAL_ARGS = ["--run_id=tiny", "--games=2", "--sims=8", "--seed=3"]


def _short_openings(mp, *tools) -> None:
    """The tools' evaluate_strength with OPENING-ply openings."""
    for tool, strength_module in tools:
        mp.setattr(tool, "evaluate_strength", functools.partial(
            strength_module.evaluate_strength, opening_plies=OPENING))


def _shared_cache(mp, path) -> None:
    """Both packages' solvers on one cache file, written at every new
    solve: the port then solves nothing that JAX's run solved."""
    mp.setenv("CAZ_SOLVER_CACHE", str(path))
    mp.setattr(jsv.ConnectFourSolver, "_CACHE_FLUSH_EVERY", 1)
    mp.setattr(sv.ConnectFourSolver, "_CACHE_FLUSH_EVERY", 1)


@pytest.fixture(scope="module")
def jax_final(tmp_path_factory):
    """JAX's final_eval on a tiny float32 run (64 labelled positions, 2
    games per opponent at 8 simulations, OPENING-ply openings): (results
    dir, labels, report, printed lines)."""
    results = tmp_path_factory.mktemp("final")
    _jax_run(results, "tiny", [40])
    labels = _labels_subset(results / "labels.npz")
    with pytest.MonkeyPatch.context() as mp:
        _shared_cache(mp, results / "cache.npz")
        _short_openings(mp, (jfinal_eval, jstrength))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = jfinal_eval.main(FINAL_ARGS + [
                f"--results_dir={results}", f"--labels={labels}"])
    return results, labels, report, out.getvalue().splitlines()


def test_final_eval_matches_jax(jax_final, capsys, monkeypatch):
    """The report and its printed lines; the searches took the fused route
    (K1's plain version on the CPU)."""
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2

    results, labels, ref, ref_lines = jax_final
    _shared_cache(monkeypatch, results / "cache.npz")
    _short_openings(monkeypatch, (final_eval, strength))
    calls = fused_mcts_v2.wave_step_reference.calls
    mine = final_eval.main(FINAL_ARGS + [
        f"--results_dir={results}", f"--labels={labels}", "--device=cpu"])
    captured = capsys.readouterr()
    assert fused_mcts_v2.wave_step_reference.calls > calls
    assert captured.err == "graph captures: 0\n"  # no graph on the CPU
    _assert_labeled_equal(mine.pop("raw_policy_labeled"),
                          ref["raw_policy_labeled"])
    assert mine == {k: v for k, v in ref.items() if k != "raw_policy_labeled"}
    lines = captured.out.splitlines()
    assert len(lines) == len(ref_lines) == 8
    # Line 0 prints the labelled accuracies, the last one the whole report
    # (checked above); the rest are equal.
    assert lines[1:-1] == ref_lines[1:-1]
    assert json.loads(lines[-1]).keys() == json.loads(ref_lines[-1]).keys()


@pytest.mark.parametrize("opponent", ["random", "perfect"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_evaluate_strength_routes_match_jax(jax_final, monkeypatch, fused,
                                            opponent):
    """evaluate_strength on both routes gives the JAX report of
    final_eval's run: the same moves, so the same outcomes and scores."""
    results, _, ref, _ = jax_final
    _shared_cache(monkeypatch, results / "cache.npz")
    env, evaluate_fn, _, _ = strength.load_run_model(
        "tiny", str(results), device="cpu")
    r = strength.evaluate_strength(
        env, evaluate_fn, num_games=2, use_mcts=True,
        mcts_cfg=MCTSConfig(simulations=8), opponent=opponent, seed=3,
        opening_plies=OPENING, device="cpu", fused=fused)
    want = dict(ref[f"mcts_vs_{opponent}"])
    openings = want.pop("openings")
    want.pop("wdl")
    assert r.pop("results") == [o["achieved"] for o in openings]
    assert r.pop("expected_results") == [o["expected"] for o in openings]
    assert r == want and r["positions"] > 0


def test_fused_route_is_the_default_and_visits_equal_general():
    """The default (``fused=True``) takes the fused search exactly where
    ``fused_mcts_v2.supports`` the config; it gives the general search's
    root visits (uniform evaluator, 16 midgame positions)."""
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    env = ConnectN()
    rng = np.random.default_rng(0)
    states = env.init(16, "cpu")
    for _ in range(10):
        legal = env.legal_mask(states).numpy()
        moves = [int(rng.choice(np.nonzero(row)[0])) for row in legal]
        states, _ = env.step(states, torch.tensor(moves))

    def uniform(obs):
        return torch.full((obs.shape[0], 7), 1 / 7), torch.zeros(obs.shape[0])

    cfg = MCTSConfig(simulations=24)
    fused = fused_mcts_v2.FusedConnectNSearchV2(env, cfg, "cpu")
    mcts = MCTS(env, cfg)
    assert torch.equal(
        fused.search_root_stats(states, uniform, None, 24)[0],
        mcts.root_child_visits(mcts.search(states, uniform, None, 24)))
    calls = fused_mcts_v2.wave_step_reference.calls
    strength.evaluate_strength(env, uniform, num_games=1, mcts_cfg=cfg,
                               opening_plies=12, device="cpu")
    assert fused_mcts_v2.wave_step_reference.calls > calls
    assert not fused_mcts_v2.supports(env, MCTSConfig(max_nodes=64))


# ---- lineage ----------------------------------------------------------------

def test_lineage_rows_match_jax(tmp_path, monkeypatch, capsys):
    """A tests/test_lineage.py-style run (two promotions) with 64 labelled
    positions and a one-game probe at 8 simulations (OPENING-ply
    openings): every row equal to JAX's, the random-init row built from
    JAX's template (PRNGKey(0))."""
    cfg = _jax_run(tmp_path, "lin", [4, 8])
    _shared_cache(monkeypatch, tmp_path / "cache.npz")
    _short_openings(monkeypatch, (jlineage, jstrength), (lineage, strength))
    labels = _labels_subset(tmp_path / "labels.npz")

    def jax_template(num_actions, model, generator, obs_shape, device=None):
        jnet = JaxPolicyValueNet(num_actions, cfg.model)
        jstate = jax_init_train_state(jnet, cfg.model, jax.random.PRNGKey(0),
                                      obs_shape)
        return new_train_state(from_jax_variables(
            jstate.params, jstate.batch_stats, num_actions, model,
            obs_shape[-1], obs_shape[:2], device=device))

    monkeypatch.setattr(lineage, "init_train_state", jax_template)
    kwargs = dict(results_dir=str(tmp_path), labels=labels, probe_games=1,
                  sims=8)
    ref = jlineage.lineage_report("lin", **kwargs)
    mine = lineage.lineage_report("lin", device="cpu", **kwargs)
    assert [e["iteration"] for e in mine["entries"]] == [
        "random-init", 4, 8]
    assert mine["run_id"] == ref["run_id"] and mine["sims"] == ref["sims"]
    for got, want in zip(mine["entries"], ref["entries"]):
        _assert_labeled_equal(got, want)
    assert lineage.format_table(mine) == jlineage.format_table(ref)
    # The CLI prints the table, the JSON line, and its captures on stderr.
    lineage.main(["--run_id=lin", f"--results_dir={tmp_path}",
                  f"--labels={labels}", "--device=cpu"])
    out = capsys.readouterr()
    assert out.out.splitlines()[0].startswith("| promotion iter | steps |")
    assert json.loads(out.out.splitlines()[-1])["run_id"] == "lin"
    assert out.err == "graph captures: 0\n"


@pytest.mark.parametrize("labels", ["chess_tactics_300.npz",
                                    "chess_tactic_labels.npz"])
def test_chess_lineage_with_labels_raises_keyerror_in_both(tmp_path, labels):
    """A fault carried over from JAX: its usage documents ``--game=chess
    --labels=<tactics set>``, but labeled_policy_accuracy reads ``obs`` and
    ``optimal``, which no chess label file holds: both packages raise
    KeyError on the random-init row."""
    _jax_run(tmp_path, "cl", [], game="chess")
    path = os.path.join(REPO, "data", labels)
    missing = "obs" if labels == "chess_tactics_300.npz" else "optimal"
    with pytest.raises(KeyError, match=missing):
        jlineage.lineage_report("cl", str(tmp_path), game="chess",
                                labels=path)
    with pytest.raises(KeyError, match=missing):
        lineage.lineage_report("cl", str(tmp_path), game="chess",
                               labels=path, device="cpu")
    with pytest.raises(SystemExit, match="exact-solver oracle"):
        lineage.lineage_report("cl", str(tmp_path), game="chess",
                               probe_games=1, device="cpu")


# ---- CLIs ----------------------------------------------------------------

@pytest.mark.parametrize("tool,argv,code", [
    ("run_report", ["--run_id"], 2),
    ("lineage", ["oops"], 2),
    ("book_from_cache", ["-x"], 2),
    ("chess_tactics", ["--labels"], 2),
    ("chess_strength", ["--help"], 0),
    ("profile_chess", ["--batch"], 2),
    ("chess_inloop_bench", ["--sims"], 2),
])
def test_cli_usage_errors_match_jax(capsys, tool, argv, code):
    """A malformed invocation exits 2 with JAX's message, then the tool's
    usage; --help prints the usage and exits 0."""
    import importlib

    printed = []
    for module in (importlib.import_module(f"custom_alphazero_tpu.tools.{tool}"),
                   globals()[tool]):
        with pytest.raises(SystemExit) as exc:
            module.main(argv)
        assert exc.value.code == code
        printed.append(capsys.readouterr())
    (ref, mine), stream = printed, ("out" if code == 0 else "err")
    assert getattr(mine, stream).strip() == globals()[tool].__doc__.strip() \
        or getattr(mine, stream).splitlines()[0] == \
        getattr(ref, stream).splitlines()[0]
    assert "custom_alphazero_tpu_torch" in getattr(mine, stream)


def test_cli_helpers_and_bare_parsing_match_jax(capsys):
    for module in (cli, jcli):
        assert module.parse_args(["--a=1", "b"]) == ({"--a": "1"}, ["b"])
        assert module.parse_kv_args(["--a=b=c"]) == {"--a": "b=c"}
        with pytest.raises(SystemExit) as exc:
            module.parse_kv_args(["b"], "usage")
        assert exc.value.code == 2
    assert capsys.readouterr().err == 2 * (
        "bad argument 'b': tools take --key=value flags only\nusage\n")
    # final_eval and distill keep the bare dict(a.split("=", 1)) parsing.
    for module in (final_eval, jfinal_eval, distill, jdistill):
        with pytest.raises(ValueError):
            module.main(["--help"])
    with pytest.raises(SystemExit) as exc:
        bench_chess.main(["0"])
    assert exc.value.code == 2 and "bad batch size '0'" in \
        capsys.readouterr().err
    assert chess_inloop_bench.main(["--bogus=1"]) == 2


# ---- the card by default ------------------------------------------------

ENTRY_POINTS = {
    "final_eval.main": lambda d: final_eval.main(
        ["--run_id=r", f"--results_dir={d}"]),
    "lineage.lineage_report": lambda d: lineage.lineage_report("r", str(d)),
    "distill.run_distillation": lambda d: distill.run_distillation({}, {}),
    "strength.evaluate_strength": lambda d: strength.evaluate_strength(
        ConnectN(), None),
    "strength.main": lambda d: strength.main(
        ["--run_id=r", f"--results_dir={d}"]),
    "chess_strength.play_vs_opponent": lambda d:
        chess_strength.play_vs_opponent(Chess(), None),
    "chess_tactics.evaluate_tactics": lambda d:
        chess_tactics.evaluate_tactics(None, "x.npz"),
    "chess_tactics.generate_tactics": lambda d:
        chess_tactics.generate_tactics(str(d / "t.npz")),
    "chess_tactics.generate_mate_in_2": lambda d:
        chess_tactics.generate_mate_in_2(str(d / "t.npz")),
    "chess_tactics.export_labels": lambda d:
        chess_tactics.export_labels([], str(d / "t.npz")),
    "bench_chess.measure": lambda d: bench_chess.measure(2),
    "profile_chess.main": lambda d: profile_chess.main(["--batch=2"]),
    "chess_inloop_bench.main": lambda d: chess_inloop_bench.main(["2"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_new_entry_points_run_on_the_card_unless_asked(tmp_path, monkeypatch,
                                                       name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jax_run(tmp_path, "r", [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](tmp_path)


def test_chip_evals_lays_out_runs_of_its_own(tmp_path, monkeypatch):
    """chip_evals.py writes only results/<game>/chip-evals-<run>, lays it
    out anew over its own earlier layout, and refuses a directory of that
    name that it did not lay out."""
    import chip_evals

    monkeypatch.setattr(chip_evals, "REPO", str(tmp_path))
    run = chip_evals.lay_out("c4-r5", "connect_n", "iteration_11600")
    run_dir = tmp_path / "results" / "connect_n" / run
    assert run == "chip-evals-c4-r5"
    assert sorted(os.listdir(tmp_path / "results" / "connect_n")) == [run]
    assert (run_dir / "evaluation" / "iteration_11600").is_dir()
    assert (run_dir / "tensorboard" / "metrics.jsonl").is_file()
    (run_dir / "stale").write_text("")
    assert chip_evals.lay_out("c4-r5", "connect_n", "iteration_11600") == run
    assert not (run_dir / "stale").exists()
    foreign = tmp_path / "results" / "chess" / "chip-evals-chess-r5"
    foreign.mkdir(parents=True)
    (foreign / "config.json").write_text("{}")
    with pytest.raises(FileExistsError):
        chip_evals.lay_out("chess-r5", "chess", "iteration_2400")
    assert os.listdir(foreign) == ["config.json"]
