"""The port's tree rendering, the loop's solver scoring, veto and renders,
and the supervisor, against the JAX package's where both exist.

``tree_to_dot`` must give JAX's text byte for byte from the same dyadic
search. The loop tests run tiny configurations on the CPU; solver scoring
there keeps its cache in the test's temporary directory.
"""

import os
import re
import sys

import jax
import pytest

from chip_smoke import dyadic_evaluate as torch_dyadic
from custom_alphazero_tpu.search.mcts import MCTS as JaxMCTS
from custom_alphazero_tpu.tools import visualize as jvisualize
from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.runtime import supervisor
from custom_alphazero_tpu_torch.runtime.loop import run
from custom_alphazero_tpu_torch.runtime.watchdog import (
    HEARTBEAT_ENV,
    STALL_EXIT_CODE,
)
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools import strength, visualize
from tests.test_torch_port_loop import _metrics, _tiny_cfg
from tests.test_torch_port_search import (
    _jax_dyadic,
    _pair,
    _random_midgame_states,
    _to_torch,
)


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("CAZ_SOLVER_CACHE", str(tmp_path / "cache.npz"))


# ---------------------------------------------------------------------------
# Tree rendering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topk", [0, 4], ids=["full", "topk4"])
def test_tree_to_dot_matches_jax(topk, tmp_path):
    sims = 24
    jenv, env, jcfg, cfg = _pair({}, simulations=sims, topk_actions=topk)
    jstates = _random_midgame_states(jenv, jax.random.PRNGKey(3), 2, 6)
    jtree = JaxMCTS(jenv, jcfg).search(jstates, _jax_dyadic(7),
                                       jax.random.PRNGKey(0), sims)
    tree = MCTS(env, cfg).search(_to_torch(jstates), torch_dyadic(7), None,
                                 sims)
    assert (tree.prior.shape[-1] == 4) == (topk == 4)
    for kwargs in (dict(game_index=0),
                   dict(game_index=1, min_visits=0),
                   dict(game_index=1, c_puct=2.0, played_action=2,
                        greedy=True),
                   dict(game_index=0, max_nodes=5)):
        dot = visualize.tree_to_dot(tree, env, **kwargs)
        assert dot == jvisualize.tree_to_dot(jtree, jenv, **kwargs), kwargs
    path = visualize.save_tree(tree, env, str(tmp_path / "t" / "light"),
                               render_pdf=False)
    with open(path) as fp:
        assert fp.read() == visualize.tree_to_dot(tree, env)
    assert "digraph MCTS {" in dot and " -> " in dot


def _root_edge_visits(dot_path):
    with open(dot_path) as fp:
        return [int(n) for n in re.findall(r"^  n0 -> n\d+ .*N=(\d+) ",
                                           fp.read(), re.M)]


# ---------------------------------------------------------------------------
# The loop: solver scoring, the veto, renders
# ---------------------------------------------------------------------------

def test_solver_score_veto_blocks_regressing_candidate(tmp_path, monkeypatch,
                                                      capsys):
    """tests/test_loop.py's veto test against the port's loop: every arena
    wins head-to-head, and the oracle scores 0.8 (the first promotion sets
    the best's score), 0.5 (vetoed: below 0.8 - 0.02) and 0.85 (passes)."""
    scores = iter([0.8, 0.5, 0.85])
    monkeypatch.setattr(strength, "score_arena_log", lambda log: next(scores))
    cfg = _tiny_cfg(tmp_path, "veto1", 3, **{
        "arena.promote_threshold": "0.0",
        "arena.evaluate_with_solver": "true",
        "arena.solver_score_veto": "true",
        "arena.solver_score_veto_margin": "0.02",
        "arena.evaluation_frequency": "2",
        "arena.checkpoint_frequency": "2",
        "loop.train_iterations_per_generation": "2",
    })
    summary = run(cfg, device="cpu")
    # Arenas at steps 2, 4, 6: promote, veto, promote.
    assert summary["promotions"] == 2
    out = capsys.readouterr().out
    assert out.count("solver-score veto") == 1
    assert "[iter 4] solver-score veto: candidate 0.500 < best 0.800" in out
    assert [(m["step"], m["value"]) for m in _metrics(tmp_path, "veto1")
            if m["tag"] == "evaluation/solver_score"] == [
        (2, 0.8), (4, 0.5), (6, 0.85)]


def test_loop_scores_arenas_and_renders_trees(tmp_path, monkeypatch, capsys):
    """A tiny run with solver scoring and a render every generation: the
    score line and metric at the arena, the light render of every
    generation with the root's edge visits adding up to the search's, and,
    after the promotion, the light and full renders under updated_mcts."""
    real = strength.score_arena_log
    calls = []

    def deep_only(log):  # the loop's defaults reach ply 8: seconds a solve
        calls.append(log)
        return real(log, min_ply=14, max_positions=20)

    monkeypatch.setattr(strength, "score_arena_log", deep_only)
    cfg = _tiny_cfg(tmp_path, "viz", 3, **{
        "arena.evaluate_with_solver": "true",
        "arena.promote_threshold": "0.0",
        "loop.visualize_frequency": "1",
        "loop.samples_checkpoint_frequency": "0",
    })
    summary = run(cfg, device="cpu")
    assert len(calls) == 1 and calls[0].actions.shape == (42, 8)
    out = capsys.readouterr().out
    score = float(re.search(r"\[iter 4\] solver score=([0-9.]+)",
                            out).group(1))
    assert 0.0 <= score <= 1.0
    metric = [m for m in _metrics(tmp_path, "viz")
              if m["tag"] == "evaluation/solver_score"]
    assert [m["step"] for m in metric] == [4]
    assert abs(metric[0]["value"] - score) < 5e-4
    timings = summary["timings"]
    assert timings[1]["solver_score_s"] > 0 and all(
        t["render_s"] > 0 for t in timings)
    assert summary["promotions"] == 1
    results, game = str(tmp_path), "connect_n"
    for g in range(3):
        light = os.path.join(
            paths.self_play_iteration_path(results, game, "viz", g),
            f"mcts_iteration_{g}_light.dot")
        # Wave 0 only expands the root: simulations - 1 root visits.
        assert sum(_root_edge_visits(light)) == 8 - 1
    updated = paths.updated_mcts_path(results, game, "viz")
    # (graphviz, where installed, adds its own files beside the DOT text.)
    renders = os.listdir(updated)
    assert {"mcts_iteration_2_full.dot", "mcts_iteration_2_light.dot"} <= set(
        renders)
    assert all(name.startswith("mcts_iteration_2_") for name in renders)
    assert sum(_root_edge_visits(os.path.join(
        updated, "mcts_iteration_2_full.dot"))) == 8 - 1


def test_solver_scoring_skips_other_boards(tmp_path, monkeypatch, capsys):
    """The native solver knows the 7x6 n=4 board only: elsewhere
    evaluate_with_solver scores nothing and raises nothing, as in JAX."""
    def fail(log):
        raise AssertionError("scored a non-default board")

    monkeypatch.setattr(strength, "score_arena_log", fail)
    cfg = _tiny_cfg(tmp_path, "small", 2, **{
        "connect_n.width": "5", "connect_n.height": "4", "connect_n.n": "3",
        "arena.evaluate_with_solver": "true",
        "arena.solver_score_veto": "true",
        "arena.evaluation_frequency": "2",
    })
    summary = run(cfg, device="cpu")
    assert summary["last_arena_score"] is not None
    assert "solver score" not in capsys.readouterr().out
    assert "evaluation/solver_score" not in {
        m["tag"] for m in _metrics(tmp_path, "small")}


# ---------------------------------------------------------------------------
# The supervisor (tests/test_watchdog.py's three, against the port)
# ---------------------------------------------------------------------------

def test_supervisor_restarts_on_stall_code_only(tmp_path):
    counter = tmp_path / "count"
    child = tmp_path / "child.py"
    child.write_text(
        "import pathlib, sys\n"
        f"p = pathlib.Path({str(counter)!r})\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        f"sys.exit({STALL_EXIT_CODE} if n < 2 else 0)\n"
    )
    delays = []
    rc = supervisor.supervise([], max_restarts=5, backoff_s=1.0,
                              cmd=[sys.executable, str(child)],
                              sleep=delays.append)
    assert rc == 0
    assert counter.read_text() == "3"       # 2 stalls + 1 clean run
    assert delays == [1.0, 2.0]             # linear backoff

    child.write_text("import sys; sys.exit(7)\n")
    assert supervisor.supervise([], max_restarts=5, backoff_s=1.0,
                                cmd=[sys.executable, str(child)],
                                sleep=delays.append) == 7

    child.write_text(f"import sys; sys.exit({STALL_EXIT_CODE})\n")
    assert supervisor.supervise([], max_restarts=2, backoff_s=0.0,
                                cmd=[sys.executable, str(child)],
                                sleep=lambda _: None) == STALL_EXIT_CODE


def test_supervisor_liveness_kills_prestart_wedge(tmp_path):
    counter = tmp_path / "count"
    child = tmp_path / "child.py"
    # First launch: wedge without ever beating. Second: exit 0.
    child.write_text(
        "import pathlib, time, sys\n"
        f"p = pathlib.Path({str(counter)!r})\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        "if n == 0:\n"
        "    time.sleep(600)\n"
        "sys.exit(0)\n"
    )
    rc = supervisor.supervise(
        [], max_restarts=3, backoff_s=0.0, cmd=[sys.executable, str(child)],
        sleep=lambda _: None, liveness_timeout_minutes=2 / 60.0, poll_s=0.2,
    )
    assert rc == 0
    assert counter.read_text() == "2"  # one killed wedge + one clean run


def test_supervisor_liveness_spares_beating_child(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(
        "import os, time, sys\n"
        f"hb = os.environ[{HEARTBEAT_ENV!r}]\n"
        "for _ in range(10):\n"
        "    time.sleep(0.3)\n"
        "    os.utime(hb, None)\n"
        "sys.exit(0)\n"
    )
    rc = supervisor.supervise(
        [], max_restarts=0, backoff_s=0.0, cmd=[sys.executable, str(child)],
        sleep=lambda _: None, liveness_timeout_minutes=2 / 60.0, poll_s=0.2,
    )
    assert rc == 0


def test_supervisor_launches_the_ports_loop(monkeypatch):
    launched = []
    monkeypatch.setattr(supervisor, "_run_child",
                        lambda cmd, timeout_s, poll_s: launched.append(
                            (cmd, timeout_s)) or 0)
    assert supervisor.main(["--supervise.liveness_timeout_minutes=10",
                            "--supervise.max_restarts=3",
                            "--mcts.simulations=250", "--run.run_id=x"]) == 0
    assert launched == [([sys.executable, "-u", "-m",
                          "custom_alphazero_tpu_torch.runtime.loop",
                          "--mcts.simulations=250", "--run.run_id=x"], 600.0)]
