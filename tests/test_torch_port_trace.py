"""The port's span recorder (io/trace.py): nesting per thread, its bound,
its profiler ranges on the profiler's own clock, and the spans of a tiny
fused self-play generation and of the loop's timings, on the CPU."""

import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from custom_alphazero_tpu_torch.config import (
    Config,
    ConnectNConfig,
    MCTSConfig,
    SelfPlayConfig,
    apply_overrides,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.io import trace
from custom_alphazero_tpu_torch.runtime.loop import run
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn


def _since(t_ns):
    return [s for s in trace.spans() if s.start_ns >= t_ns]


def test_nesting_and_parents_on_two_threads():
    barrier = threading.Barrier(2, timeout=30)
    made = {}

    def work(tag):
        with trace.span(f"outer.{tag}") as outer:
            barrier.wait()  # both outer spans open at once
            with trace.span(f"inner.{tag}") as inner:
                with trace.span(f"leaf.{tag}") as leaf:
                    barrier.wait()
            with trace.span(f"second.{tag}") as second:
                pass
        made[tag] = (outer, inner, leaf, second)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    ids = set()
    for tag, (outer, inner, leaf, second) in made.items():
        assert outer.parent is None
        assert inner.parent == outer.id and second.parent == outer.id
        assert leaf.parent == inner.id
        assert len({outer.thread, inner.thread, leaf.thread,
                    second.thread}) == 1
        assert (outer.start_ns <= inner.start_ns <= leaf.start_ns
                <= leaf.end_ns <= inner.end_ns <= second.start_ns
                <= second.end_ns <= outer.end_ns)
        assert outer.seconds >= inner.seconds >= 0
        ids |= {outer.id, inner.id, leaf.id, second.id}
    assert len(ids) == 8
    assert made["a"][0].thread != made["b"][0].thread
    # Recorded as they end: the leaf before its parents.
    order = [s.id for s in trace.spans()]
    a_outer, a_inner, a_leaf, _ = made["a"]
    assert (order.index(a_leaf.id) < order.index(a_inner.id)
            < order.index(a_outer.id))


def test_many_threads_lose_no_span():
    """More threads than cores, a short switch interval: every span is
    recorded once, with a unique id and its own thread's parent."""
    workers = min((os.cpu_count() or 2) + 2, 16)
    per = 300
    wrong = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(tag):
            for _ in range(per):
                with trace.span(f"stress.{tag}") as outer:
                    with trace.span(f"stress.{tag}.inner") as inner:
                        pass
                if inner.parent != outer.id:
                    wrong.append((outer.id, inner.parent))

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not wrong
    mine = [s for s in trace.spans() if s.name.startswith("stress.")]
    assert len(mine) == 2 * per * workers
    assert len({s.id for s in mine}) == len(mine)
    by_id = {s.id: s for s in mine}
    for s in mine:
        if s.name.endswith(".inner"):
            parent = by_id[s.parent]
            assert parent.thread == s.thread
            assert s.name == parent.name + ".inner"


def test_the_record_is_bounded():
    first = None
    for i in range(trace.CAPACITY + 10):
        with trace.span("bounded") as s:
            pass
        if i == 0:
            first = s
    kept = trace.spans()
    assert len(kept) == trace.CAPACITY
    assert kept[-1] is s and first not in kept
    assert all(r.name == "bounded" for r in kept)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened")

    monkeypatch.setattr(trace, "_profiler_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("quiet") as s:
        torch.ones(4).sum()
    assert s.end_ns >= s.start_ns and trace.spans()[-1] is s


def test_a_span_is_a_profiler_event_on_the_same_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("traced.region") as s:
            (torch.ones(64) * 2).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "traced.region"]
    assert len(events) == 1
    # A host op, not a user annotation (which the profiler would mirror on
    # the device's timeline as device time).
    assert not events[0].is_user_annotation()
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    # The clocks are one: the profiler's range lies inside the span.
    assert s.start_ns <= start <= end <= s.end_ns


def test_fused_generation_records_its_spans():
    t_len = 5
    env = ConnectN(ConnectNConfig())
    mcts = MCTSConfig(simulations=4, use_dirichlet=True,
                      dirichlet_alpha=1.0, dirichlet_fraction=0.25)
    generate = make_selfplay_fn(env, mcts, SelfPlayConfig(continuous=True),
                                t_len, device="cpu", fused=True)

    def uniform(obs):
        b = obs.shape[0]
        return (torch.full((b, env.num_actions), 1.0 / env.num_actions),
                torch.zeros(b))

    t0 = time.time_ns()
    generate(uniform, torch.Generator().manual_seed(0), 4)
    recorded = _since(t0)
    top = [s for s in recorded if s.name == "selfplay.generate"]
    assert len(top) == 1
    (gen,) = top
    for name in ("search.noise", "search.waves"):
        inner = [s for s in recorded if s.name == name]
        assert len(inner) == t_len, name
        assert all(s.parent == gen.id for s in inner)
        assert all(gen.start_ns <= s.start_ns <= s.end_ns <= gen.end_ns
                   for s in inner)
    # Each ply draws its noise, then runs its waves.
    noise = sorted(s.start_ns for s in recorded if s.name == "search.noise")
    waves = sorted(s.start_ns for s in recorded if s.name == "search.waves")
    assert all(n < w for n, w in zip(noise, waves))
    assert {s.name for s in recorded} == {"selfplay.generate",
                                          "search.noise", "search.waves"}


def test_loop_timings_are_its_spans(tmp_path):
    generations = 2
    cfg = apply_overrides(Config(), {
        "mcts.simulations": "4",
        "self_play.games_per_generation": "4",
        "self_play.max_plies": "6",
        "self_play.exclude_draws": "false",
        "model.depth": "1",
        "model.filters": "8",
        "model.value_hidden": "16",
        "model.batch_size": "8",
        "replay.capacity": "500",
        "replay.min_size": "16",
        "loop.train_iterations_per_generation": "2",
        "loop.visualize_frequency": "2",
        "arena.games": "4",
        "arena.evaluation_frequency": "4",
        "arena.checkpoint_frequency": "2",
        "run.results_dir": str(tmp_path),
        "run.run_id": "spans",
    })
    t0 = time.time_ns()
    summary = run(cfg, generations=generations, device="cpu")
    recorded = _since(t0)
    loop_spans = [s for s in recorded if s.name.startswith("loop.")]
    gens = [s for s in loop_spans if s.name == "loop.generate"]
    assert len(gens) == generations == len(summary["timings"])
    # Each generation's spans: from its loop.generate to the next one's.
    bounds = [g.start_ns for g in gens] + [time.time_ns()]
    keys = {"loop.generate": "generate_s", "loop.replay": "replay_s",
            "loop.train": "train_s", "loop.arena": "arena_s",
            "loop.solver_score": "solver_score_s",
            "loop.checkpoint": "checkpoint_s", "loop.render": "render_s"}
    assert {s.name for s in loop_spans} <= set(keys)
    assert {"loop.train", "loop.arena", "loop.checkpoint",
            "loop.render"} <= {s.name for s in loop_spans}
    for timing, lo, hi in zip(summary["timings"], bounds, bounds[1:]):
        mine = [s for s in loop_spans if lo <= s.start_ns < hi]
        for name, key in keys.items():
            assert timing[key] == pytest.approx(
                sum(s.seconds for s in mine if s.name == name),
                rel=1e-12, abs=0.0), key
        assert timing["train_iterations"] == sum(
            s.name == "loop.train" for s in mine)
        wall = timing["generate_s"] + timing["replay_s"]
        sims = timing["sims_per_second"] * wall
        assert sims == pytest.approx(round(sims)) and sims > 0
    # The generation's own span nests inside the loop's.
    for g in gens:
        inner = [s for s in recorded if s.name == "selfplay.generate"
                 and s.parent == g.id]
        assert len(inner) == 1
