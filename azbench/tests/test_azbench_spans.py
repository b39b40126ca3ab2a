"""The span readers (azbench/spans.py and its five metrics): the idle
attribution by hand, nothing read without a trace, and the wave lag on a
synthetic trace."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from azbench import harness, spans
from azbench.tests import fixture
from azbench.trace import Activity

REPO = fixture.REPO
READERS = ("search.noise_idle_share", "search.waves_idle_share",
           "selfplay.ply_idle_share", "search.noise_ms", "search.wave_lag_ms")


def test_merge_is_the_union():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (6, 9), (9, 10)]) == [
        (0, 3), (5, 10)]


def test_attribute_by_hand():
    # outer [0, 100) holds a [10, 40) and b [50, 90); b holds c [60, 70).
    hand = [("outer", 0, 100), ("a", 10, 40), ("b", 50, 90), ("c", 60, 70)]
    # Busy (two streams overlap in [25, 30)): [0, 5), [20, 30), [55, 65),
    # [95, 120); the window is [-10, 110).
    busy = [(0, 5), (20, 30), (25, 30), (55, 65), (95, 120)]
    idle = spans.attribute(hand, busy, -10, 110)
    assert idle == {
        None: 10,             # [-10, 0); from 100 on the device is busy
        "outer": 5 + 10 + 5,  # [5, 10), [40, 50), [90, 95)
        "a": 10 + 10,         # [10, 20), [30, 40)
        "b": 5 + 20,          # [50, 55), [70, 90)
        "c": 5,               # [65, 70): split at c's edges
    }
    # The shares plus the remainder are the window's idle time: 120 less
    # the 40 busy inside it.
    assert sum(idle.values()) == 120 - (5 + 10 + 10 + 15)


def test_attribute_innermost_and_clipping():
    # Two spans that start together: the one that ends first is inner.
    both = [("long", 0, 10), ("short", 0, 4)]
    assert spans.attribute(both, [], 0, 10) == {"short": 4, "long": 6}
    # Spans outside [t0, t1] are cut to it; no device work at all.
    assert spans.attribute([("x", -5, 5), ("y", 8, 20)], [], 0, 10) == {
        "x": 5, None: 3, "y": 2}
    # A device busy throughout leaves nothing to charge.
    assert sum(spans.attribute(both, [(-1, 11)], 0, 10).values()) == 0


@pytest.fixture(scope="module")
def cpu_result(tmp_path_factory):
    root = fixture.tiny_root(str(tmp_path_factory.mktemp("bench")))
    return harness.run_cell(root, "tiny-selfplay", seed=2**31 + 5,
                            seconds=0.3, trace=True, device="cpu")


@pytest.mark.parametrize("metric", READERS)
def test_nothing_read_without_a_bracket(cpu_result, metric):
    """The CPU run has no profiled bracket: each reader gives None, and the
    run's line leaves the metric out."""
    assert cpu_result["correct"], cpu_result["compared"]
    assert metric not in cpu_result["metrics"]
    run = SimpleNamespace(activity=None, values={}, config={})
    assert harness.load_reader(REPO, metric)(run) is None


def _generation(plies):
    """The program's spans of a fused generation of ``plies`` plies, opened
    as it opens them: (generate, noise spans, waves spans)."""
    from custom_alphazero_tpu_torch.io import trace

    noises, waves = [], []
    with trace.span("selfplay.generate") as gen:
        for _ in range(plies):
            with trace.span("search.noise") as n:
                time.sleep(0.002)
            noises.append(n)
            with trace.span("search.waves") as w:
                time.sleep(0.001)
            waves.append(w)
    return gen, noises, waves


def _synthetic_run(sims=3, lag_ns=(40_000, 90_000)):
    """A traced generation laid out by hand over the program's own spans:
    the K1 events of ply k start ``lag_ns[k]`` after its waves' span, one
    every microsecond for half a microsecond; the bracket is the
    generation."""
    steps = sims + 1
    gen, noises, waves = _generation(len(lag_ns))
    k1 = [(w.start_ns + lag + 1_000 * i, 500)
          for w, lag in zip(waves, lag_ns) for i in range(steps)]
    t0, t1 = gen.start_ns, gen.end_ns
    act = Activity(window_s=(t1 - t0) / 1e9,
                   count_by_name={"wave_kernel": len(k1)},
                   events_by_name={"wave_kernel": k1})
    run = SimpleNamespace(
        activity=act, config={"config": {"mcts": {"simulations": sims}}},
        values={"bracket_plies": len(lag_ns),
                "bracket_device": (t0, t1, [(s, s + d) for s, d in k1])})
    return run, gen, noises, k1


def test_span_readers_on_a_synthetic_trace():
    run, gen, noises, k1 = _synthetic_run(lag_ns=(40_000, 90_000))
    read = {m: harness.load_reader(REPO, m)(run) for m in READERS}
    assert read["search.wave_lag_ms"] == pytest.approx((0.04 + 0.09) / 2)
    r = spans.reading(run)
    assert r.lags_ns == [40_000, 90_000]
    assert r.first_span_ns == gen.start_ns < r.first_k1_ns
    assert read["search.noise_ms"] == pytest.approx(
        sum(n.seconds for n in noises) / 2 * 1e3)
    # The noise spans hold no device work: all their time is idle.
    window = run.activity.window_s
    assert read["search.noise_idle_share"] == pytest.approx(
        100 * sum(n.seconds for n in noises) / window)
    # The three shares add up to the whole idle share (every instant of
    # this bracket is inside the generation's span).
    idle = window - len(k1) * 500 / 1e9
    assert r.idle.get(None, 0.0) == 0.0
    assert sum(read[m] for m in READERS[:3]) == pytest.approx(
        100 * idle / window)


def test_a_short_trace_reads_nothing():
    # A K1 launch missing from the trace: the plies cannot be told apart.
    run, *_ = _synthetic_run()
    run.activity.events_by_name["wave_kernel"].pop()
    for metric in READERS:
        assert harness.load_reader(REPO, metric)(run) is None, metric
