"""The port's profiling tools on the CPU at a tiny size: ``phase_timings``
returns JAX's keys, ``capture_trace`` writes a trace, and the throughput
probes ``inloop_bench`` and ``gumbel_probe`` run and print their lines."""

import json
import re

import pytest
import torch

from custom_alphazero_tpu.tools import profile as jax_profile
from custom_alphazero_tpu_torch.config import Config, apply_overrides
from custom_alphazero_tpu_torch.tools import gumbel_probe, inloop_bench
from custom_alphazero_tpu_torch.tools import profile

# One intra-op thread per test process, as tests/test_torch_port_misc.py
# sets it: the suite's workers share the cores.
torch.set_num_threads(1)

TINY = {
    "model.depth": "1",
    "model.filters": "8",
    "model.value_hidden": "8",
    "model.batch_size": "16",
    "replay.capacity": "512",
    "arena.games": "4",
    "self_play.max_plies": "6",
}


def test_phase_timings_keys():
    """The five keys of JAX's ``phase_timings``, positive and finite."""
    cfg = apply_overrides(Config(), TINY)
    timings = profile.phase_timings(cfg, batch_size=4, sims=4, device="cpu")
    jax_keys = re.findall(r'"(\w+)": ', open(jax_profile.__file__).read())
    assert list(timings) == jax_keys
    assert all(v > 0 and v < float("inf") for v in timings.values())
    assert timings["sims_per_s"] == pytest.approx(
        4 * timings["samples_per_s"])


def test_capture_trace_writes_a_trace(tmp_path, capsys):
    cfg = apply_overrides(Config(), TINY)
    path = profile.capture_trace(str(tmp_path / "trace"), batch_size=2,
                                 sims=4, cfg=cfg, device="cpu")
    assert path == str(tmp_path / "trace" / profile.TRACE_FILE)
    with open(path) as fp:
        trace = json.load(fp)
    names = {event.get("name", "") for event in trace["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
    assert "Trace written to" in capsys.readouterr().out


def test_profile_main_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.main([])
    assert profile.main(["--bad=1"]) == 2


def test_inloop_bench_prints_both_modes(monkeypatch, capsys):
    """Both lines (plain, continuous) at 4 simulations and a depth-1 net."""
    tiny = {**TINY, "self_play.max_plies": "4"}
    monkeypatch.setattr(
        inloop_bench, "apply_overrides",
        lambda cfg, overrides: apply_overrides(
            cfg, {**overrides, **tiny, "mcts.simulations": "4"}))
    assert inloop_bench.main(["2", "--iters=1", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "continuous=False B=2", "continuous=True B=2"]
    for line in lines:
        assert re.fullmatch(
            r"continuous=(False|True) B=2: [\d.]+s/gen \(all \['[\d.]+'\]\) "
            r"[\d,]+ sims/s, \d+ samples \([\d,]+ samples/s\) "
            r"first=[\d.]+s", line), line


@pytest.mark.parametrize("uniform", ["true", "false"])
def test_gumbel_probe_runs(uniform, capsys):
    assert gumbel_probe.main(["2", "--sims=4", f"--uniform={uniform}",
                              "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"OK B=2 sims=4 uniform={uniform == 'true'}: ")
    assert "sims/s" in out and "first=" in out
