"""The benchmark's core: one run of one cell.

    python3 -m azbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the checkout's root, and
everything it needs by the names there:

- the configuration: the file its ``configs`` entry names (the port's
  ``Config`` as run, the weights to load, ``source``, ``reduced``,
  ``assumed``);
- the traffic mix: ``azbench/traffic/<traffic>.json``, the parameters of
  one of the general drivers in ``azbench/drivers/`` (named by its
  ``driver`` key);
- the limits of the correctness comparison: ``azbench/limits/<cell>.json``;
- each per-layer metric: a reader ``azbench/metrics/<metric>.py`` whose
  ``read(run)`` returns a number, or None when it finds nothing to read.

A driver has ``setup(run)``, ``window(run, state)``, ``check(run, state)``
and ``close(state)``. The harness times set-up and reads the device's
memory peak after the window; ``--trace 1`` runs the same cell with the
driver's profiled bracket on and prints the per-layer metrics instead of the
end-to-end ones. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax",
                     "custom_alphazero_tpu")
PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


class Run:
    """What a driver and the metric readers share for one run."""

    def __init__(self, root: str, bench: dict, workload: str, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float):
        self.root = root
        self.bench = bench
        self.cell = _entry(bench["workloads"], workload, "workload")
        self.config_entry = _entry(bench["configs"], self.cell["config"],
                                   "config")
        self.config = _load_json(os.path.join(root,
                                              self.config_entry["file"]))
        self.traffic = _load_json(os.path.join(
            root, "azbench", "traffic", self.cell["traffic"] + ".json"))
        limits = os.path.join(root, "azbench", "limits", workload + ".json")
        self.limits = _load_json(limits)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.metrics: Dict[str, float] = {}   # end-to-end, by name
        self.values: Dict[str, Any] = {}      # what readers read
        self.spans: Dict[str, List[float]] = {}  # name -> seconds
        self.activity = None                  # trace.Activity of the bracket
        self.compared: List[tuple] = []       # (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def program_config(self):
        """The port's ``Config`` of this cell, seeded with ``--seed``."""
        import dataclasses

        from custom_alphazero_tpu_torch.config import from_json, validate

        cfg = from_json(json.dumps(self.config["config"]))
        cfg = dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, seed=self.seed))
        return validate(cfg)

    def path(self, relative: str) -> str:
        return os.path.join(self.root, relative)

    def end_setup(self) -> None:
        """Set-up is over: the window starts now."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the enclosed call into a layer, the device drained at both
        ends (CUDA events on the card, the host clock elsewhere)."""
        if self.cuda:
            import torch
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
        self.spans.setdefault(name, []).append(seconds)

    def bracket(self, keep=()):
        """A profiled bracket when tracing on the card, else nothing."""
        if not (self.trace and self.cuda):
            return contextlib.nullcontext()
        from azbench.trace import Bracket

        bracket = Bracket(keep=keep)
        self._bracket = bracket
        return bracket

    def close_bracket(self) -> None:
        bracket = getattr(self, "_bracket", None)
        if bracket is not None:
            self.activity = bracket.activity

    def compare(self, name: str, value: float, limit: float | None = None):
        """Record a compared number beside its limit (from the cell's limits
        file unless given); the run is correct only if every one holds."""
        if limit is None:
            limit = self.limits[name]
        self.compared.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        import math
        return (bool(self.compared) and self.failed == 0
                and all(math.isfinite(v) and v <= lim
                        for _, v, lim in self.compared))


def _load_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def _entry(entries: list, name: str, kind: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {kind} named {name!r} in BENCHMARK.json")


def driver_for(run: Run):
    return importlib.import_module(f"azbench.drivers.{run.traffic['driver']}")


def load_reader(root: str, metric: str):
    """The ``read`` function of ``azbench/metrics/<metric>.py``."""
    path = os.path.join(root, "azbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "azbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, kind: str, workload: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_loaded() -> List[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not readable: {exc}"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """One run of one cell; returns the result object."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    run = Run(root, bench, workload, seed, seconds, trace, device, t_start)
    driver = driver_for(run)
    state = driver.setup(run)
    try:
        if run.setup_s is None:
            run.end_setup()
        driver.window(run, state)
        run.close_bracket()
        if run.cuda:
            import torch
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        driver.check(run, state)
    finally:
        driver.close(state)
    return result(run)


def result(run: Run) -> dict:
    workload = run.cell["name"]
    metrics = {}
    if not run.trace:
        for m in cell_metrics(run.bench, "end_to_end", workload):
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.metrics.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(run.bench, "per_layer", workload):
            value = load_reader(run.root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.cuda else run.device,
              "kind": _device_kind(run), "count": 1,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.activity is not None:
        device["busy_s"] = run.activity.busy_s
        device["window_s"] = run.activity.window_s
        out["breakdown"] = {
            "device_ops": run.activity.top_ops(10),
            "idle_gaps": [[n, s] for n, s in run.activity.idle_gaps[:10]],
        }
    out["compared"] = {name: {"value": value, "limit": limit}
                       for name, value, limit in run.compared}
    return out


def _device_kind(run: Run) -> str:
    if not run.cuda:
        return run.device
    import torch
    return torch.cuda.get_device_name()


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m azbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    build = os.path.join(root, "build", "azbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))

    import torch

    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    chips = _entry(bench["workloads"], args.workload, "workload")["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"azbench: needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    print(f"azbench: card {card_line()}", file=sys.stderr, flush=True)
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=t_start)
    loaded = forbidden_loaded()
    if loaded:
        print("azbench: the run loaded " + ", ".join(loaded)
              + ": the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 4
    for name, item in out["compared"].items():
        print(f"compared {name} = {item['value']!r} (limit {item['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
