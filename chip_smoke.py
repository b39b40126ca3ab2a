#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repo root on a machine with a CUDA card, the CUDA toolkit and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failed check raises and exits non-zero):

1. Device: CUDA present; the card's name and power limit (nvidia-smi).
2. Build: nvcc builds both wave kernels, K1 (csrc/fused_mcts_v2.cu) and K2
   (csrc/fused_mcts.cu), from the repo's sources into build/kernels/, in
   parallel.
3. K1 vs its plain version: whole searches (B=1024, 250 simulations, root
   noise on, a dyadic evaluator) from random positions at 7x6 n=4 and 5x4
   n=3, through the CUDA step kernel and ``wave_step_reference`` side by
   side; all 12 carry arrays, the leaf board, ``renormed``, ``mixed``,
   ``root_prior``, the observation, the recorded path and the wave counter
   must be bit-equal after every wave. Times of the kernel (CUDA events
   over back-to-back launches), of the plain version, the kernel's bytes
   bound, and a fit of kernel time against the deepest game's depth.
4. Net: the committed c4-r5 checkpoint through load_jax_checkpoint; the
   card's fp32 forward (TF32 off) against the CPU's, and bf16 against fp32.
5. Main path: c4-r5 self-play (depth 4, 128 filters, 250 simulations,
   Dirichlet alpha 1.0, continuous auto-reset, 1024 games, 42 plies) with
   the trained weights in bf16, every wave a replay of the search's CUDA
   graph (the step kernel + the net); every wave must go through the
   kernel and none through the plain version. Then the same generation
   with every wave launched from the host (``graph=False``) and both once
   more, in turns. Prints simulations/s of each, the kernel / net / rest
   split, one profiled ply of each and the sample checks.
6. K2 vs its plain version, as phase 3.
7. The searches agree: K2 (``FusedConnectNSearch``) and K1
   (``FusedConnectNSearchV2``), each launched from the host and replayed
   from its graph, and the general ``MCTS.search``, from the same 1024
   random c4-r5 positions, 250 simulations, root noise from one generator
   seed each: with the dyadic evaluator, bit-equal root visits and value
   sums; with the trained bf16 net (cuDNN deterministic), the four fused
   ones equal. Every K2 wave must go through its kernel. Prints each
   search's wall time per wave.
8. General-path self-play: ``make_selfplay_fn(fused=False)`` and the fused
   path (its default, the graph) at the phase-5 configuration, 4 plies
   each from one generator seed: identical samples and stats. Prints
   sims/s of both.
``python3 chip_smoke.py --launch-shapes`` runs a tuning aid in place of the
phases: K1 built with 1, 2, 4 and 8 games (warps) per block, each checked
and timed as in phase 3.

9. The kernels' JSON line, the card's line, and the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "artifacts", "c4-r5", "iteration_11600")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
BATCH = 1024
SIMS = 250
MAX_PLIES = 42
GENERAL_PLIES = 4  # phase 8: plies of each self-play path
SNAPSHOT_LAUNCHES = 10
# Waves whose mean kernel time is the kernel's "ms" (as in earlier runs), and
# further ones for the fit of time against depth.
HEADLINE_WAVES = (1, SIMS // 4, SIMS // 2, (3 * SIMS) // 4, SIMS - 1)
FIT_WAVES = (4, 16, 31)
# Root noise of the c4-r5 configuration (artifacts/c4-r5/config.json).
NOISE = dict(use_dirichlet=True, dirichlet_alpha=1.0, dirichlet_fraction=0.25,
             c_puct=1.5)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dyadic_evaluate(num_actions: int):
    """probs[a] = (1 + (stones + a) % 4) / 16, value = stones / 64: every
    float a search computes from it is exact, in any implementation."""

    def evaluate(obs):
        stones = (obs[..., 1] + obs[..., 2]).sum(dim=(1, 2))
        a = torch.arange(num_actions, dtype=torch.float32,
                         device=obs.device)[None, :]
        return ((1.0 + torch.remainder(stones[:, None] + a, 4.0)) / 16.0,
                stones / 64.0)

    return evaluate


def random_positions(env, batch: int, max_plies: int, gen, device):
    """Positions after a per-game random number of uniform legal moves."""
    states = env.init(batch, device)
    target = torch.randint(0, max_plies + 1, (batch,), generator=gen,
                           device=device)
    for t in range(max_plies):
        legal = env.legal_mask(states)
        scores = torch.rand(legal.shape, generator=gen, device=device)
        stepped, _ = env.step(states, (scores + legal).argmax(dim=1))
        states = stepped.where(t < target, states)
    return states


def touched_bytes(prev_depth, new_depth, actions: int, cells: int) -> int:
    """Bytes one step must move for this data. Inputs read once: the net's
    row and value, the gamma row, the root prior, the root board, the last
    leaf's top row, the recorded path, the per-game scalars and root flags.
    Phase A writes the leaf's prior row and flag, reads its flag and reward,
    and reads and writes two edge statistics per path edge. Phase B reads,
    per descent level, a node's row of prior, visits, value sums and
    children and its two flags, and writes the path, the new node and the
    per-game scalars. Outputs written once: renormed, mixed, the leaf board
    and the (cells, 4) observation."""
    per_game = (
        4 * actions + 1 + 64 + (1 + prev_depth) + 3 + 2   # inputs
        + (actions + 1) + 2 + 4 * prev_depth              # expand + backup
        + (new_depth + 1) * (4 * actions + 2)             # descent
        + (new_depth + 1) + 6 + 3                         # path + create
        + 2 * actions + 64 + 4 * cells                    # outputs
    )
    return int(4 * per_game.sum().item())


def clone_step(fm, buffers, carry):
    """Copies of what a step updates; its inputs that no step writes (the
    root board, the gamma draws) are shared."""
    copied = {name: t.clone() for name, t in buffers._asdict().items()
              if name not in ("root_board", "gamma")}
    return buffers._replace(**copied), fm.Carry(*(t.clone() for t in carry))


def line_fit(xs, ys):
    """Least-squares (intercept, slope) of ys against xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - slope * mx, slope


def kernel_vs_plain(env, cfg, states, sims, gen, timed: bool,
                    kernel: str = "K1"):
    """Lockstep searches through kernel ``kernel`` (K1 or K2) and its plain
    version; returns (max_abs_err, kernel_ms, plain_ms, bound_ms,
    carry_bound_ms, (intercept_ms, ms_per_level))."""
    from custom_alphazero_tpu_torch.ops import fused_mcts, fused_mcts_v2

    device = states.board.device
    bsz, a = states.board.shape[0], env.num_actions
    fm = fused_mcts if kernel == "K2" else fused_mcts_v2
    search = (fused_mcts.FusedConnectNSearch if kernel == "K2"
              else fused_mcts_v2.FusedConnectNSearchV2)(env, cfg, device)
    geom = search.geometry(sims)
    evaluate = dyadic_evaluate(a)
    static = search.static(bsz, sims)
    search.reset(static, states)
    for w in range(sims):
        static.buffers.gamma[w] = search._mcts.wave_noise(gen, bsz, device)
    buf_k, carry_k = static.buffers, static.carry
    buf_p, carry_p = clone_step(fm, buf_k, carry_k)
    compared = ("root_prior", "leaf_board", "path", "counter", "renormed",
                "mixed", "obs")
    snap_waves = set(HEADLINE_WAVES + FIT_WAVES) if timed else set()
    snapshots = []
    max_err = 0.0
    for w in range(sims + 1):
        if w in snap_waves:
            snapshots.append((w, *clone_step(fm, buf_k, carry_k)))
        fm.wave_step(buf_k, carry_k, geom)
        fm.wave_step_reference(buf_p, carry_p, geom)
        pairs = list(zip(fm.Carry._fields, carry_k, carry_p)) + [
            (name, getattr(buf_k, name), getattr(buf_p, name))
            for name in compared]
        for name, k_t, p_t in pairs:
            if k_t.dtype == torch.float32:
                k_bits, p_bits = k_t.view(torch.int32), p_t.view(torch.int32)
            else:
                k_bits, p_bits = k_t, p_t
            if not torch.equal(k_bits, p_bits):
                idx = (k_bits != p_bits).nonzero()[0].tolist()
                raise AssertionError(
                    f"wave {w}: kernel and plain version differ in {name} "
                    f"at {idx}: {k_t[tuple(idx)].item()} vs "
                    f"{p_t[tuple(idx)].item()}"
                )
            max_err = max(max_err,
                          (k_t.float() - p_t.float()).abs().max().item())
        if w < sims:
            probs, v = evaluate(buf_k.obs)
            for buf in (buf_k, buf_p):
                buf.probs.copy_(probs)
                buf.value.copy_(v.reshape(bsz, 1))
    check(int(buf_k.counter[0]) == sims + 1,
          f"the device wave counter reads {int(buf_k.counter[0])} after "
          f"{sims + 1} steps")
    if not timed:
        return max_err, None, None, None, None, None

    # Times at the snapshot waves. The kernel: back-to-back launches on
    # copies of the carry, queued behind a GPU sleep so that host launch
    # cost stays out of the events. The plain version synchronises
    # internally; it is timed per call.
    kernel_ms, plain_ms, bound_ms, max_depth = {}, {}, {}, {}
    carry_bytes = 4 * bsz * (4 * a * (sims + 1) + 5 * (sims + 1) + 3)
    for w, buf, carry in snapshots:
        copies = [clone_step(fm, buf, carry)
                  for _ in range(SNAPSHOT_LAUNCHES)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        start.record()
        for copy in copies:
            fm.wave_step(*copy, geom)
        end.record()
        torch.cuda.synchronize()
        kernel_ms[w] = start.elapsed_time(end) / SNAPSHOT_LAUNCHES
        prev_depth = buf.path[:, 0].long()
        new_depth = copies[-1][0].path[:, 0].long()
        max_depth[w] = int(new_depth.max())
        bound_ms[w] = (touched_bytes(prev_depth, new_depth, a,
                                     geom.height * geom.width)
                       / HBM_BYTES_PER_S * 1e3)
        copy = clone_step(fm, buf, carry)
        start.record()
        fm.wave_step_reference(*copy, geom)
        end.record()
        torch.cuda.synchronize()
        plain_ms[w] = start.elapsed_time(end)
        log(f"  wave {w}: kernel {kernel_ms[w]:.4f} ms, plain "
            f"{plain_ms[w]:.3f} ms, bound {bound_ms[w]:.5f} ms, leaf depth "
            f"mean {new_depth.float().mean().item():.2f} max "
            f"{int(new_depth.max())}, backed-up path max "
            f"{int(prev_depth.max())}")
    waves = sorted(kernel_ms)
    fit = line_fit([max_depth[w] for w in waves],
                   [kernel_ms[w] for w in waves])
    log(f"  kernel ms against the deepest new leaf's depth, {len(waves)} "
        f"waves: {fit[0]:.4f} ms + {fit[1]:.5f} ms per level")
    def mean(by_wave):
        return sum(by_wave[w] for w in HEADLINE_WAVES) / len(HEADLINE_WAVES)

    return (max_err, mean(kernel_ms), mean(plain_ms), mean(bound_ms),
            2 * carry_bytes / HBM_BYTES_PER_S * 1e3, fit)


def kernel_phase(kernel: str, gen, device):
    """Phases 3 and 6: ``kernel_vs_plain`` at 7x6 n=4 (timed) and 5x4 n=3;
    returns the 7x6 (max_abs_err over both, kernel_ms, plain_ms, bound_ms,
    carry_bound_ms, fit)."""
    from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN

    results = {}
    for geometry, timed in ((dict(width=7, height=6, n=4), True),
                            (dict(width=5, height=4, n=3), False)):
        env = ConnectN(ConnectNConfig(**geometry))
        cfg = MCTSConfig(simulations=SIMS, **NOISE)
        states = random_positions(env, BATCH, 20, gen, device)
        t0 = time.perf_counter()
        results[geometry["width"]] = kernel_vs_plain(env, cfg, states, SIMS,
                                                     gen, timed, kernel)
        log(f"{kernel} vs plain {geometry}: bit-equal on all 19 arrays "
            f"(carry, leaf board, renormed, mixed, root prior, observation, "
            f"path, wave counter) at every wave of a B={BATCH}, "
            f"{SIMS}-simulation search ({time.perf_counter() - t0:.1f} s)")
    max_err, kernel_ms, plain_ms, bound_ms, carry_bound_ms, fit = results[7]
    max_err = max(max_err, results[5][0])
    log(f"{kernel} step at B={BATCH}, N={SIMS + 1}, 7x6: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, touched-bytes bound "
        f"{bound_ms:.5f} ms, carry-bytes bound {carry_bound_ms:.4f} ms")
    return max_err, kernel_ms, plain_ms, bound_ms, carry_bound_ms, fit


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (float32 compared as int32 views)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def searches_agree(env, states, evaluate, label: str, names) -> int:
    """Phase 7: the named searches from ``states`` with one generator seed
    each: "general", or a kernel and how its waves are launched ("K2 host",
    "K1 graph", ...). Their root visits and value sums must be bit-equal.
    Returns K2's kernel launches in the timed searches."""
    from custom_alphazero_tpu_torch.config import MCTSConfig
    from custom_alphazero_tpu_torch.ops import fused_mcts, fused_mcts_v2
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    cfg = MCTSConfig(simulations=SIMS, **NOISE)
    device = states.board.device
    stats, k2_launches = {}, 0
    for name in names:
        gen = torch.Generator(device=device).manual_seed(7)
        fused_mcts.wave_step.launches = 0
        fused_mcts.wave_step_reference.calls = 0
        expected = 0
        if name == "general":
            mcts = MCTS(env, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = mcts.search(states, evaluate, gen, SIMS)
            stats[name] = (mcts.root_child_visits(tree),
                           mcts.root_child_value_sums(tree))
            waves = SIMS
        else:
            kernel, mode = name.split()
            search = (fused_mcts.FusedConnectNSearch if kernel == "K2"
                      else fused_mcts_v2.FusedConnectNSearchV2)(env, cfg)
            graph = mode == "graph"
            if graph:  # capture outside the timed search
                search.search_root_stats(states, evaluate, gen, SIMS)
                gen.manual_seed(7)
                fused_mcts.wave_step.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats[name] = search.search_root_stats(states, evaluate, gen,
                                                   SIMS, graph=graph)
            waves = SIMS + 1
            counter = int(search.static(BATCH, SIMS).buffers.counter[0])
            check(counter == waves, f"{label} {name}: the device wave "
                  f"counter reads {counter}, expected {waves}")
            if kernel == "K2":
                expected = waves
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_mcts.wave_step.launches
        plain_calls = fused_mcts.wave_step_reference.calls
        check(launches == expected, f"{label} {name}: K2 launched "
              f"{launches} times, expected {expected}")
        check(plain_calls == 0, f"{label} {name}: K2's plain version ran "
              f"{plain_calls} times")
        k2_launches += launches
        log(f"  {label}, {name} search: {wall:.3f} s, "
            f"{1e3 * wall / waves:.3f} ms per wave ({waves} waves)")
    visits, wsum = stats[names[0]]
    for name in names[1:]:
        check(same_bits(stats[name][0], visits),
              f"{label}: {name} root visits differ from {names[0]}'s")
        check(same_bits(stats[name][1], wsum),
              f"{label}: {name} root value sums differ from {names[0]}'s")
    sums = visits.sum(-1)
    check(bool((sums <= SIMS - 1).all()) and int(sums.max()) == SIMS - 1,
          f"{label}: root visits do not add up to at most {SIMS - 1}")
    log(f"{label}: root visits and value sums bit-equal across "
        f"{', '.join(names)} (B={BATCH}, {SIMS} simulations)")
    return k2_launches


def general_selfplay(env, mcts_cfg, sp_cfg, evaluate, device) -> None:
    """Phase 8: ``GENERAL_PLIES`` plies of self-play through the general
    search and through the fused one, from one generator seed each: the
    samples and stats must be identical."""
    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn

    runs = {}
    for fused in (False, True):
        generate = make_selfplay_fn(env, mcts_cfg, sp_cfg, GENERAL_PLIES,
                                    device=device, fused=fused)
        gen = torch.Generator(device=device).manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[fused] = generate(evaluate, gen, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"self-play, {'fused' if fused else 'general'} path: "
            f"{GENERAL_PLIES} plies x {BATCH} games x {SIMS} sims in "
            f"{wall:.2f} s = {GENERAL_PLIES * BATCH * SIMS / wall:.0f} "
            f"sims/s")
    (general_batch, general_stats), (fused_batch, fused_stats) = (
        runs[False], runs[True])
    for name, x, y in zip(fused_batch._fields, general_batch, fused_batch):
        check(same_bits(x, y),
              f"general and fused self-play samples differ in {name}")
    for name, x, y in zip(fused_stats._fields, general_stats, fused_stats):
        check(same_bits(x, y),
              f"general and fused self-play stats differ in {name}")
    check(int(fused_stats.plies) == GENERAL_PLIES * BATCH,
          "self-play did not play every ply")
    log(f"general and fused self-play: identical samples "
        f"({GENERAL_PLIES * BATCH} rows) and stats")


def time_forward(evaluate, obs, repeats: int = 5):
    """(device ms, host ms) of one evaluate call: the launches are queued
    behind a GPU sleep, so the events see device time only and the host
    clock sees the enqueue cost only. Few repeats: a full launch queue
    (about a thousand kernels) would block the host until the sleep ends."""
    evaluate(obs)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(repeats):
        evaluate(obs)
    host_ms = (time.perf_counter() - t0) * 1e3 / repeats
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, host_ms


def profile_ply(generate, evaluate, gen, label: str) -> None:
    """One more ply of the main path under torch.profiler: device busy time
    by kernel, the number of device kernels and of host launch calls per
    wave, and the device's idle share of the ply's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    generate(evaluate, gen, BATCH)  # warm-up (and capture) outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(evaluate, gen, BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count_by_name, host_calls = {}, {}, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            count_by_name[evt.name] = count_by_name.get(evt.name, 0) + 1
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
        elif evt.name in ("cudaLaunchKernel", "cudaGraphLaunch",
                          "cuLaunchKernel", "cudaMemcpyAsync",
                          "cudaMemsetAsync"):
            host_calls[evt.name] = host_calls.get(evt.name, 0) + 1
    busy = sum(by_name.values())
    if not by_name:
        log(f"profiled ply, {label}: device time not measured (no device "
            f"events)")
        return
    waves = SIMS + 1
    kernels = sum(count_by_name.values())
    search = sum(ms for name, ms in by_name.items() if "wave_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profiled ply, {label} ({waves} waves, B={BATCH}): wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; wave kernel {search:.2f} ms "
        f"({search / waves:.4f} ms/wave); {kernels / waves:.1f} device "
        f"kernels and copies per wave; host calls per wave: "
        + ", ".join(f"{name} {count / waves:.1f}"
                    for name, count in sorted(host_calls.items())))
    for name, ms in top:
        log(f"  {ms:8.2f} ms  {count_by_name[name] / waves:5.1f} per wave  "
            f"{name[:100]}")
    log(f"  {len(count_by_name)} kernel and copy names; wave kernel "
        f"launches on the device: "
        f"{sum(n for name, n in count_by_name.items() if 'wave_kernel' in name)}")


def launch_shapes(device) -> None:
    """K1 at the phase-3 shapes, rebuilt with 1, 2, 4 and 8 games (warps)
    per block: bit-equal to the plain version, and its times."""
    from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.ops import _build, fused_mcts_v2

    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=SIMS, **NOISE)
    flags = _build.NVCC_FLAGS
    for warps in (4, 1, 2, 8, 4):
        _build.NVCC_FLAGS = flags + (f"-DPUCT_WARPS_PER_BLOCK={warps}",)
        _build._LIBS.clear()
        fused_mcts_v2._KERNELS.clear()
        gen = torch.Generator(device=device).manual_seed(0)
        states = random_positions(env, BATCH, 20, gen, device)
        _, kernel_ms, _, _, _, fit = kernel_vs_plain(env, cfg, states, SIMS,
                                                     gen, True)
        log(f"K1, {warps} games per block: {kernel_ms:.4f} ms/wave, "
            f"{fit[0]:.4f} ms + {fit[1]:.5f} ms per level")
    _build.NVCC_FLAGS = flags


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["--launch-shapes"]:
        launch_shapes(torch.device("cuda"))
        return 0
    from custom_alphazero_tpu_torch.config import (
        ConnectNConfig,
        MCTSConfig,
        ModelConfig,
        SelfPlayConfig,
    )
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.io.checkpoint import load_jax_checkpoint
    from custom_alphazero_tpu_torch.models.convert import from_jax_variables
    from custom_alphazero_tpu_torch.ops import _build, fused_mcts_v2
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn

    t_start = time.perf_counter()
    # ---- 1. device ----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(["fused_mcts_v2", "fused_mcts"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- 3. K1 vs its plain version -----------------------------------------
    gen = torch.Generator(device=device).manual_seed(0)
    max_err, kernel_ms, plain_ms, bound_ms, carry_bound_ms, fit = (
        kernel_phase("K1", gen, device))

    # ---- 4. net -------------------------------------------------------------
    params, batch_stats, meta = load_jax_checkpoint(CHECKPOINT)
    env = ConnectN(ConnectNConfig())
    widths = dict(depth=4, filters=128, value_hidden=256)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    obs = env.observe(random_positions(env, BATCH, 30, gen, device))
    fp32 = ModelConfig(**widths, compute_dtype="float32")
    eval_cpu = make_evaluate_fn(from_jax_variables(
        params, batch_stats, 7, fp32, device="cpu"))
    eval_gpu = make_evaluate_fn(from_jax_variables(
        params, batch_stats, 7, fp32))
    net_bf16 = from_jax_variables(params, batch_stats, 7,
                                  ModelConfig(**widths))
    eval_bf16 = make_evaluate_fn(net_bf16)
    p_cpu, v_cpu = eval_cpu(obs.cpu())
    p_gpu, v_gpu = eval_gpu(obs)
    p_bf, v_bf = eval_bf16(obs)
    fp32_err = max((p_gpu.cpu() - p_cpu).abs().max().item(),
                   (v_gpu.cpu() - v_cpu).abs().max().item())
    bf16_err = max((p_bf - p_gpu).abs().max().item(),
                   (v_bf - v_gpu).abs().max().item())
    log(f"net (c4-r5 step {meta['steps']}): card fp32 vs CPU fp32 max-abs "
        f"{fp32_err:.3e} (probs, value); card bf16 vs card fp32 "
        f"{bf16_err:.3e}")
    check(fp32_err < 1e-4, f"fp32 forward differs from the CPU: {fp32_err}")
    # bf16 keeps ~3 significant digits through 9 convolutions of the
    # trained net; on the CPU the same comparison reaches 0.12 (value).
    check(bf16_err < 0.25, f"bf16 forward far from fp32: {bf16_err}")
    torch.backends.cudnn.allow_tf32 = True
    net_ms, net_host_ms = time_forward(eval_bf16, obs)
    log(f"net bf16 forward at B={BATCH}: device {net_ms:.4f} ms, host "
        f"enqueue {net_host_ms:.4f} ms")

    # ---- 5. main path: c4-r5 self-play --------------------------------------
    mcts_cfg = MCTSConfig(simulations=SIMS, greedy_from_move=12, **NOISE)
    sp_cfg = SelfPlayConfig(games_per_generation=BATCH, continuous=True,
                            exclude_draws=False)
    # The default path replays the search's CUDA graph; graph=False launches
    # every wave from the host. Host speed varies between calls, so the two
    # are timed here in turns; the first run is the main path's.
    generators = {
        "graph": make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES),
        "host launches": make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES,
                                          graph=False),
    }
    forwards = MAX_PLIES * SIMS
    for turn, label in enumerate(("graph", "host launches", "host launches",
                                  "graph")):
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generators[label](eval_bf16, gen, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        turn_launches = fused_mcts_v2.wave_step.launches
        plain_calls = fused_mcts_v2.wave_step_reference.calls
        # The first graph run also warms up and captures.
        expected = MAX_PLIES * (SIMS + 1) + (
            fused_mcts_v2.WARMUP_WAVES if turn == 0 else 0)
        check(turn_launches == expected, f"{label}: kernel launched "
              f"{turn_launches} times, expected {expected}")
        check(plain_calls == 0, f"plain version ran {plain_calls} times")
        kernel_s = turn_launches * kernel_ms / 1e3
        net_s = forwards * net_ms / 1e3
        log(f"self-play, {label}: {MAX_PLIES} plies x {BATCH} games x "
            f"{SIMS} sims in {wall:.2f} s = "
            f"{MAX_PLIES * BATCH * SIMS / wall:.0f} sims/s; {turn_launches} "
            f"kernel launches, {plain_calls} plain-version calls")
        log(f"  per wave {1e3 * wall / turn_launches:.3f} ms wall; split by "
            f"standalone device times x counts: kernel {kernel_s:.2f} s "
            f"({100 * kernel_s / wall:.1f}%), net {net_s:.2f} s "
            f"({100 * net_s / wall:.1f}%), rest (host work the device waits "
            f"for, small ops) {wall - kernel_s - net_s:.2f} s "
            f"({100 * (wall - kernel_s - net_s) / wall:.1f}%)")
        if turn == 0:
            (samples, stats), launches = out, turn_launches

    profile_ply(make_selfplay_fn(env, mcts_cfg, sp_cfg, 1), eval_bf16, gen,
                "graph")
    profile_ply(make_selfplay_fn(env, mcts_cfg, sp_cfg, 1, graph=False),
                eval_bf16, gen, "host launches")

    rows = MAX_PLIES * BATCH
    check(samples.obs.shape == (rows, 6, 7, 4), f"obs {samples.obs.shape}")
    check(samples.policy.shape == (rows, 7), "policy shape")
    for name, t in samples._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    pi_err = (samples.policy.sum(-1) - 1.0).abs().max().item()
    check(pi_err < 1e-5, f"pi rows do not sum to 1: {pi_err}")
    z = samples.value[samples.valid]
    check(bool(((z == -1) | (z == 0) | (z == 1)).all()), "z outside -1/0/1")
    games = int(stats.games)
    check(games > 0, "no game finished")
    check(games == int(stats.wins_first_mover) + int(stats.wins_second_mover)
          + int(stats.draws), "game counts do not add up")
    log(f"samples: {int(samples.valid.sum())} valid of {rows}; games "
        f"{games}: first-mover wins {int(stats.wins_first_mover)}, "
        f"second-mover wins {int(stats.wins_second_mover)}, draws "
        f"{int(stats.draws)}, mean length "
        f"{float(stats.mean_game_length):.2f}; pi row-sum err {pi_err:.1e}")

    # ---- 6. K2 vs its plain version -----------------------------------------
    k2 = kernel_phase("K2", gen, device)

    # ---- 7. the searches agree ----------------------------------------------
    # One algorithm per convolution, so that equal batches give equal bits.
    torch.backends.cudnn.deterministic = True
    states = random_positions(env, BATCH, 20, gen, device)
    fused = ("K2 host", "K1 host", "K2 graph", "K1 graph")
    k2_launches = searches_agree(env, states, dyadic_evaluate(7), "dyadic",
                                 fused + ("general",))
    k2_launches += searches_agree(env, states, eval_bf16, "c4-r5 bf16 net",
                                  fused)

    # ---- 8. general-path self-play ------------------------------------------
    general_selfplay(env, mcts_cfg, sp_cfg, eval_bf16, device)
    torch.backends.cudnn.deterministic = False

    # ---- 9. result lines ----------------------------------------------------
    k2_err, k2_ms, k2_plain_ms, k2_bound_ms, k2_carry_bound_ms, k2_fit = k2
    check(k2_launches > 0 and k2_err == 0.0, "K2 did not run or disagreed")
    kernels = [{
        "name": "fused_mcts_v2_wave",
        "route": "cuda",
        "source": "custom_alphazero_tpu_torch/csrc/fused_mcts_v2.cu",
        "replaces": "custom_alphazero_tpu/ops/fused_mcts_v2.py:68",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "carry_bound_ms": carry_bound_ms,
        "chain_intercept_ms": fit[0],
        "chain_ms_per_level": fit[1],
    }, {
        "name": "fused_mcts_wave",
        "route": "cuda",
        "source": "custom_alphazero_tpu_torch/csrc/fused_mcts.cu",
        "replaces": "custom_alphazero_tpu/ops/fused_mcts.py:80",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "carry_bound_ms": k2_carry_bound_ms,
        "chain_intercept_ms": k2_fit[0],
        "chain_ms_per_level": k2_fit[1],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
