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
3. K1 vs its plain version: whole searches (250 simulations, root noise
   on, a dyadic evaluator) from random positions at 7x6 n=4 and 5x4 n=3
   with B=1024, and at 7x6 n=4 with the arena's B=256, through the CUDA
   step kernel and ``wave_step_reference`` side by side; all 12 carry
   arrays, the leaf board, ``renormed``, ``mixed``, ``root_prior``, the
   observation, the recorded path and the wave counter must be bit-equal
   after every wave. Times of the kernel (CUDA events
   over back-to-back launches), of the plain version, the kernel's bytes
   bound, and a fit of kernel time against the deepest game's depth.
4. Net: the committed c4-r5 checkpoint through load_jax_checkpoint; the
   card's fp32 forward (TF32 off) against the CPU's, and bf16 against fp32.
5. Main path: c4-r5 self-play (depth 4, 128 filters, 250 simulations,
   Dirichlet alpha 1.0, continuous auto-reset, 1024 games, 42 plies) with
   the trained weights in bf16, every wave a replay of the search's CUDA
   graph (the step kernel + the net); every wave must go through the
   kernel and none through the plain version. Then the same generation
   with every wave launched from the host (``graph=False``). Prints
   simulations/s of each, the kernel / net / rest split, one profiled ply
   of each and the sample checks.
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
9. Codec and replay ring at full size (capacity 400,000, bit-packed
   observations): phase 5's 43,008 observations packed on the card, bytes
   equal to the CPU's; adds until the ring has wrapped, then a sample: ring
   contents, ``head``, ``size`` and the decoded sample equal to a CPU ring
   fed the same batches and indices. Prints the ring's device bytes and the
   time of an add and of a sample.
10. Train step at the c4-r5 width (batch 1024 from the ring, aux batch 256
   from data/train_labels_r5.npz), started from
   artifacts/c4-r5/final_training_state with its momentum: one float32 step
   on the card against the same step on the CPU (TF32 off; the gradient
   leaf by leaf, the CPU's step on the reversed batch beside it), then bf16
   steps: one profiled (device busy time, top kernels), 20 timed by the
   clock and by CUDA events, loss finite.
11. Arena at c4-r5 (256 games, MCTS, 250 simulations) of the trained net
   against itself: one ply's search with the mixed evaluator, graph
   replays against host launches, bit-equal; then two arenas: the counts
   add up, the log is consistent, two graph captures, then none. Prints
   their seconds and K1's launches.
12. The entry point: ``run(cfg, generations=2)`` on the committed c4-r5
   config with only its frequencies lowered (arena and checkpoint every 20
   steps, a tree render every generation; solver scoring on) in a
   temporary directory seeded with the committed training state: both
   generations train, both arenas run and are solver-scored (the line, the
   metric, positions and seconds), every render's root edges hold the
   search's 249 visits, the ``updated_mcts`` renders follow a promotion in
   the first arena, the checkpoint restores with a matching hash. Prints
   each generation's seconds by phase, K1's launches and the graph captures
   (three: self-play's one, the arena's two; the renders' general search
   adds none).
13. The supervisor: ``python -m custom_alphazero_tpu_torch.runtime.supervisor``
   with the flags of ``run_c4_r5.sh`` word for word, then
   ``--run.results_dir=<a copy of phase 12's run> --run.run_id=smoke
   --loop.generations=1``, from the repo root: it resumes at step 11,640,
   trains 20 steps, exits 0, and its checkpoint restores at step 11,660.
14. The strength tool with the committed net: ``labeled_policy_accuracy``
   on the 2,000 positions of data/eval_labels.npz in float32 on the card
   (TF32 off) and on the CPU (at most 2 argmax moves may differ), and in
   bf16 on the card; ``evaluate_strength`` at 250 simulations against the
   perfect opponent, 2 games from 12 random plies; the solver oracle as the
   general search's evaluator on the card keeps a won position's win.
15. The kernels' JSON line, the card's line, and the result line.

``python3 chip_smoke.py --launch-shapes`` runs a tuning aid in place of the
phases: K1 built with 1, 2, 4 and 8 games (warps) per block, each checked
and timed as in phase 3.
"""

from __future__ import annotations

import json
import math
import os
import platform
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "artifacts", "c4-r5", "iteration_11600")
TRAINING_STATE = os.path.join(REPO, "artifacts", "c4-r5",
                              "final_training_state")
C4R5_CONFIG = os.path.join(REPO, "artifacts", "c4-r5", "config.json")
LABELS = os.path.join(REPO, "data", "train_labels_r5.npz")
EVAL_LABELS = os.path.join(REPO, "data", "eval_labels.npz")
RUN_C4_R5 = os.path.join(REPO, "run_c4_r5.sh")
SUPERVISOR_TIMEOUT_S = 300
RING_CAPACITY = 400_000
TRAIN_BATCH = 1024
AUX_BATCH = 256
ARENA_GAMES = 256
# Phase 10, card vs CPU, per leaf: the L2 distance of the gradients over the
# larger of the leaf's gradient norm and the floor. Seven batches read
# 3.8e-3 to 1.1e-2 in the worst leaf (H100 80GB HBM3); the CPU's own step
# on the same rows in reverse order reads up to 2.8e-3. Leaves with a
# gradient have norms of 4e-4 and more; the one without holds 5e-8 of noise.
GRAD_L2_LIMIT = 5e-2
GRAD_NORM_FLOOR = 1e-4
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
    """Phases 3 and 6: ``kernel_vs_plain`` at 7x6 n=4 (timed) and 5x4 n=3
    at B=1024, and K1 also at 7x6 n=4 at the arena's B=256 (a quarter of
    the grid, another static carry); returns the timed run's (max_abs_err
    over all runs, kernel_ms, plain_ms, bound_ms, carry_bound_ms, fit)."""
    from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN

    shapes = [(dict(width=7, height=6, n=4), BATCH, True),
              (dict(width=5, height=4, n=3), BATCH, False)]
    if kernel == "K1":  # the searched arena launches it at this batch
        shapes.append((dict(width=7, height=6, n=4), ARENA_GAMES, False))
    results = []
    for geometry, batch, timed in shapes:
        env = ConnectN(ConnectNConfig(**geometry))
        cfg = MCTSConfig(simulations=SIMS, **NOISE)
        states = random_positions(env, batch, 20, gen, device)
        t0 = time.perf_counter()
        results.append(kernel_vs_plain(env, cfg, states, SIMS, gen, timed,
                                       kernel))
        log(f"{kernel} vs plain {geometry}: bit-equal on all 19 arrays "
            f"(carry, leaf board, renormed, mixed, root prior, observation, "
            f"path, wave counter) at every wave of a B={batch}, "
            f"{SIMS}-simulation search ({time.perf_counter() - t0:.1f} s)")
    _, kernel_ms, plain_ms, bound_ms, carry_bound_ms, fit = results[0]
    max_err = max(result[0] for result in results)
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


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cuLaunchKernel",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def profiled(fn):
    """One call of ``fn`` under torch.profiler, the device drained after it:
    (wall ms, device ms by kernel name, device events by kernel name, host
    launch calls by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms_by_name, count_by_name, host_calls = {}, {}, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            count_by_name[evt.name] = count_by_name.get(evt.name, 0) + 1
            ms_by_name[evt.name] = (ms_by_name.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / 1e3)
        elif evt.name in HOST_LAUNCH_CALLS:
            host_calls[evt.name] = host_calls.get(evt.name, 0) + 1
    return wall_ms, ms_by_name, count_by_name, host_calls


def profile_ply(generate, evaluate, gen, label: str) -> None:
    """One more ply of the main path under torch.profiler: device busy time
    by kernel, the number of device kernels and of host launch calls per
    wave, and the device's idle share of the ply's wall time."""
    generate(evaluate, gen, BATCH)  # warm-up (and capture) outside the trace
    wall_ms, by_name, count_by_name, host_calls = profiled(
        lambda: generate(evaluate, gen, BATCH))
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


def timed(fn, repeats: int = 1):
    """(result, wall ms per call) of ``fn``, the device drained around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / repeats


def profile_step(fn, label: str, top: int = 10) -> float:
    """One call of ``fn`` under torch.profiler: wall, device busy time, the
    idle share and the device kernels that took the most time. Returns the
    busy time in ms (nan where the profiler saw no device event)."""
    wall_ms, by_name, count_by_name, _ = profiled(fn)
    if not by_name:
        log(f"profiled {label}: device time not measured (no device events)")
        return math.nan
    busy = sum(by_name.values())
    log(f"profiled {label}: wall {wall_ms:.2f} ms (under the profiler), "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(count_by_name.values())} device kernels and copies")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:8.3f} ms  {count_by_name[name]:4d} x  {name[:100]}")
    return busy


def ring_phase(env, samples, gen, device):
    """Phase 9; returns the filled device ring and its codec."""
    from custom_alphazero_tpu_torch.replay.buffer import (
        replay_add,
        replay_gather,
        replay_init,
        replay_sample_indices,
    )
    from custom_alphazero_tpu_torch.replay.codec import codec_for_env

    codec = codec_for_env(env)
    codec.encode(samples.obs[:8])  # warm-up
    packed, pack_ms = timed(lambda: codec.encode(samples.obs))
    packed_cpu = codec.encode(samples.obs.cpu())
    check(torch.equal(packed.words.cpu(), packed_cpu.words)
          and torch.equal(packed.scalars.cpu(), packed_cpu.scalars),
          "packed observations differ between the card and the CPU")
    check(torch.equal(codec.decode(packed), samples.obs),
          "decode(encode(obs)) differs from obs on the card")
    rows = samples.obs.shape[0]
    log(f"codec: {rows} observations packed to {packed.words.shape[1]} "
        f"words ({4 * packed.words.shape[1]} B) each in {pack_ms:.2f} ms; "
        f"bytes equal to the CPU's; decode exact")

    rings = {d: replay_init(RING_CAPACITY, env.obs_shape, env.num_actions,
                            codec, device=d) for d in (device, "cpu")}
    cpu_samples = type(samples)(*(t.cpu() for t in samples))
    valid = int(samples.valid.sum())
    adds = RING_CAPACITY // valid + 2  # enough rows for the ring to wrap
    add_ms = []
    for i in range(adds):
        for d, batch in ((device, samples), ("cpu", cpu_samples)):
            # Each add differs from the last: the outcomes change sign.
            batch = batch._replace(value=batch.value * (-1) ** i)
            if d == "cpu":
                rings[d] = replay_add(rings[d], batch, codec)
            else:
                rings[d], ms = timed(
                    lambda: replay_add(rings[d], batch, codec))
                add_ms.append(ms)
    ring, ring_cpu = rings[device], rings["cpu"]
    check(int(ring.size) == RING_CAPACITY
          and int(ring.head) == (adds * valid) % RING_CAPACITY,
          f"ring size {int(ring.size)} head {int(ring.head)}")
    for name, x, y in (("words", ring.obs.words, ring_cpu.obs.words),
                       ("scalars", ring.obs.scalars, ring_cpu.obs.scalars),
                       ("policy", ring.policy, ring_cpu.policy),
                       ("value", ring.value, ring_cpu.value),
                       ("head", ring.head, ring_cpu.head),
                       ("size", ring.size, ring_cpu.size)):
        # The spare row takes the dropped writes in no fixed order.
        x, y = (x[:RING_CAPACITY], y[:RING_CAPACITY]) if x.dim() else (x, y)
        check(torch.equal(x.cpu(), y), f"ring {name} differs from the CPU's")
    replay_sample_indices(ring, gen, TRAIN_BATCH)  # warm-up
    indices, draw_ms = timed(
        lambda: replay_sample_indices(ring, gen, TRAIN_BATCH))
    check(len(set(indices.tolist())) == TRAIN_BATCH
          and int(indices.max()) < RING_CAPACITY, "sample indices repeat")
    batch, gather_ms = timed(lambda: replay_gather(ring, indices, codec))
    batch_cpu = replay_gather(ring_cpu, indices.cpu(), codec)
    for name, x, y in zip(("obs", "policy", "value"), batch, batch_cpu):
        check(torch.equal(x.cpu(), y), f"sampled {name} differs from the "
              f"CPU ring's")
    ring_bytes = sum(t.numel() * t.element_size()
                     for t in (*ring.obs, ring.policy, ring.value))
    log(f"ring: capacity {RING_CAPACITY}, {ring_bytes} device bytes "
        f"({ring_bytes / (RING_CAPACITY + 1):.0f} B per row); {adds} adds of "
        f"{rows} rows ({valid} valid) wrapped it: contents, head, size and "
        f"a decoded sample of {TRAIN_BATCH} equal to the CPU ring's; add "
        f"{sum(add_ms[1:]) / len(add_ms[1:]):.2f} ms, draw {draw_ms:.2f} "
        f"ms, gather + decode {gather_ms:.2f} ms")
    return ring, codec


def train_phase(ring, codec, gen, device):
    """Phase 10."""
    import numpy as np

    from custom_alphazero_tpu_torch.config import ModelConfig
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint
    from custom_alphazero_tpu_torch.models.convert import (
        train_state_from_jax,
    )
    from custom_alphazero_tpu_torch.replay.buffer import replay_sample
    from custom_alphazero_tpu_torch.runtime.train import make_train_step

    tree, meta = load_checkpoint(TRAINING_STATE)
    with np.load(LABELS) as labels:
        aux_cpu = tuple(torch.from_numpy(labels[k].astype(np.float32))
                        for k in ("obs", "z"))
    aux = {device: tuple(t.to(device) for t in aux_cpu), "cpu": aux_cpu}
    widths = dict(depth=4, filters=128, value_hidden=256,
                  lr_boundaries=(10000, 13000),
                  lr_values=(0.0005, 0.00025, 0.0001))
    fp32 = ModelConfig(**widths, compute_dtype="float32")
    step = make_train_step(fp32, aux_value_weight=0.25,
                           aux_value_batch=AUX_BATCH)
    obs, pi, z = replay_sample(ring, gen, TRAIN_BATCH, codec)
    aux_idx = torch.randint(0, aux[device][0].shape[0], (AUX_BATCH,),
                            generator=gen, device=device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The same step three times: on the card, on the CPU, and on the CPU
    # with the batch's rows in reverse order. The last computes the same
    # sums in another order: its distance from the CPU's step is what
    # float32 rounding alone does to this gradient.
    runs = (("card", device, False), ("cpu", "cpu", False),
            ("cpu reversed", "cpu", True))
    states, metrics = {}, {}
    for label, d, reverse in runs:
        states[label] = train_state_from_jax(tree, 7, fp32, device=d)
        if label == "cpu":
            trace_before = [t.clone() for t in states[label].trace]
        rows = tuple(t.flip(0) if reverse else t for t in (obs, pi, z))
        t0 = time.perf_counter()
        _, metrics[label] = step(states[label], *(t.to(d) for t in rows),
                                 None, *aux[d], None, aux_idx.to(d))
        if label == "cpu":
            log(f"  the CPU's float32 step took "
                f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = True
    gpu, cpu, reversed_ = (states[label] for label, _, _ in runs)
    check(gpu.steps == meta["steps"] + 1 == cpu.steps, "step count")
    terms = ("loss", "policy_loss", "value_loss", "l2", "solver_value_loss")
    term_err = max(abs(float(getattr(metrics["card"], t))
                       - float(getattr(metrics["cpu"], t))) for t in terms)

    def max_err(xs, ys):
        return max((x.cpu() - y).abs().max().item() for x, y in zip(xs, ys))

    param_err = max_err(gpu.net.parameters(), cpu.net.parameters())
    stat_err = max_err(gpu.net.buffers(), cpu.net.buffers())
    m = metrics["card"]
    log(f"train step, float32, from step {meta['steps']} (lr "
        f"{m.learning_rate:.6g}): card vs CPU max-abs: loss terms "
        f"{term_err:.3e} (loss {float(m.loss):.5f}, policy "
        f"{float(m.policy_loss):.5f}, value {float(m.value_loss):.5f}, aux "
        f"value {float(m.solver_value_loss):.5f}), parameters "
        f"{param_err:.3e}, running statistics {stat_err:.3e}")
    check(term_err < 1e-4, f"loss terms differ from the CPU's: {term_err}")
    check(param_err < 1e-4, f"parameters differ from the CPU's: {param_err}")
    check(stat_err < 1e-4, f"running statistics differ: {stat_err}")
    # The gradient, leaf by leaf. The momentum after the step is gradient +
    # momentum x the momentum before it, and the latter is the same bits in
    # every run: the momenta differ by what the gradients differ. Each leaf
    # is held by its L2 distance over its own L2 norm (the largest entry of
    # the difference, also printed, is one ReLU input that rounds to the
    # other side of zero and moves with the sample drawn). A leaf whose
    # exact gradient is zero (the policy head's conv bias: BatchNorm follows
    # it and the aux term has no policy part) holds rounding noise only,
    # which the floor on the norm covers.
    leaves = gradient_errors(cpu, trace_before, fp32.momentum,
                             {"card": gpu, "cpu reversed": reversed_})

    def l2_ratio(leaf, label):
        return leaf[3][label][1] / max(leaf[2], GRAD_NORM_FLOOR)

    for label in ("card", "cpu reversed"):
        name, largest, norm, errs = max(
            leaves, key=lambda leaf: l2_ratio(leaf, label))
        by_entry = max(leaves, key=lambda leaf: leaf[3][label][0]
                       / max(leaf[1], GRAD_NORM_FLOOR))
        log(f"  gradient, {label} vs CPU, {len(leaves)} leaves: worst L2 "
            f"distance over max(the leaf's norm, {GRAD_NORM_FLOOR:g}): "
            f"{errs[label][1] / max(norm, GRAD_NORM_FLOOR):.3e} in {name} "
            f"(distance {errs[label][1]:.3e}, norm {norm:.3e}); worst "
            f"max-abs over the leaf's largest entry: "
            f"{by_entry[3][label][0] / max(by_entry[1], GRAD_NORM_FLOOR):.3e}"
            f" in {by_entry[0]} (max-abs {by_entry[3][label][0]:.3e}, "
            f"largest entry {by_entry[1]:.3e})")
    for leaf in leaves:
        check(l2_ratio(leaf, "card") < GRAD_L2_LIMIT,
              f"gradient of {leaf[0]} differs from the CPU's: L2 distance "
              f"{leaf[3]['card'][1]:.3e}, norm {leaf[2]:.3e}")

    bf16 = ModelConfig(**widths)
    state = train_state_from_jax(tree, 7, bf16)
    step = make_train_step(bf16, aux_value_weight=0.25,
                           aux_value_batch=AUX_BATCH)

    def one_step():
        # As the loop runs it: the ring's sample, the step, the loss read.
        _, m = step(state, *replay_sample(ring, gen, TRAIN_BATCH, codec), gen,
                    *aux[device])
        return float(m.loss)

    one_step()  # warm-up (cuDNN picks its algorithms)
    busy_ms = profile_step(one_step, "train step, bf16")
    _, sample_ms = timed(
        lambda: replay_sample(ring, gen, TRAIN_BATCH, codec), 20)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loss, wall_ms = timed(one_step, 20)
    end.record()
    torch.cuda.synchronize()
    check(math.isfinite(loss), "bf16 loss is not finite")
    log(f"train step, bf16, batch {TRAIN_BATCH} + aux {AUX_BATCH}, 20 steps "
        f"as the loop runs them (the ring's sample, the step, the loss "
        f"read): wall {wall_ms:.3f} ms per step by the clock, "
        f"{start.elapsed_time(end) / 20:.3f} ms by CUDA events around the "
        f"same 20; device busy {busy_ms:.3f} ms (the profiled step); the "
        f"ring's sample alone {sample_ms:.3f} ms; loss {loss:.5f} at step "
        f"{state.steps}")


def gradient_errors(reference, trace_before, momentum: float, others):
    """Per leaf of ``reference`` (a train state one step after
    ``trace_before``): (name, the gradient's largest entry, its L2 norm,
    {label: (max-abs, L2) distance of that state's momentum from the
    reference's}) for the states of ``others``, which took the same step
    from the same momentum."""
    leaves = []
    names = [name for name, _ in reference.net.named_parameters()]
    for i, (name, before) in enumerate(zip(names, trace_before)):
        grad = reference.trace[i] - momentum * before
        errs = {}
        for label, state in others.items():
            diff = state.trace[i].cpu() - reference.trace[i]
            errs[label] = (diff.abs().max().item(), diff.norm().item())
        leaves.append((name, grad.abs().max().item(), grad.norm().item(),
                       errs))
    return leaves


def arena_phase(env, mcts_cfg, net, gen, device):
    """Phase 11; returns K1's launches in one arena."""
    from custom_alphazero_tpu_torch.config import ArenaConfig
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.runtime.arena import (
        _mixed_evaluators,
        make_arena_fn,
    )
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn

    search_cls = fused_mcts_v2.FusedConnectNSearchV2
    arena = make_arena_fn(env, ArenaConfig(games=ARENA_GAMES,
                                           evaluate_with_mcts=True),
                          mcts_cfg, MAX_PLIES)
    candidate, incumbent = make_evaluate_fn(net), make_evaluate_fn(net)

    # One ply's search as the arena runs it (B=256, the odd plies' mixed
    # evaluator: each net forwards its half), replayed from its graph and
    # launched from the host, one noise seed: the same root statistics.
    starters = (torch.arange(ARENA_GAMES, device=device)
                >= ARENA_GAMES // 2).to(torch.int32)
    odd_ply = _mixed_evaluators(candidate, incumbent, starters)[1]
    search = search_cls(env, mcts_cfg, device)
    states = random_positions(env, ARENA_GAMES, 20, gen, device)
    torch.backends.cudnn.deterministic = True  # one algorithm per conv
    stats = []
    for graph in (True, False):
        seeded = torch.Generator(device=device).manual_seed(11)
        stats.append(search.search_root_stats(states, odd_ply, seeded, SIMS,
                                              graph=graph))
    torch.backends.cudnn.deterministic = False
    check(same_bits(stats[0][0], stats[1][0])
          and same_bits(stats[0][1], stats[1][1]),
          "arena ply: graph-replayed and host-launched searches differ")
    log(f"arena ply search (B={ARENA_GAMES}, mixed evaluator, {SIMS} "
        f"simulations): root visits and value sums bit-equal between the "
        f"graph's replays and host launches")

    seconds = []
    for _ in range(2):  # the second arena replays the first one's graphs
        captures = search_cls.captures
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        result, ms = timed(
            lambda: arena(candidate, incumbent, gen, ARENA_GAMES))
        seconds.append(ms / 1e3)
        captures = search_cls.captures - captures
        launches = fused_mcts_v2.wave_step.launches
        expected = MAX_PLIES * (SIMS + 1) + (
            captures * fused_mcts_v2.WARMUP_WAVES)
        check(launches == expected, f"arena: kernel launched {launches} "
              f"times, expected {expected}")
        check(fused_mcts_v2.wave_step_reference.calls == 0,
              "arena: the plain version ran")
        check(captures == (2 if len(seconds) == 1 else 0),
              f"arena {len(seconds)}: {captures} graph captures")
        wins, losses, draws = (int(result.wins), int(result.losses),
                               int(result.draws))
        check(wins + losses + draws == ARENA_GAMES, "arena counts")
        log_ = result.log
        half = ARENA_GAMES // 2
        check(bool((log_.movers[0, :half] == 0).all())
              and bool((log_.movers[0, half:] == 1).all())
              and bool((log_.movers[1:] == 1 - log_.movers[:-1]).all()),
              "arena movers")
        check(bool((log_.active[1:] <= log_.active[:-1]).all()),
              "arena active masks are not prefixes")
        check(bool(((log_.actions >= 0) & (log_.actions < 7)).all()),
              "arena actions out of range")
        decisive = max(wins + losses, 1)
        check(abs(float(result.score) - (wins / decisive if wins + losses
                                         else 0.5)) < 1e-6, "arena score")
        log(f"arena {len(seconds)}: {ARENA_GAMES} games x {MAX_PLIES} plies "
            f"x {SIMS} sims in {seconds[-1]:.2f} s: +{wins}/-{losses}/="
            f"{draws}, score {float(result.score):.3f}, promote "
            f"{bool(result.promote)}; {launches} kernel launches, "
            f"{captures} graph captures")
    return launches


class Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def host_cpu() -> str:
    """The host's CPU model, as lscpu or /proc/cpuinfo name it."""
    try:
        lines = subprocess.run(["lscpu"], capture_output=True,
                               text=True).stdout.splitlines()
    except OSError:
        lines = []
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as fp:
            lines += fp.read().splitlines()
    for key in ("Model name", "model name", "Model", "cpu model"):
        for line in lines:
            name, _, value = line.partition(":")
            if name.strip() == key and value.strip():
                return value.strip()
    return platform.machine() or "unknown"


def root_edge_visits(dot_path: str) -> int:
    """Sum of the N= labels on the root's edges of a rendered tree."""
    with open(dot_path) as fp:
        return sum(int(n) for n in re.findall(r"^  n0 -> n\d+ .*N=(\d+) ",
                                              fp.read(), re.M))


def learner_phase(device):
    """Phase 12; returns (K1's launches over the run, a copy of the run's
    results directory for phase 13)."""
    from custom_alphazero_tpu_torch.config import apply_overrides, from_json
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.runtime.loop import run
    from custom_alphazero_tpu_torch.tools import strength

    with open(C4R5_CONFIG) as fp:
        cfg = from_json(fp.read())
    results = tempfile.mkdtemp(prefix="chip_smoke_")
    # Solver scoring starts from an empty solve cache, as on a fresh machine.
    os.environ["CAZ_SOLVER_CACHE"] = os.path.join(results, "solver_cache.npz")
    scored = []  # (positions, seconds, score) per arena
    score_arena_log = strength.score_arena_log

    def counted(log):
        # The loop's call, timed, with the number of positions it scores
        # (candidate moves from ply 8 on, at most 200).
        active, movers = log.active.cpu().numpy(), log.movers.cpu().numpy()
        candidates = int((active[8:] & (movers[8:] == 0)).sum())
        t0 = time.perf_counter()
        score = score_arena_log(log)
        scored.append((min(candidates, 200), time.perf_counter() - t0,
                       score))
        return score

    tee = Tee(sys.stdout)
    try:
        cfg = apply_overrides(cfg, {
            "loop.visualize_frequency": "1",
            "arena.evaluation_frequency": "20",
            "arena.checkpoint_frequency": "20",
            "loop.solver_labels_path": LABELS,
            "run.results_dir": results,
            "run.run_id": "smoke",
        })
        check(cfg.arena.evaluate_with_solver, "learner: solver scoring off")
        training_dir = paths.training_path(results, cfg.game, "smoke")
        shutil.copytree(TRAINING_STATE, training_dir)
        _, meta0 = load_checkpoint(training_dir)
        captures = fused_mcts_v2.FusedConnectNSearchV2.captures
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        strength.score_arena_log = counted
        sys.stdout = tee
        t0 = time.perf_counter()
        summary = run(cfg, generations=2)
        wall = time.perf_counter() - t0
        launches = fused_mcts_v2.wave_step.launches
        captures = fused_mcts_v2.FusedConnectNSearchV2.captures - captures
        check(fused_mcts_v2.wave_step_reference.calls == 0,
              "learner: the plain version ran")
        tree, meta = load_checkpoint(training_dir)  # checks the hash
        evaluations = sorted(os.listdir(
            paths.evaluation_path(results, cfg.game, "smoke")))
        with open(os.path.join(paths.tensorboard_path(
                results, cfg.game, "smoke"), "metrics.jsonl")) as fp:
            solver_metrics = {m["step"]: m["value"] for m in map(
                json.loads, fp) if m["tag"] == "evaluation/solver_score"}
        renders = {}
        for g in range(2):
            renders[g] = root_edge_visits(os.path.join(
                paths.self_play_iteration_path(results, cfg.game, "smoke", g),
                f"mcts_iteration_{g}_light.dot"))
        updated_dir = paths.updated_mcts_path(results, cfg.game, "smoke")
        updated = sorted(name for name in os.listdir(updated_dir)
                         if name.endswith(".dot"))
        if updated:
            renders["updated"] = [root_edge_visits(
                os.path.join(updated_dir, name)) for name in updated]
        run_copy = tempfile.mkdtemp(prefix="chip_smoke_run_")
        shutil.copytree(paths.run_path(results, cfg.game, "smoke"),
                        paths.run_path(run_copy, cfg.game, "smoke"))
    finally:
        sys.stdout = tee.stream
        strength.score_arena_log = score_arena_log
        shutil.rmtree(results, ignore_errors=True)
    out = tee.text()
    steps = cfg.loop.train_iterations_per_generation
    arenas = [meta0["steps"] + steps, meta0["steps"] + 2 * steps]
    check(summary["iterations"] == meta0["steps"] + 2 * steps
          == meta["steps"] == int(tree["steps"]),
          f"learner: {summary['iterations']} iterations, checkpoint at "
          f"{meta['steps']}, started from {meta0['steps']}")
    check(summary["last_arena_score"] is not None, "learner: no arena ran")
    check(evaluations == [f"iteration_{i}" for i in arenas],
          f"learner: evaluation checkpoints {evaluations}")
    # Solver scoring after both arenas: the line, the metric, the count.
    check(len(scored) == 2, f"learner: {len(scored)} solver scorings")
    for iteration, (positions, seconds, score) in zip(arenas, scored):
        line = re.search(rf"\[iter {iteration}\] solver score=([0-9.]+)", out)
        check(line is not None and 0.0 <= float(line.group(1)) <= 1.0,
              f"learner: no solver score line at iteration {iteration}")
        check(iteration in solver_metrics
              and abs(solver_metrics[iteration] - score) < 1e-6,
              f"learner: no evaluation/solver_score at {iteration}")
        log(f"learner arena at step {iteration}: solver score {score:.4f} "
            f"from {positions} positions in {seconds:.2f} s "
            f"({1e3 * seconds / max(positions, 1):.1f} ms per position)")
    # Renders: every generation's light tree holds the search's root visits
    # (simulations - 1 from the opening); after a promotion in the first
    # generation's arena, the second generation's render is archived too.
    for g in range(2):
        check(renders[g] == SIMS - 1, f"learner: generation {g}'s render "
              f"has {renders[g]} root visits, expected {SIMS - 1}")
    promoted_first = re.search(rf"\[iter {arenas[0]}\] arena score=.* "
                               r"promoted=True", out) is not None
    expected = (["mcts_iteration_1_full.dot", "mcts_iteration_1_light.dot"]
                if promoted_first else [])
    check(updated == expected, f"learner: updated renders {updated}, "
          f"expected {expected}")
    check(all(n == SIMS - 1 for n in renders.get("updated", [])),
          f"learner: updated renders' root visits {renders.get('updated')}")
    for timing in summary["timings"]:
        check(timing["train_iterations"] == steps,
              f"generation {timing['generation']} trained "
              f"{timing['train_iterations']} steps")
        log(f"learner generation {timing['generation']}: "
            f"{timing['samples']} samples, "
            f"{timing['sims_per_second']:.0f} sims/s; seconds: generate "
            f"{timing['generate_s']:.2f}, render "
            f"{timing['render_s']:.2f}, replay {timing['replay_s']:.3f}, "
            f"train {timing['train_s']:.3f} ({steps} steps), arena "
            f"{timing['arena_s']:.2f}, solver scoring "
            f"{timing['solver_score_s']:.2f}, checkpoint "
            f"{timing['checkpoint_s']:.3f}")
    # Self-play's graph over the best net once, the arena's two once; the
    # renders' general search captures nothing and launches no K1.
    check(captures == 3, f"learner: {captures} graph captures, expected 3")
    expected = (4 * MAX_PLIES * (SIMS + 1)
                + captures * fused_mcts_v2.WARMUP_WAVES)
    check(launches == expected, f"learner: kernel launched {launches} "
          f"times, expected {expected}")
    log(f"learner: 2 generations and 2 arenas in {wall:.1f} s, "
        f"{summary['promotions']} promotions, steps {meta0['steps']} -> "
        f"{meta['steps']}, checkpoint restored with a matching hash; "
        f"{launches} kernel launches; {captures} graph captures (self-play "
        f"1, arena 2); renders {renders}")
    return launches, run_copy


def run_c4_r5_flags() -> list:
    """The flags of run_c4_r5.sh's command, word for word as bash passes
    them: the supervisor's, then the loop's."""
    with open(RUN_C4_R5) as fp:
        script = fp.read().replace("\\\n", " ")
    command = next(line for line in script.splitlines()
                   if line.startswith("exec "))
    return [word for word in shlex.split(command) if word.startswith("--")]


def supervisor_phase(run_copy: str) -> None:
    """Phase 13: the supervisor with run_c4_r5.sh's flags, resuming phase
    12's run for one generation in a subprocess from the repo root."""
    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint

    flags = run_c4_r5_flags()
    check(flags[0] == "--supervise.liveness_timeout_minutes=10"
          and "--arena.evaluate_with_solver=true" in flags
          and "--loop.visualize_frequency=100" in flags,
          f"run_c4_r5.sh flags: {flags}")
    cmd = [sys.executable, "-m", "custom_alphazero_tpu_torch.runtime.supervisor",
           *flags, f"--run.results_dir={run_copy}", "--run.run_id=smoke",
           "--loop.generations=1"]
    try:
        t0 = time.perf_counter()
        # A process group of its own, so that a timeout ends the loop under
        # the supervisor too.
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out = proc.communicate(timeout=SUPERVISOR_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        wall = time.perf_counter() - t0
        for line in out.splitlines()[-12:]:
            log(f"  supervisor | {line}")
        check(proc.returncode == 0, f"supervisor exited {proc.returncode}")
        check("Resumed training state at step 11640" in out and "[gen 0]" in out,
              "supervisor: the loop did not resume at step 11640 and play")
        tree, meta = load_checkpoint(paths.training_path(
            run_copy, "connect_n", "smoke"))  # checks the hash
        check(meta["steps"] == int(tree["steps"]) == 11660,
              f"supervisor: checkpoint at step {meta['steps']}")
    finally:
        shutil.rmtree(run_copy, ignore_errors=True)
    log(f"supervisor: `python -m custom_alphazero_tpu_torch.runtime."
        f"supervisor` with run_c4_r5.sh's {len(flags)} flags + 3 overrides "
        f"exited 0 in {wall:.1f} s; steps 11640 -> 11660, checkpoint "
        f"restored with a matching hash")


def strength_phase(device) -> None:
    """Phase 14: the strength tool on the card with the committed net."""
    import numpy as np

    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch import solver as sv
    from custom_alphazero_tpu_torch.config import (
        MCTSConfig,
        apply_overrides,
        from_json,
        to_json,
    )
    from custom_alphazero_tpu_torch.search.mcts import MCTS
    from custom_alphazero_tpu_torch.tools import strength

    results = tempfile.mkdtemp(prefix="chip_smoke_strength_")
    os.environ["CAZ_SOLVER_CACHE"] = os.path.join(results, "solver_cache.npz")
    try:
        with open(C4R5_CONFIG) as fp:
            cfg = from_json(fp.read())
        for run_id, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            run_dir = paths.run_path(results, "connect_n", run_id)
            os.makedirs(run_dir)
            with open(os.path.join(run_dir, "config.json"), "w") as fp:
                fp.write(to_json(apply_overrides(
                    cfg, {"model.compute_dtype": dtype})))
            shutil.copytree(CHECKPOINT, paths.evaluation_iteration_path(
                results, "connect_n", run_id, 11600))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        loaded = {(run_id, d): strength.load_run_model(run_id, results,
                                                       device=d)
                  for run_id, d in (("fp32", device), ("fp32", "cpu"),
                                    ("bf16", device))}
        with np.load(EVAL_LABELS) as data:
            obs = data["obs"]
        legal = obs[:, 0, :, 1] + obs[:, 0, :, 2] == 0
        choices = {}
        for key, (_, evaluate, _, meta) in loaded.items():
            probs, _ = evaluate(torch.from_numpy(obs).to(key[1]))
            choices[key] = np.where(legal, probs.float().cpu().numpy(),
                                    -1.0).argmax(-1)
            report, ms = timed(lambda: strength.labeled_policy_accuracy(
                evaluate, EVAL_LABELS, device=key[1]))
            log(f"labeled policy accuracy, {key[0]} on {key[1]} (c4-r5 step "
                f"{meta['steps']}, {len(obs)} positions, {ms:.0f} ms): "
                f"{json.dumps(report)}")
        differ = int((choices[("fp32", device)]
                      != choices[("fp32", "cpu")]).sum())
        bf16_differ = int((choices[("bf16", device)]
                           != choices[("fp32", device)]).sum())
        log(f"argmax moves, float32 card vs float32 CPU: {differ} of "
            f"{len(obs)} differ; bf16 card vs float32 card: {bf16_differ}")
        check(differ <= 2, f"{differ} float32 moves differ between the card "
              f"and the CPU")
        torch.backends.cudnn.allow_tf32 = True

        env, evaluate, _, _ = loaded[("bf16", device)]
        t0 = time.perf_counter()
        report = strength.evaluate_strength(
            env, evaluate, num_games=2, use_mcts=True,
            mcts_cfg=MCTSConfig(simulations=SIMS), opponent="perfect",
            opening_plies=12, device=device)
        wall = time.perf_counter() - t0
        check(report["positions"] > 0
              and 0.0 <= report["move_accuracy"] <= 1.0
              and 0.0 <= report["mean_rank_score"] <= 1.0
              and len(report["results"]) == 2,
              f"evaluate_strength report {report}")
        log(f"evaluate_strength (bf16 net, general search {SIMS} sims at "
            f"B=1, vs perfect, 2 games from 12 random plies) in {wall:.1f} "
            f"s: {json.dumps(report)}")

        # The oracle as the search's evaluator, on the card: from a won
        # midgame (solver score 18) it must keep the win.
        board = np.zeros((6, 7), np.int8)
        state = env.init(1, device)
        for col in (3, 0, 3, 0, 3, 1):
            board, _ = sv.play_canonical(board, col)
            state, _ = env.step(state, torch.tensor([col], device=device))
        check(torch.equal(state.board[0].cpu(), torch.from_numpy(board)),
              "oracle: the env's board differs from the solver's")
        solver = sv.ConnectFourSolver(cache=None)
        check(solver.solve_board(board) == 18, "oracle: the position's score")
        mcts = MCTS(env, MCTSConfig(simulations=16))
        t0 = time.perf_counter()
        tree = mcts.search(state, sv.make_solver_evaluate_fn(7), None, 16)
        visits = mcts.root_child_visits(tree)[0].cpu()
        wall = time.perf_counter() - t0
        action = int(visits.argmax())
        child, ended = sv.play_canonical(board, action)
        wins = (sv._board_has_win(-child) if ended
                else solver.solve_board(child) < 0)
        check(wins, f"oracle search chose column {action}, which does not "
              f"win (visits {visits.tolist()})")
        log(f"oracle evaluator in the general search on the card (16 sims "
            f"from [3, 0, 3, 0, 3, 1], score 18): column {action}, a win; "
            f"root visits {visits.tolist()}; {wall:.2f} s")
    finally:
        shutil.rmtree(results, ignore_errors=True)


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
        f"{torch.__version__} cuda {torch.version.cuda} | host CPU "
        f"{host_cpu()}, {os.cpu_count()} cores (the solver runs on the host)")

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
    # every wave from the host; the first run is the main path's.
    generators = {
        "graph": make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES),
        "host launches": make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES,
                                          graph=False),
    }
    forwards = MAX_PLIES * SIMS
    for turn, label in enumerate(("graph", "host launches")):
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

    # ---- 9. codec and replay ring -------------------------------------------
    ring, codec = ring_phase(env, samples, gen, device)

    # ---- 10. train step -----------------------------------------------------
    train_phase(ring, codec, gen, device)
    del ring

    # ---- 11. arena ----------------------------------------------------------
    arena_launches = arena_phase(env, mcts_cfg, net_bf16, gen, device)

    # ---- 12. the entry point ------------------------------------------------
    learner_launches, run_copy = learner_phase(device)

    # ---- 13. the supervisor with run_c4_r5.sh's flags -----------------------
    supervisor_phase(run_copy)

    # ---- 14. the strength tool ----------------------------------------------
    strength_phase(device)

    # ---- 15. result lines ---------------------------------------------------
    k2_err, k2_ms, k2_plain_ms, k2_bound_ms, k2_carry_bound_ms, k2_fit = k2
    check(k2_launches > 0 and k2_err == 0.0, "K2 did not run or disagreed")
    kernels = [{
        "name": "fused_mcts_v2_wave",
        "route": "cuda",
        "source": "custom_alphazero_tpu_torch/csrc/fused_mcts_v2.cu",
        "replaces": "custom_alphazero_tpu/ops/fused_mcts_v2.py:68",
        "launches": launches,
        "launches_arena": arena_launches,
        "launches_learner": learner_launches,
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
