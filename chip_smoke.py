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
   kernel and none through the plain version. Then 6 plies (for time) of
   the same generation with every wave launched from the host
   (``graph=False``). Prints
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
   metric, positions and seconds; for time on 20 positions each, not
   200), every render's root edges hold the
   search's 249 visits, the ``updated_mcts`` renders follow a promotion in
   the first arena, the checkpoint restores with a matching hash. Prints
   each generation's seconds by phase, K1's launches and the graph captures
   (three: self-play's one, the arena's two; the renders' general search
   adds none), and holds ``safe_gamma.calls`` to one a search that drew
   root noise (``FusedNetCount``).
13. The supervisor: ``python -m custom_alphazero_tpu_torch.runtime.supervisor``
   with the flags of ``run_c4_r5.sh`` word for word, then
   ``--run.results_dir=<a copy of phase 12's run> --run.run_id=smoke
   --loop.generations=1``, from the repo root: it resumes at step 11,640,
   trains 20 steps, exits 0, and its checkpoint restores at step 11,660.
14. The strength tool with the committed net: ``labeled_policy_accuracy``
   on the 2,000 positions of data/eval_labels.npz in float32 on the card
   (TF32 off) and on the CPU (at most 2 argmax moves may differ), and in
   bf16 on the card; ``evaluate_strength`` (its default route, the fused
   search) at 250 simulations against the perfect opponent, 2 games from
   12 random plies; the solver oracle as the general search's evaluator on
   the card keeps a won position's win.
15. Chess engine: perft on the card equal to the published counts (every
   depth of six positions, start position depth 4, Kiwipete depth 3); 128
   random games of 40 plies played on the card and on the CPU with every
   state field, reward and observation equal after every ply; ``step``,
   ``step_lite`` and ``observe`` times at B=128.
16. Gumbel search on the card against the CPU: one search with the
   chess-r5 settings (100 simulations, m=16, top-K K=100) from 128 of phase
   15's positions, the committed net in float32 (TF32 off), the same Gumbel
   draws: actions and root visits equal in every game but one whose search
   took a decision closer than 1e-5 (relative), which is printed.
17. chess-r5 Gumbel self-play in bf16 (B=128, 100 simulations, continuous)
   for 4 plies (for time; 8 before the multi-GPU phase): simulations/s and
   the samples' checks, one search split by part (precompute, descent,
   env, net, backup), one profiled ply.
18. The entry point on chess: ``run(cfg, generations=1)`` on the committed
   chess-r5 config from its training state (step 2800), with 4-ply plain
   generation (4-ply games never end, so continuous generation keeps no
   sample), ``replay.min_size=512``, no sample-reuse clamp, arena and
   checkpoint every 16 steps: 16 steps trained, a 64-game MCTS arena of 4
   plies, the checkpoint restores with a matching hash. Prints the seconds
   by part.
19. The supervisor with ``run_chess_r5.sh``'s flags word for word, then
   ``--run.results_dir=<a copy of phase 18's run> --run.run_id=smoke
   --loop.generations=1 --self_play.max_plies=4``: it resumes at step
   2816, plays a generation and exits 0.
20. The Connect-4 evaluation battery (run_c4_r4_evals.sh's tools) on the
   committed c4-r5 net, each through its ``main``: ``final_eval`` with the
   2,000 labelled positions, 2 games per opponent at 250 simulations, seed
   7 (its printed lines and report keys those of the JAX log
   artifacts/c4-r5/final_eval_c4r5_250.log; every searched move through
   K1: launches = searches x 251 + 3 per capture, two captures, no
   plain-version call; phase 14 holds the same net's float32 raw policy
   on those positions to the CPU's); the fused route's root visits
   bit-equal to the general search's on 16 roots of those games (bf16 net,
   cuDNN deterministic) and both timed at B=1; ``lineage`` with the labels
   and a one-game probe per row; ``run_report`` on the committed metrics;
   ``book_from_cache`` on artifacts/solver_cache_warmed.npz and three
   solver probes with and without that book; ``distill``'s dataset (64 + 12
   positions from ply 16) and 100 train steps. Prints each tool's seconds.
21. The chess panel (run_chess_r5_evals.sh's tools) on the committed
   chess-r5 net: ``chess_tactics`` raw on both 300-position sets (bf16;
   float32 card vs CPU within one position per set), searched at 100
   simulations on the first 64 rows of each, the uniform control at 100
   simulations on 64 mate-in-2 rows (every decision equal to the CPU's);
   ``mate_in_1_labels`` / ``mate_in_2_labels`` on the first 64 / 16 rows
   equal to the committed masks; ``play_vs_opponent`` against the greedy
   opponent (one, for time; the CPU tests play both), 4 games of 16 plies
   at 100 simulations from the first two
   mate-in-1 rows (W/D/L and mean length equal to a replay of its moves on
   the CPU engine; at least one game decisive).
22. Subtree reuse: ``MCTS.search_tree`` and ``MCTS.advance_root`` on the
   card and on the CPU from 64 random c4-r5 positions, 250 simulations,
   the dyadic evaluator and the same Gamma draws, 3 greedy plies: every
   Tree field and ``free`` bit-equal after every search and advance. Then
   c4-r5 self-play with ``mcts.reuse_tree`` on the card (the trained net in
   bf16, B=1024, 4 plies): kept subtrees within keep_cap, visits carried
   into every search after the first; sims/s and ms per wave beside phase
   8's fresh-tree general search.
23. The serving tier: ``python -m custom_alphazero_tpu_torch.serving`` as a
   process on a run laid out from the committed c4-r5 net (bf16, batches
   of 16, port 0), driven through ``ServingClient``: run-id; 256
   single-state requests from 32 threads (after an untimed round of 32)
   and one 1024-state batch request,
   each move equal to the card's float32 forward wherever that forward's
   two best probabilities are at least 1e-3 and 4 times the row's bf16
   rounding apart (the disagreements at 1e-3 alone printed); the queue
   round trip;
   ``best-model/update`` after ``iteration_11660`` (phase 13's checkpoint;
   the committed training state holds the same weights as iteration_11600)
   appears, later replies following the new net; SIGINT, exit code 0. Then ``build_service`` in float32 in this process (TF32 off) within
   1e-4 of the CPU's forward, fewer forwards than requests. Prints latency
   p50 / p99, requests/s and the batch request's ms.
24. The profiling tools: ``tools.profile`` through its main (JAX's five
   keys) and its ``capture_trace`` at B=1024 with 8 simulations, for time
   (a Chrome trace of one generation that names K1's kernel, its K1
   kernel events beside the launch counter), and ``tools.inloop_bench 256
   --iters=1`` through its main (both lines).
25. Multi-GPU on the one card: NCCL at world size 1 (``initialize``, an
   all-reduce of a card tensor, ``broadcast_flag``, ``sync_hosts``); then
   two ranks on the card over Gloo (parallel/launch.py; the backend line
   printed): the dp=2 float32 train step against phase 10's one-rank step
   on the same 1024 rows and 256 aux rows (TF32 off, cuDNN deterministic;
   phase 10's bounds, the momentum held leaf by leaf through the
   gradient; a negative control, the same step with BatchNorm over each
   rank's own rows, must fail the gradient rule), the mp=2 float32
   forward of the c4-r5 net against one rank's (< 1e-4), and
   ``run(cfg, generations=2)`` on the c4-r5 config at dp=2 (512 games, a
   200,000-row ring and 128 arena games per rank; arena and checkpoint
   every 20 steps, 20 scored positions per arena): equal summaries, each
   rank's K1 launches exact with no plain-version call, nothing written by
   rank 1, a checkpoint of 400,000 rows with cursors of shape (2,), and a
   resume at dp=2 at the same step and ring size. Then, in the same two
   ranks, ``tools.dryrun_multigpu``'s dry run (mp=2, its five lines). Both
   ranks share one card: no figure here is a scaling figure.
26. The fused net (ops/fused_net.py, csrc/fused_net.cu): its pack kernel
    bit-equal to the plain layout, each conv layer and the heads on the
    kernel's own inputs against the plain version, then whole forwards, at
    c4 B=1,024 and 256 (the c4-r5 net), chess B=128 (the chess-r5 net,
    118 input planes) and c4 B=256 with AlphaZero's 19 x 256 identity-skip
    net and Leela Chess Zero's SE 20 x 256 net (seeded; its gates'
    ``se_kernel`` on the kernel's inputs too, and its forward on both conv
    tiles, twice bit-equal); a promote between two replays of one captured
    search graph gives a fresh capture's results, on the fused and the
    module path, and so does an in-place train step between two searches
    on one graph, in self-play and through the arena's mixed evaluator
    (``train_between_searches``: one pack a recorded forward a search);
    the forward's device time beside its bound, the plain
    version's and the module path's (cuDNN), and each kernel's, at c4-r5's
    B=1,024 and the 19 x 256, SE and b18c384nbt nets' B=256 (the
    b18c384nbt tower's pack bit-equal and each of its launches held to its
    plain layer first, ``nbt_forward_check``); each block conv of those two
    shapes through the pipelined kernel (``conv_times``: us a launch, the
    bound, the plain layer, cuDNN's conv alone). The kernels' line reports
    the fused net's launches counted from zero over main-path runs: phase
    11's arena, phase 12's ``run()`` and this phase's captured searches
    (c4-r5, 19 x 256, SE 20 x 256 and b18c384nbt: ``se.launches`` = 20 a
    forward in the SE net, 0 in the others; in the b18c384nbt tower 112
    convs a forward, ``conv.pointwise_launches`` 36, ``conv.preact_launches``
    54 and ``gpool.launches`` 3, 0 in the others), each held to its
    forwards (the packs: one an
    eager forward, plus one a forward recorded into a graph for each search
    that replays it, ``pack.search_launches``), and its Gamma draws to one
    ``safe_gamma`` call a noisy search (``FusedNetCount``).
27. The kernels' JSON line, the card's line, and the result line.

``python3 chip_smoke.py --launch-shapes`` runs a tuning aid in place of the
phases: K1 built with 1, 2, 4 and 8 games (warps) per block, each checked
and timed as in phase 3. ``python3 chip_smoke.py --conv-plans`` runs
another: both tiles of the pipelined conv at the block conv shapes of the
benchmark's cells and the arenas, each checked and timed
(``fused_net.conv_tile``'s cost model was fitted to it). ``python3
chip_smoke.py --fused-net`` runs phase 26 alone.
"""

from __future__ import annotations

import contextlib
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
# Phase 12 scores, to save time, only this many positions of each arena
# (the loop scores 200).
FIRST_ARENA_POSITIONS = 20
SECOND_ARENA_POSITIONS = 20
# Phase 10, card vs CPU, per leaf: the L2 distance of the gradients over the
# larger of the leaf's gradient norm and the floor. Seven batches read
# 3.8e-3 to 1.1e-2 in the worst leaf (H100 80GB HBM3); the CPU's own step
# on the same rows in reverse order reads up to 2.8e-3. Leaves with a
# gradient have norms of 4e-4 and more; the one without holds 5e-8 of noise.
GRAD_L2_LIMIT = 5e-2
GRAD_NORM_FLOOR = 1e-4
# Phase 25, the dp=2 step vs phase 10's one-rank step: the same rule and
# limit, which the negative control (BatchNorm over each rank's own rows)
# must fail.
DP2_GRAD_L2_LIMIT = GRAD_L2_LIMIT
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
BATCH = 1024
SIMS = 250
MAX_PLIES = 42
GENERAL_PLIES = 4  # phase 8: plies of each self-play path
# Phase 5's host-launched generation, for time: its rate only (the graph
# run plays all 42 plies).
HOST_PLIES = 6
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
    search._mcts.noise_plan(gen, sims, bsz, device, out=static.buffers.gamma)
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


def general_selfplay(env, mcts_cfg, sp_cfg, evaluate, device) -> float:
    """Phase 8: ``GENERAL_PLIES`` plies of self-play through the general
    search and through the fused one, from one generator seed each: the
    samples and stats must be identical. Returns the general path's
    simulations per second."""
    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn

    runs, rates = {}, {}
    for fused in (False, True):
        generate = make_selfplay_fn(env, mcts_cfg, sp_cfg, GENERAL_PLIES,
                                    device=device, fused=fused)
        gen = torch.Generator(device=device).manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[fused] = generate(evaluate, gen, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[fused] = GENERAL_PLIES * BATCH * SIMS / wall
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
    return rates[False]


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


def profiled(fn, host: bool = True):
    """One call of ``fn`` under torch.profiler, the device drained after it:
    (wall ms, device ms by kernel name, device events by kernel name, host
    launch calls by name). ``host=False`` traces the device only (no launch
    calls), which keeps a long trace quick to read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms_by_name, count_by_name, host_calls = {}, {}, {}
    # The raw events, as torch's own parse (``prof.events()``) reads them
    # but without its tree of Python objects: that costs some 80 us an
    # event, tens of seconds for a ply's hundreds of thousands.
    for evt in prof.profiler.kineto_results.events():
        if getattr(evt, "is_hidden_event", lambda: False)():
            continue
        name = evt.name()
        if evt.device_type() == DeviceType.CUDA:
            count_by_name[name] = count_by_name.get(name, 0) + 1
            ms_by_name[name] = (ms_by_name.get(name, 0.0)
                                + evt.duration_ns() / 1e6)
        elif name in HOST_LAUNCH_CALLS:
            host_calls[name] = host_calls.get(name, 0) + 1
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


def profile_step(fn, label: str, top: int = 10, host: bool = True) -> float:
    """One call of ``fn`` under torch.profiler: wall, device busy time, the
    idle share and the device kernels that took the most time. Returns the
    busy time in ms (nan where the profiler saw no device event)."""
    wall_ms, by_name, count_by_name, _ = profiled(fn, host)
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
    """Phase 10; returns the float32 step on the card (its inputs, the
    state after it, the momentum before it, its metrics) for phase 25."""
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

    card_step = {"obs": obs.cpu(), "pi": pi.cpu(), "z": z.cpu(),
                 "aux_idx": aux_idx.cpu(), "state": gpu,
                 "trace_before": trace_before, "metrics": metrics["card"]}
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
    return card_step


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


class FusedNetCount:
    """The fused net's launches over a run of the main path, from zero:
    each counter of ops/fused_net.py set to 0 on entry, and the forwards
    that ``make_evaluate_fn`` sent through ``FusedForward`` counted as
    recorded (inside a CUDA graph capture) or eager, beside the evaluations
    it sent to the module path on CUDA and the plain version's calls; the
    fused searches that replayed a graph, each with the ``FusedForward``s
    that its capture recorded (``graph_packs``: their sum over the
    searches); and the searches that drew their own root noise (``noisy``:
    root noise on, no ``gamma`` given) beside the Gamma sampler's calls
    (``noise``). ``check(name, depth, identity, se)`` holds the counters to
    the forwards: 1 + 2 x depth convs (``identity`` of them adding an
    identity block's input), ``se`` squeeze-excitation launches and one
    heads launch each; in a nested bottleneck tower (``nested`` = (convs,
    1x1 convs, dual-output convs, gpool launches) a forward) those counts
    in place of 1 + 2 x depth, and none of the nested kinds elsewhere; a
    pack each eager forward, none a recorded one, and
    ``pack.search_launches`` equal to ``graph_packs``; no module-path
    evaluation on the card, no plain forward; and one ``safe_gamma`` call a
    noisy search, whatever its length."""

    def __enter__(self):
        import inspect

        from custom_alphazero_tpu_torch.ops import fused_net, rng
        from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
            FusedConnectNSearchV2,
        )
        from custom_alphazero_tpu_torch.search.mcts import MCTS

        self.fused_net, self.rng = fused_net, rng
        fused_net.pack.launches = 0
        fused_net.pack.search_launches = 0
        fused_net.conv.launches = 0
        fused_net.conv.identity_launches = 0
        fused_net.conv.pointwise_launches = 0
        fused_net.conv.preact_launches = 0
        fused_net.se.launches = 0
        fused_net.gpool.launches = 0
        fused_net.heads.launches = 0
        self.recorded = self.eager = self.module = self.noisy = 0
        self.graph_packs = 0
        self.capture = []  # the FusedForwards recorded by this capture
        self.plain = fused_net.forward_plain.calls
        self.noise = rng.safe_gamma.calls
        self._call = fused_net.FusedForward.__call__
        self._applies = fused_net.applies
        count = self

        def noisy(fn):
            signature = inspect.signature(fn)

            def search(*args, **kwargs):
                bound = signature.bind(*args, **kwargs).arguments
                this = bound["self"]
                count.noisy += int(this.cfg.use_dirichlet
                                   and bound.get("gamma") is None)
                if not isinstance(this, FusedConnectNSearchV2):
                    return fn(*args, **kwargs)
                captures = FusedConnectNSearchV2.captures
                outer, count.capture = count.capture, []
                try:
                    out = fn(*args, **kwargs)
                finally:
                    recorded, count.capture = count.capture, outer
                graph = bound.get("graph")
                if graph or (graph is None and this.device.type == "cuda"):
                    # The graph this search replayed keeps the number of
                    # fused forwards its capture recorded.
                    wave = this.static(
                        bound["root_states"].board.shape[0],
                        bound["simulations"]).graphs[bound["evaluate_fn"]]
                    if FusedConnectNSearchV2.captures > captures:
                        wave.fused_forwards = len(recorded)
                    count.graph_packs += wave.fused_forwards
                return out
            return search

        self._searches = [(owner, name, getattr(owner, name))
                          for owner, name in ((MCTS, "search"),
                                              (MCTS, "search_tree"),
                                              (FusedConnectNSearchV2,
                                               "search_root_stats"))]
        for owner, name, fn in self._searches:
            setattr(owner, name, noisy(fn))

        def call(forward, obs):
            if torch.cuda.is_current_stream_capturing():
                count.recorded += 1
                if not any(f is forward for f in count.capture):
                    count.capture.append(forward)
            else:
                count.eager += 1
            return count._call(forward, obs)

        def applies(net, obs):
            taken = count._applies(net, obs)
            count.module += int(not taken and obs.device.type == "cuda")
            return taken

        fused_net.FusedForward.__call__ = call
        fused_net.applies = applies
        return self

    def __exit__(self, *exc):
        self.fused_net.FusedForward.__call__ = self._call
        self.fused_net.applies = self._applies
        for owner, name, fn in self._searches:
            setattr(owner, name, fn)
        self.plain = self.fused_net.forward_plain.calls - self.plain
        self.noise = self.rng.safe_gamma.calls - self.noise
        return False

    def check(self, name: str, depth: int, identity: int = 0,
              se: int = 0, nested=None) -> dict:
        fn = self.fused_net
        forwards = self.recorded + self.eager
        convs, pointwise, preact, pools = (
            (1 + 2 * depth, 0, 0, 0) if nested is None else nested)
        counts = {"pack": fn.pack.launches,
                  "pack_search": fn.pack.search_launches,
                  "conv": fn.conv.launches,
                  "conv_identity": fn.conv.identity_launches,
                  "conv_pointwise": fn.conv.pointwise_launches,
                  "conv_preact": fn.conv.preact_launches,
                  "se": fn.se.launches, "gpool": fn.gpool.launches,
                  "heads": fn.heads.launches,
                  "forwards_recorded": self.recorded,
                  "forwards_eager": self.eager,
                  "graph_packs": self.graph_packs,
                  "noisy_searches": self.noisy,
                  "safe_gamma_calls": self.noise}
        check(counts["pack"] == self.eager + counts["pack_search"]
              and counts["pack_search"] == self.graph_packs
              and forwards == counts["heads"]
              and counts["conv"] == convs * forwards
              and counts["conv_identity"] == identity * forwards
              and counts["conv_pointwise"] == pointwise * forwards
              and counts["conv_preact"] == preact * forwards
              and counts["gpool"] == pools * forwards
              and counts["se"] == se * forwards,
              f"{name}: fused net launches {counts} do not match its "
              f"forwards")
        check(self.module == 0, f"{name}: {self.module} evaluations took "
              f"the module path on the card")
        check(self.plain == 0, f"{name}: the plain forward ran")
        check(self.noise == self.noisy, f"{name}: {self.noise} safe_gamma "
              f"calls for {self.noisy} searches that drew root noise")
        return counts


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

    seconds, fused_counts = [], []
    for _ in range(2):  # the second arena replays the first one's graphs
        captures = search_cls.captures
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        with FusedNetCount() as count:
            result, ms = timed(
                lambda: arena(candidate, incumbent, gen, ARENA_GAMES))
        seconds.append(ms / 1e3)
        captures = search_cls.captures - captures
        launches = fused_mcts_v2.wave_step.launches
        # Both nets forward their half of every evaluation; all of an
        # arena's evaluations are a capture's warm-up waves and its
        # recorded wave, and its replays launch nothing from the host.
        fused_counts.append(count.check("arena", len(net.blocks)))
        check((count.recorded, count.eager) == (
                  2 * captures, 2 * captures * fused_mcts_v2.WARMUP_WAVES),
              f"arena {len(seconds)}: fused forwards {fused_counts[-1]}, "
              f"{captures} captures")
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
            f"{captures} graph captures; fused net {fused_counts[-1]}")
    return launches, fused_counts[0]


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
        # (candidate moves from ply 8 on; for time, at most
        # FIRST_ARENA_POSITIONS, then SECOND_ARENA_POSITIONS, not 200).
        active, movers = log.active.cpu().numpy(), log.movers.cpu().numpy()
        candidates = int((active[8:] & (movers[8:] == 0)).sum())
        limit = (FIRST_ARENA_POSITIONS if not scored
                 else SECOND_ARENA_POSITIONS)
        t0 = time.perf_counter()
        score = score_arena_log(log, max_positions=limit)
        scored.append((min(candidates, limit), time.perf_counter() - t0,
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
        with FusedNetCount() as fused_count:
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
    # The fused net: recorded once in self-play's graph (one net) and in
    # each arena graph (two nets, a half each); eager in those captures'
    # warm-up waves, and in the renders' general search.
    fused_counts = fused_count.check("learner", cfg.model.depth)
    check(fused_count.recorded == 1 + 2 * 2
          and fused_count.eager >= (1 + 2 * 2) * fused_mcts_v2.WARMUP_WAVES,
          f"learner: fused forwards {fused_counts}")
    # Root noise on: at least the two generations' 2 x MAX_PLIES searches
    # drew their noise, one safe_gamma call each.
    check(fused_count.noisy >= 2 * MAX_PLIES,
          f"learner: {fused_count.noisy} searches drew root noise")
    log(f"learner: 2 generations and 2 arenas in {wall:.1f} s, "
        f"{summary['promotions']} promotions, steps {meta0['steps']} -> "
        f"{meta['steps']}, checkpoint restored with a matching hash; "
        f"{launches} kernel launches; {captures} graph captures (self-play "
        f"1, arena 2); renders {renders}; fused net {fused_counts}")
    return (launches, fused_counts), run_copy


def script_flags(path: str) -> list:
    """The flags of a run script's command, word for word as bash passes
    them when the script is run without arguments: the supervisor's, then
    the loop's, with the script's ``NAME=${1:-default}`` variables put in."""
    with open(path) as fp:
        script = fp.read().replace("\\\n", " ")
    defaults = dict(re.findall(r"^(\w+)=\$\{1:-([^}]*)\}$", script, re.M))
    command = next(line for line in script.splitlines()
                   if line.startswith("exec "))
    words = [word for word in shlex.split(command) if word.startswith("--")]
    for name, value in defaults.items():
        words = [word.replace(f"${name}", value) for word in words]
    check(not any("$" in word for word in words), f"{path}: {words}")
    return words


def run_supervisor(args: list):
    """``python -m custom_alphazero_tpu_torch.runtime.supervisor *args`` from
    the repo root, in a process group of its own (a timeout ends the loop
    under the supervisor too): (output, wall seconds); raises unless it
    exits 0."""
    cmd = [sys.executable, "-m", "custom_alphazero_tpu_torch.runtime.supervisor",
           *args]
    t0 = time.perf_counter()
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
    return out, wall


def supervisor_phase(run_copy: str) -> str:
    """Phase 13: the supervisor with run_c4_r5.sh's flags, resuming phase
    12's run for one generation in a subprocess from the repo root. Returns
    a copy of its step-11,660 checkpoint without the ring (phase 23 serves
    it as a newer net)."""
    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.io.checkpoint import (
        REPLAY_FILE,
        load_checkpoint,
    )

    flags = script_flags(RUN_C4_R5)
    check(flags[0] == "--supervise.liveness_timeout_minutes=10"
          and "--arena.evaluate_with_solver=true" in flags
          and "--loop.visualize_frequency=100" in flags,
          f"run_c4_r5.sh flags: {flags}")
    try:
        out, wall = run_supervisor(
            flags + [f"--run.results_dir={run_copy}", "--run.run_id=smoke",
                     "--loop.generations=1"])
        check("Resumed training state at step 11640" in out and "[gen 0]" in out,
              "supervisor: the loop did not resume at step 11640 and play")
        tree, meta = load_checkpoint(paths.training_path(
            run_copy, "connect_n", "smoke"))  # checks the hash
        check(meta["steps"] == int(tree["steps"]) == 11660,
              f"supervisor: checkpoint at step {meta['steps']}")
        newer = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                             "step_11660")
        shutil.copytree(paths.training_path(run_copy, "connect_n", "smoke"),
                        newer, ignore=shutil.ignore_patterns(REPLAY_FILE))
    finally:
        shutil.rmtree(run_copy, ignore_errors=True)
    log(f"supervisor: `python -m custom_alphazero_tpu_torch.runtime."
        f"supervisor` with run_c4_r5.sh's {len(flags)} flags + 3 overrides "
        f"exited 0 in {wall:.1f} s; steps 11640 -> 11660, checkpoint "
        f"restored with a matching hash")
    return newer


def labelled_choices(evaluate, device):
    """The raw policy's argmax legal move on each of data/eval_labels.npz's
    2,000 positions, the net run on ``device``."""
    import numpy as np

    with np.load(EVAL_LABELS) as data:
        obs = data["obs"]
    legal = obs[:, 0, :, 1] + obs[:, 0, :, 2] == 0
    probs, _ = evaluate(torch.from_numpy(obs).to(device))
    return np.where(legal, probs.float().cpu().numpy(), -1.0).argmax(-1)


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
        choices = {}
        for key, (_, evaluate, _, meta) in loaded.items():
            choices[key] = labelled_choices(evaluate, key[1])
            report, ms = timed(lambda: strength.labeled_policy_accuracy(
                evaluate, EVAL_LABELS, device=key[1]))
            log(f"labeled policy accuracy, {key[0]} on {key[1]} (c4-r5 step "
                f"{meta['steps']}, {len(choices[key])} positions, {ms:.0f} "
                f"ms): "
                f"{json.dumps(report)}")
        differ = int((choices[("fp32", device)]
                      != choices[("fp32", "cpu")]).sum())
        bf16_differ = int((choices[("bf16", device)]
                           != choices[("fp32", device)]).sum())
        log(f"argmax moves, float32 card vs float32 CPU: {differ} of "
            f"{len(choices[key])} differ; bf16 card vs float32 card: "
            f"{bf16_differ}")
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
        log(f"evaluate_strength (bf16 net, fused search {SIMS} sims at "
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


# ---- chess-r5: engine, Gumbel search, self-play, learner, supervisor -------

CHESS_DIR = os.path.join(REPO, "artifacts", "chess-r5")
CHESS_CONFIG = os.path.join(CHESS_DIR, "config.json")
CHESS_CHECKPOINT = os.path.join(CHESS_DIR, "iteration_2400")
CHESS_TRAINING_STATE = os.path.join(CHESS_DIR, "final_training_state")
CHESS_LABELS = os.path.join(REPO, "data", "chess_tactic_labels.npz")
RUN_CHESS_R5 = os.path.join(REPO, "run_chess_r5.sh")
CHESS_BATCH = 128      # run_chess_r5.sh's games per generation
CHESS_PLIES = 4        # phase 17's self-play plies (committed: 256)
CHESS_LEARNER_PLIES = 4  # phases 18 and 19: generation and arena plies
CHESS_GAME_PLIES = 40  # phase 15's random games
CHESS_LEARNER_STEPS = 16
# Phase 16: a game may differ between the card and the CPU only where one of
# its search's decisions had its two best scores this close (relative).
GAP_LIMIT = 1e-5
# Published perft counts (start position, Kiwipete and positions 3-5, one
# of them mirrored): every depth of each row, then the two deep counts.
KNOWN_PERFTS = [
    ("start", [20, 400, 8902]),
    ("r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
     [48, 2039]),
    ("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", [14, 191, 2812]),
    ("r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1",
     [6, 264, 9467]),
    ("rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8",
     [44, 1486]),
    ("r2q1rk1/pP1p2pp/Q4n2/bbp1p3/Np6/1B3NBn/pPPP1PPP/R3K2R b KQ - 0 1",
     [6, 264, 9467]),
]
DEEP_PERFTS = [("start", 4, 197_281), (KNOWN_PERFTS[1][0], 3, 97_862)]


def chess_config(overrides=None):
    """The committed chess-r5 configuration, with ``overrides``."""
    from custom_alphazero_tpu_torch.config import apply_overrides, from_json

    with open(CHESS_CONFIG) as fp:
        return apply_overrides(from_json(fp.read()), overrides or {})


def chess_net(cfg, dtype: str, device):
    """The committed chess-r5 net (iteration 2400) on ``device``."""
    import dataclasses

    from custom_alphazero_tpu_torch.io.checkpoint import load_jax_checkpoint
    from custom_alphazero_tpu_torch.models.convert import from_jax_variables

    params, batch_stats, meta = load_jax_checkpoint(CHESS_CHECKPOINT)
    model = dataclasses.replace(cfg.model, compute_dtype=dtype)
    return from_jax_variables(params, batch_stats, 1968, model, 118, (8, 8),
                              device=device), meta


def device_and_host_ms(fn, repeats: int = 1):
    """(wall ms per call with the device drained, device ms, host enqueue
    ms) of ``fn``; the device time is taken with the launches queued behind
    a GPU sleep, as ``time_forward`` does."""
    _, wall_ms = timed(fn, 5)
    device_ms, host_ms = time_forward(lambda _: fn(), None, repeats)
    return wall_ms, device_ms, host_ms


def same_states(a, b) -> list:
    """The names of the ChessState fields that differ between a and b."""
    import dataclasses

    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name).cpu(),
                               getattr(b, f.name).cpu())]


def chess_engine_phase(device):
    """Phase 15: perft on the card against the published counts, 128 random
    games played on the card and on the CPU with equal states after every
    ply, and the step times at B=128. Returns 128 positions on the card
    (each game after a random number of its plies) for phase 16."""
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.tools.perft import perft

    env = Chess()
    t0 = time.perf_counter()
    for fen, counts in KNOWN_PERFTS:
        root = (env.init(1, device) if fen == "start"
                else env.from_fen(fen, device))
        got = [perft(env, root, d) for d in range(1, len(counts) + 1)]
        check(got == counts, f"perft {fen}: {got}, published {counts}")
    log(f"chess perft on the card: {len(KNOWN_PERFTS)} positions, every "
        f"published depth equal, {time.perf_counter() - t0:.1f} s")
    for fen, depth, want in DEEP_PERFTS:
        root = (env.init(1, device) if fen == "start"
                else env.from_fen(fen, device))
        got, ms = timed(lambda: perft(env, root, depth))
        check(got == want, f"perft {fen} depth {depth}: {got} != {want}")
        log(f"  perft {fen[:24]} depth {depth} = {got} in {ms:.0f} ms "
            f"({got / ms * 1e3:.0f} leaves/s)")

    gen = torch.Generator().manual_seed(6)
    card, host = env.init(CHESS_BATCH, device), env.init(CHESS_BATCH, "cpu")
    target = torch.randint(0, CHESS_GAME_PLIES + 1, (CHESS_BATCH,),
                           generator=gen)
    positions = card
    t0 = time.perf_counter()
    for ply in range(CHESS_GAME_PLIES):
        legal = env.legal_mask(host)
        check(torch.equal(env.legal_mask(card).cpu(), legal),
              f"ply {ply}: legal masks differ")
        actions = (torch.rand(legal.shape, generator=gen) + legal).argmax(1)
        host, host_reward = env.step(host, actions)
        card, card_reward = env.step(card, actions.to(device))
        differ = same_states(card, host)
        check(not differ and torch.equal(card_reward.cpu(), host_reward),
              f"ply {ply}: card and CPU states differ in {differ}")
        check(torch.equal(env.observe(card).cpu(), env.observe(host)),
              f"ply {ply}: observations differ")
        positions = card.where((target == ply + 1).to(device), positions)
    log(f"chess engine: {CHESS_BATCH} random games x {CHESS_GAME_PLIES} "
        f"plies, every state field (hash ring included), reward and "
        f"observation equal card vs CPU after every ply "
        f"({int(host.terminal.sum())} games ended; "
        f"{time.perf_counter() - t0:.1f} s)")

    actions = env.legal_mask(card).to(torch.uint8).argmax(1)
    for name, fn in (("step", lambda: env.step(card, actions)),
                     ("step_lite", lambda: env.step_lite(card, actions)),
                     ("observe", lambda: env.observe(card))):
        wall_ms, device_ms, host_ms = device_and_host_ms(fn)
        log(f"  chess {name} at B={CHESS_BATCH}: {wall_ms:.3f} ms wall, "
            f"device {device_ms:.3f} ms, host enqueue {host_ms:.3f} ms")
    return positions


def chess_gumbel_phase(positions, device) -> None:
    """Phase 16: one Gumbel search (the chess-r5 settings) from 128 chess
    positions on the card and on the CPU, with the committed net in float32
    (TF32 off) and the same Gumbel draws: actions and root visits equal in
    every game but those with a decision closer than GAP_LIMIT."""
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.ops.rng import gumbel
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.search.gumbel import GumbelMCTS

    cfg = chess_config()
    env = Chess(cfg.chess)
    sims = cfg.mcts.simulations
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    draws = gumbel(torch.Generator().manual_seed(7),
                   (CHESS_BATCH, env.num_actions), "cpu")
    out = {}
    for where in (device, torch.device("cpu")):
        net, _ = chess_net(cfg, "float32", where)
        search = GumbelMCTS(env, cfg.mcts)
        search.track_gaps = True
        (tree, action, pi), ms = timed(lambda: search.search_select(
            positions.to(where), make_evaluate_fn(net), None, sims,
            gumbels=draws.to(where)))
        out[where.type] = (action.cpu(), search.root_child_visits(tree).cpu(),
                           pi.cpu(), search.decision_gap.cpu(), ms)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    (a_card, v_card, pi_card, gap_card, ms_card), (
        a_cpu, v_cpu, pi_cpu, gap_cpu, ms_cpu) = out["cuda"], out["cpu"]
    gap = torch.minimum(gap_card, gap_cpu)
    differ = (a_card != a_cpu) | (v_card != v_cpu).any(-1)
    for g in differ.nonzero()[:, 0].tolist():
        log(f"  game {g}: card action {int(a_card[g])}, CPU {int(a_cpu[g])}; "
            f"closest decision {float(gap[g]):.3e} relative")
        check(float(gap[g]) < GAP_LIMIT,
              f"Gumbel search differs card vs CPU in game {g} with its "
              f"decisions {float(gap[g]):.3e} apart")
    pi_err = (pi_card - pi_cpu).abs().max().item()
    log(f"Gumbel search card vs CPU ({CHESS_BATCH} chess positions, {sims} "
        f"sims, m={cfg.mcts.gumbel_max_considered}, K=100, float32 net): "
        f"{CHESS_BATCH - int(differ.sum())} of {CHESS_BATCH} games equal in "
        f"action and root visits, {int(differ.sum())} differ (each with a "
        f"decision under {GAP_LIMIT:g}); closest decision "
        f"{float(gap.min()):.3e}; improved policy max-abs {pi_err:.2e}; "
        f"card {ms_card / 1e3:.2f} s, CPU {ms_cpu / 1e3:.2f} s")
    check(int(v_card.sum()) == CHESS_BATCH * (sims - 1)
          - (sims - 1) * int(positions.terminal.sum()),
          "root visits do not add up to the simulations")


class _Stopwatch:
    """Seconds by part of the Gumbel search, each call timed with the
    device drained before and after it."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed_call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            return out

        return timed_call


def chess_selfplay_phase(device) -> None:
    """Phase 17: chess-r5 Gumbel self-play in bf16 (B=128, 100 simulations,
    continuous) for CHESS_PLIES plies: simulations/s, the samples' checks,
    one search split by part, one profiled ply."""
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
    from custom_alphazero_tpu_torch.search.gumbel import GumbelMCTS

    cfg = chess_config()
    env = Chess(cfg.chess)
    net, meta = chess_net(cfg, "bfloat16", device)
    evaluate = make_evaluate_fn(net)
    sims = cfg.mcts.simulations
    gen = torch.Generator(device=device).manual_seed(0)
    generate = make_selfplay_fn(env, cfg.mcts, cfg.self_play, CHESS_PLIES,
                                device=device)
    (batch, stats), ms = timed(lambda: generate(evaluate, gen, CHESS_BATCH))
    rows = CHESS_PLIES * CHESS_BATCH
    check(batch.obs.shape == (rows, 8, 8, 118)
          and batch.policy.shape == (rows, 1968), "chess samples' shapes")
    check(bool(torch.isfinite(batch.policy).all()), "pi not finite")
    pi_err = (batch.policy.sum(-1) - 1.0).abs().max().item()
    check(pi_err < 1e-4, f"pi rows do not sum to 1: {pi_err}")
    dense = (batch.policy > 0).sum(-1).float().mean().item()
    log(f"chess Gumbel self-play (step {meta['steps']} net, bf16): "
        f"{CHESS_PLIES} plies x {CHESS_BATCH} games x {sims} sims in "
        f"{ms / 1e3:.2f} s = {rows * sims / (ms / 1e3):.0f} sims/s, "
        f"{ms / (CHESS_PLIES * sims):.1f} ms per wave; {int(stats.games)} "
        f"games ended; pi row-sum err {pi_err:.1e}, {dense:.1f} nonzero "
        f"entries per target row")

    # One search from the start position, split by part.
    search = GumbelMCTS(env, cfg.mcts)
    watch = _Stopwatch()
    for name in ("_descend", "_backup"):
        setattr(search, name, watch.wrap(name[1:], getattr(search, name)))
    for name in ("step", "observe", "legal_mask"):
        setattr(env, name, watch.wrap("env", getattr(env, name)))
    roots = env.init(CHESS_BATCH, device)
    _, total_ms = timed(lambda: search.search_select(
        roots, watch.wrap("net", evaluate), gen, sims))
    for name in ("step", "observe", "legal_mask"):
        delattr(env, name)
    parts = dict(watch.seconds)
    parts["precompute and writes"] = total_ms / 1e3 - sum(parts.values())
    log(f"  one search, B={CHESS_BATCH}, {sims} waves: {total_ms:.0f} ms "
        f"({total_ms / sims:.1f} ms per wave; each part timed with the "
        f"device drained): " + ", ".join(
            f"{name} {1e3 * s / sims:.2f} ms/wave" for name, s in
            sorted(parts.items(), key=lambda kv: -kv[1])))
    profile_step(lambda: make_selfplay_fn(
        env, cfg.mcts, cfg.self_play, 1, device=device)(
            evaluate, gen, CHESS_BATCH),
        f"chess self-play ply ({sims} waves, B={CHESS_BATCH}, device "
        f"trace only)", top=8, host=False)


def chess_learner_phase(device) -> str:
    """Phase 18: ``run(cfg, generations=1)`` on the chess-r5 config from its
    committed training state, lowered only where time needs it; returns a
    copy of the run's results directory for phase 19."""
    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint
    from custom_alphazero_tpu_torch.runtime.loop import run

    results = tempfile.mkdtemp(prefix="chip_smoke_chess_")
    # Games of CHESS_LEARNER_PLIES plies never end, so continuous
    # generation would keep no sample; plain generation keeps every ply, as
    # truncated draws (128 x 4 = 512 rows: the ring's min_size and a batch).
    cfg = chess_config({
        "self_play.max_plies": str(CHESS_LEARNER_PLIES),
        "self_play.continuous": "false",
        "replay.min_size": "512",
        "loop.max_sample_reuse": "0",
        "arena.evaluation_frequency": str(CHESS_LEARNER_STEPS),
        "arena.checkpoint_frequency": str(CHESS_LEARNER_STEPS),
        "loop.solver_labels_path": CHESS_LABELS,
        "run.results_dir": results,
        "run.run_id": "smoke",
    })
    check(cfg.model.batch_size == 512 and cfg.mcts.use_gumbel
          and cfg.arena.evaluate_with_mcts, "chess-r5 config")
    tee = Tee(sys.stdout)
    try:
        training_dir = paths.training_path(results, "chess", "smoke")
        shutil.copytree(CHESS_TRAINING_STATE, training_dir)
        _, meta0 = load_checkpoint(training_dir)
        sys.stdout = tee
        summary, ms = timed(lambda: run(cfg, generations=1))
        sys.stdout = tee.stream
        tree, meta = load_checkpoint(training_dir)  # checks the hash
        step = meta0["steps"] + CHESS_LEARNER_STEPS
        evaluations = sorted(os.listdir(
            paths.evaluation_path(results, "chess", "smoke")))
        run_copy = tempfile.mkdtemp(prefix="chip_smoke_chess_run_")
        shutil.copytree(paths.run_path(results, "chess", "smoke"),
                        paths.run_path(run_copy, "chess", "smoke"))
    finally:
        sys.stdout = tee.stream
        shutil.rmtree(results, ignore_errors=True)
    out = tee.text()
    check(summary["iterations"] == step == meta["steps"] == int(tree["steps"]),
          f"chess learner: {summary['iterations']} iterations, checkpoint at "
          f"{meta['steps']}, started from {meta0['steps']}")
    arena = re.search(rf"\[iter {step}\] arena score=[0-9.]+ "
                      r"\(\+(\d+)/-(\d+)/=(\d+)\)", out)
    check(arena is not None and sum(map(int, arena.groups())) == cfg.arena.games,
          f"chess learner: no {cfg.arena.games}-game arena at step {step}")
    check(evaluations == [f"iteration_{step}"],
          f"chess learner: evaluation checkpoints {evaluations}")
    timing = summary["timings"][0]
    check(timing["train_iterations"] == CHESS_LEARNER_STEPS,
          f"chess learner trained {timing['train_iterations']} steps")
    log(f"chess learner: run(generations=1) in {ms / 1e3:.1f} s, steps "
        f"{meta0['steps']} -> {meta['steps']}, checkpoint restored with a "
        f"matching hash; arena {arena.group(0)}; {timing['samples']} "
        f"samples, {timing['sims_per_second']:.0f} sims/s; seconds: generate "
        f"{timing['generate_s']:.2f}, replay {timing['replay_s']:.3f}, train "
        f"{timing['train_s']:.3f} ({CHESS_LEARNER_STEPS} steps), arena "
        f"{timing['arena_s']:.2f}, checkpoint {timing['checkpoint_s']:.3f}")
    return run_copy


def chess_supervisor_phase(run_copy: str) -> None:
    """Phase 19: the supervisor with run_chess_r5.sh's flags word for word,
    resuming phase 18's run for one generation of CHESS_LEARNER_PLIES
    plies."""
    flags = script_flags(RUN_CHESS_R5)
    check(flags[0] == "--supervise.liveness_timeout_minutes=10"
          and "--game=chess" in flags and "--mcts.use_gumbel=true" in flags,
          f"run_chess_r5.sh flags: {flags}")
    extra = [f"--run.results_dir={run_copy}", "--run.run_id=smoke",
             "--loop.generations=1",
             f"--self_play.max_plies={CHESS_LEARNER_PLIES}"]
    try:
        out, wall = run_supervisor(flags + extra)
    finally:
        shutil.rmtree(run_copy, ignore_errors=True)
    step = 2800 + CHESS_LEARNER_STEPS
    check(f"Resumed training state at step {step}" in out
          and f"Restored best model from iteration {step}" in out
          and "[gen 0]" in out,
          f"chess supervisor: the loop did not resume at step {step} and play")
    log(f"chess supervisor: `python -m custom_alphazero_tpu_torch.runtime."
        f"supervisor` with run_chess_r5.sh's {len(flags)} flags + "
        f"{len(extra)} overrides exited 0 in {wall:.1f} s, resumed at step "
        f"{step} and played a generation")


# ---- the evaluation tools: the Connect-4 battery and the chess panel -------

C4R5_METRICS = os.path.join(REPO, "artifacts", "c4-r5", "metrics.jsonl")
C4R5_EVAL_LOG = os.path.join(REPO, "artifacts", "c4-r5",
                             "final_eval_c4r5_250.log")
WARMED_CACHE = os.path.join(REPO, "artifacts", "solver_cache_warmed.npz")
MATE1 = os.path.join(REPO, "data", "chess_tactics_300.npz")
MATE2 = os.path.join(REPO, "data", "chess_mate2_300.npz")
EQUAL_ROOTS = 16       # phase 20: roots of the fused-vs-general check
DISTILL_POSITIONS = 64
DISTILL_STEPS = 100
TACTICS_ROWS = 64      # phase 21: searched rows of each tactics set
MATE2_LABEL_ROWS = 16
MATCH_GAMES = 4
MATCH_PLIES = 16       # phase 21's matches (the tool plays up to 200 plies)
# What JAX's panel on the same net printed (TPU results, not times):
# artifacts/chess-r5/chess_r5_best_panel.log.
JAX_PANEL = {"mate-in-1": 0.13494809688581316, "mate-in-2": 0.09}


def key_tree(x):
    """The nested key structure of a JSON value (lists and scalars: None)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    return None


def line_heads(lines) -> list:
    """What each printed line starts with: the text before its first ':',
    numbers as N (a JSON line: '{')."""
    return ["{" if line.startswith("{")
            else re.sub(r"\d+", "N", line.split(":")[0]) for line in lines]


def cat_connect_n(states):
    """One batch of the B=1 ConnectNStates ``states``."""
    import dataclasses

    return type(states[0])(**{
        f.name: torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0])})


def board_of_key(current: int, mask: int):
    """The canonical (6, 7) board of a solver bitboard (bit = col * 7 + row
    from the bottom; ``current`` = the side to move's stones)."""
    import numpy as np

    board = np.zeros((6, 7), np.int8)
    for c in range(7):
        for r in range(6):
            bit = 1 << (c * 7 + r)
            if mask & bit:
                board[5 - r, c] = 1 if current & bit else -1
    return board


def captured_stdout(fn):
    """(fn(), the lines it printed), printed through to the log as well."""
    tee = Tee(sys.stdout)
    sys.stdout = tee
    try:
        out = fn()
    finally:
        sys.stdout = tee.stream
    return out, tee.text().splitlines()


def c4_battery_phase(device) -> dict:
    """Phase 20: run_c4_r4_evals.sh's tools on the committed c4-r5 net,
    through their mains, on the card; returns K1's launches there."""
    import dataclasses

    import numpy as np

    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch import solver as sv
    from custom_alphazero_tpu_torch.config import (
        MCTSConfig,
        from_json,
        to_json,
    )
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.search.mcts import MCTS
    from custom_alphazero_tpu_torch.tools import (
        book_from_cache,
        distill,
        final_eval,
        lineage,
        run_report,
        strength,
    )

    Search = fused_mcts_v2.FusedConnectNSearchV2
    results = tempfile.mkdtemp(prefix="chip_smoke_evals_")
    os.environ["CAZ_SOLVER_CACHE"] = os.path.join(results, "solver_cache.npz")
    seconds = {}
    try:
        with open(C4R5_CONFIG) as fp:
            cfg = from_json(fp.read())
        os.makedirs(paths.tensorboard_path(results, "connect_n", "c4r5"))
        with open(os.path.join(paths.run_path(
                results, "connect_n", "c4r5"), "config.json"), "w") as fp:
            fp.write(to_json(cfg))
        shutil.copytree(CHECKPOINT, paths.evaluation_iteration_path(
            results, "connect_n", "c4r5", 11600))
        shutil.copy(C4R5_METRICS, paths.tensorboard_path(
            results, "connect_n", "c4r5"))
        common = ["--run_id=c4r5", f"--results_dir={results}",
                  f"--device={device}"]

        # final_eval (run_c4_r4_evals.sh's first command at 2 games), the
        # root states of its first searches kept for the check below.
        roots = []
        search_root_stats = Search.search_root_stats

        def recording(self, root_states, *args, **kwargs):
            if len(roots) < EQUAL_ROOTS:
                roots.append(dataclasses.replace(root_states, **{
                    f.name: getattr(root_states, f.name).clone()
                    for f in dataclasses.fields(root_states)}))
            return search_root_stats(self, root_states, *args, **kwargs)

        captures = Search.captures
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        Search.search_root_stats = recording
        try:
            (report, lines), ms = timed(lambda: captured_stdout(
                lambda: final_eval.main(common + [
                    f"--labels={EVAL_LABELS}", "--games=2",
                    f"--sims={SIMS}", "--seed=7"])))
        finally:
            Search.search_root_stats = search_root_stats
        seconds["final_eval"] = ms / 1e3
        launches = fused_mcts_v2.wave_step.launches
        final_captures = Search.captures - captures
        searched = sum(report[f"mcts_vs_{o}"]["positions"]
                       for o in ("random", "perfect"))
        check(fused_mcts_v2.wave_step_reference.calls == 0,
              "final_eval: the plain version ran")
        check(final_captures == 2, f"final_eval: {final_captures} captures")
        expected = (searched * (SIMS + 1)
                    + final_captures * fused_mcts_v2.WARMUP_WAVES)
        check(searched > 0 and launches == expected,
              f"final_eval: K1 launched {launches} times, expected "
              f"{expected} for {searched} searched moves")
        with open(C4R5_EVAL_LOG) as fp:
            jax_lines = [line.rstrip("\n") for line in fp
                         if not line.startswith("WARNING")]
        check(line_heads(lines) == line_heads(jax_lines),
              f"final_eval printed {line_heads(lines)}, JAX "
              f"{line_heads(jax_lines)}")
        check(key_tree(json.loads(lines[-1])) == key_tree(json.loads(
            jax_lines[-1])), "final_eval: the report's keys differ from JAX's")
        raw = report["raw_policy_labeled"]
        jax_raw = json.loads(jax_lines[-1])["raw_policy_labeled"]
        log(f"final_eval (bf16 net, {SIMS} sims, 2 games per opponent, "
            f"seed 7) in {ms / 1e3:.1f} s: raw-policy labelled move "
            f"accuracy {raw['move_accuracy']} (JAX log: "
            f"{jax_raw['move_accuracy']}); vs random "
            f"{json.dumps({k: v for k, v in report['mcts_vs_random'].items() if k != 'openings'})}"
            f"; vs perfect "
            f"{json.dumps({k: v for k, v in report['mcts_vs_perfect'].items() if k != 'openings'})}"
            f"; {searched} searched moves, K1 launched {launches} times, "
            f"plain version 0, {final_captures} graph captures")

        # The fused route's root visits against the general search's, from
        # the first EQUAL_ROOTS roots of those games, in one batch.
        env, evaluate, _, _ = strength.load_run_model("c4r5", results,
                                                      device=device)
        states = cat_connect_n(roots)
        mcts_cfg = MCTSConfig(simulations=SIMS)
        torch.backends.cudnn.deterministic = True
        fused = Search(env, mcts_cfg, device)
        mcts = MCTS(env, mcts_cfg)
        fused_visits = fused.search_root_stats(states, evaluate, None,
                                               SIMS)[0]
        tree, general_ms = timed(lambda: mcts.search(states, evaluate, None,
                                                     SIMS))
        general_visits = mcts.root_child_visits(tree)
        torch.backends.cudnn.deterministic = False
        check(torch.equal(fused_visits, general_visits),
              f"fused and general root visits differ on "
              f"{int((fused_visits != general_visits).any(-1).sum())} of "
              f"{len(roots)} roots")
        # One search at B=1 on each route, the fused one replayed.
        one = cat_connect_n(roots[:1])
        fused.search_root_stats(one, evaluate, None, SIMS)  # captures
        _, fused_ms = timed(lambda: fused.search_root_stats(
            one, evaluate, None, SIMS))
        _, general_one_ms = timed(lambda: mcts.search(one, evaluate, None,
                                                      SIMS))
        log(f"  fused vs general root visits on {len(roots)} roots of those "
            f"games (bf16 net, cuDNN deterministic): bit-equal; at B=1 "
            f"the fused search takes {fused_ms / (SIMS + 1):.4f} ms per wave "
            f"({fused_ms:.1f} ms per search), the general "
            f"{general_one_ms / SIMS:.2f} ms per wave; the general at "
            f"B={len(roots)} {general_ms / SIMS:.2f} ms per wave")

        # lineage (the battery's third command), with a one-game probe.
        captures = Search.captures
        (entries, lines), ms = timed(lambda: captured_stdout(
            lambda: lineage.main(common + [f"--labels={EVAL_LABELS}",
                                           "--probe_games=1"])))
        seconds["lineage"] = ms / 1e3
        lineage_captures = Search.captures - captures
        rows = [e["iteration"] for e in entries["entries"]]
        check(rows == ["random-init", 11600]
              and all("mcts_move_accuracy" in e for e in entries["entries"])
              and lineage_captures == 2,
              f"lineage rows {rows}, {lineage_captures} captures")
        check(lines[0].startswith("| promotion iter | steps | labeled move "
                                  "acc |") and lines[-1].startswith("{"),
              f"lineage printed {lines[:1]}")
        log(f"lineage (labels, one probe game per row) in {ms / 1e3:.1f} s, "
            f"{lineage_captures} graph captures: {lines[2]} / {lines[3]}")

        # run_report (the fourth command) on the committed metrics.
        (summary, lines), ms = timed(lambda: captured_stdout(
            lambda: run_report.main(common[:2])))
        seconds["run_report"] = ms / 1e3
        keys = ["steps", "loss_first", "loss_last", "loss_min",
                "sims_per_s_median", "generations", "games_total",
                "samples_total", "arenas", "promotions", "arena_history",
                "solver_score_history", "elo_history", "elo_gain"]
        check([k for k in keys if k in summary] == list(summary)
              and summary["arenas"] > 0
              and line_heads(lines) == list(summary),
              f"run_report keys {list(summary)}")
        log(f"run_report in {ms / 1e3:.2f} s: steps {summary['steps']}, "
            f"{summary['arenas']} arenas, {summary['promotions']} "
            f"promotions, Elo gain {summary.get('elo_gain')}")

        # book_from_cache on the committed warmed cache, and three probes
        # with and without the book.
        book = os.path.join(results, "7x6_cache.book")
        n, ms = timed(lambda: book_from_cache.main(
            [f"--cache={WARMED_CACHE}", f"--out={book}"]))
        seconds["book_from_cache"] = ms / 1e3
        booked = sv.ConnectFourSolver(book=book, cache=None)
        bare = sv.ConnectFourSolver(book=None, cache=None)
        with np.load(WARMED_CACHE) as data:
            keys, scores = data["keys"], data["scores"]
        plies = np.array([bin(int(m)).count("1") for m in keys[:, 1]])
        for depth in (12, 14, 16):
            i = int(np.nonzero(plies == depth)[0][0])
            board = board_of_key(*map(int, keys[i]))
            check(booked.solve_board(board) == bare.solve_board(board)
                  == int(scores[i]), f"book probe at ply {depth}")
        check(booked.book_depth == 16 and n > 50_000, f"book of {n} entries")
        log(f"book_from_cache: {n} entries in {ms / 1e3:.2f} s; the solver "
            f"loads it (depth {booked.book_depth}) and three probes (plies "
            f"12, 14, 16) answer as without a book")

        # distill: DISTILL_POSITIONS oracle-labelled positions, then
        # DISTILL_STEPS train steps of the tool's default net.
        n_all = DISTILL_POSITIONS + DISTILL_POSITIONS // 5
        data, label_ms = timed(lambda: distill.labeled_dataset(
            n_all, seed=0, min_ply=16))
        train = {k: v[:DISTILL_POSITIONS] for k, v in data.items()}
        test = {k: v[DISTILL_POSITIONS:] for k, v in data.items()}
        result, ms = timed(lambda: distill.run_distillation(
            train, test, steps=DISTILL_STEPS, log_every=DISTILL_STEPS,
            device=device))
        seconds["distill"] = (label_ms + ms) / 1e3
        loss = result["history"][-1]["loss"]
        check(math.isfinite(loss) and result["state"].steps == DISTILL_STEPS,
              f"distill: loss {loss}")
        log(f"distill: {n_all} positions labelled in {label_ms / 1e3:.1f} s, "
            f"{DISTILL_STEPS} steps in {ms / 1e3:.2f} s "
            f"({ms / DISTILL_STEPS:.2f} ms per step, evaluation included); "
            f"train {result['train']}, test {result['test']}")
    finally:
        shutil.rmtree(results, ignore_errors=True)
    log("c4 battery seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return launches


def chess_panel_phase(device) -> None:
    """Phase 21: run_chess_r5_evals.sh's tools on the committed chess-r5
    net (iteration 2400), cut to size, on the card."""
    import numpy as np

    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.config import apply_overrides, to_json
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.search.mcts import MCTS
    from custom_alphazero_tpu_torch.tools import (
        chess_strength,
        chess_tactics,
        strength,
    )

    results = tempfile.mkdtemp(prefix="chip_smoke_panel_")
    seconds = {}
    try:
        cfg = chess_config()
        for run_id, dtype in (("chessr5", cfg.model.compute_dtype),
                              ("chessr5_fp32", "float32")):
            run_dir = paths.run_path(results, "chess", run_id)
            os.makedirs(run_dir)
            with open(os.path.join(run_dir, "config.json"), "w") as fp:
                fp.write(to_json(apply_overrides(
                    cfg, {"model.compute_dtype": dtype})))
            shutil.copytree(CHESS_CHECKPOINT, paths.evaluation_iteration_path(
                results, "chess", run_id, 2400))
        subsets = {}
        for name, src in (("mate-in-1", MATE1), ("mate-in-2", MATE2)):
            with np.load(src) as data:
                subsets[name] = os.path.join(results, f"{name}.npz")
                np.savez(subsets[name], **{k: data[k][:TACTICS_ROWS]
                                           for k in data})
        common = ["--run_id=chessr5", f"--results_dir={results}",
                  f"--device={device}"]

        # Raw policy on both whole sets (bf16), then float32 card vs CPU.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        fp32 = {d: strength.load_run_model("chessr5_fp32", results,
                                           game="chess", device=d)[1]
                for d in (device, "cpu")}
        for name, src in (("mate-in-1", MATE1), ("mate-in-2", MATE2)):
            report, ms = timed(lambda: chess_tactics.main(
                common + [f"--labels={src}"]))
            seconds[f"{name} raw"] = ms / 1e3
            acc = {d: chess_tactics.evaluate_tactics(
                fp32[d], src, device=d)["accuracy"] for d in (device, "cpu")}
            hits_apart = abs(acc[device] - acc["cpu"]) * report["positions"]
            check(hits_apart <= 1.0 + 1e-9, f"{name}: float32 raw accuracy "
                  f"{acc[device]} on the card, {acc['cpu']} on the CPU")
            log(f"{name} raw policy ({report['positions']} positions) in "
                f"{ms / 1e3:.2f} s: bf16 {report['accuracy']:.4f} (JAX log: "
                f"{JAX_PANEL[name]:.4f}), float32 card {acc[device]:.4f}, "
                f"CPU {acc['cpu']:.4f}; random baseline "
                f"{report['random_baseline']:.4f}")
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

        # Searched at 100 simulations on the first TACTICS_ROWS rows.
        for name in ("mate-in-1", "mate-in-2"):
            report, ms = timed(lambda: chess_tactics.main(
                common + [f"--labels={subsets[name]}", "--mcts=true",
                          f"--sims={cfg.mcts.simulations}"]))
            seconds[f"{name} searched"] = ms / 1e3
            check(report["positions"] == TACTICS_ROWS
                  and 0.0 <= report["accuracy"] <= 1.0,
                  f"{name} searched: {report}")
            log(f"{name} searched ({cfg.mcts.simulations} sims, "
                f"{TACTICS_ROWS} rows at B={TACTICS_ROWS}) in "
                f"{ms / 1e3:.1f} s: accuracy {report['accuracy']:.4f}, "
                f"{ms / cfg.mcts.simulations:.1f} ms per wave")

        # The uniform control on the card, its decisions held to the CPU's.
        visits = []
        root_child_visits = MCTS.root_child_visits

        def recording(self, tree):
            out = root_child_visits(self, tree)
            visits.append(out.cpu())
            return out

        MCTS.root_child_visits = recording
        try:
            report, ms = timed(lambda: chess_tactics.main([
                f"--labels={subsets['mate-in-2']}", "--uniform=true",
                "--mcts=true", "--sims=100", f"--device={device}"]))
            cpu_report = chess_tactics.evaluate_tactics(
                chess_tactics.uniform_evaluate(1968), subsets["mate-in-2"],
                use_mcts=True, sims=100, device="cpu")
        finally:
            MCTS.root_child_visits = root_child_visits
        seconds["uniform control"] = ms / 1e3
        card_visits, cpu_visits = visits
        same_move = card_visits.argmax(-1) == cpu_visits.argmax(-1)
        check(bool(same_move.all())
              and report["accuracy"] == cpu_report["accuracy"],
              f"uniform control: {int((~same_move).sum())} decisions differ "
              f"between the card and the CPU")
        log(f"mate-in-2 uniform control (100 sims, {TACTICS_ROWS} rows) in "
            f"{ms / 1e3:.1f} s: accuracy {report['accuracy']:.4f}; every "
            f"decision equal to the CPU's "
            f"({int((card_visits == cpu_visits).all(-1).sum())} of "
            f"{TACTICS_ROWS} root visit rows equal)")

        # The labels of the committed rows, recomputed on the card.
        env = Chess(cfg.chess)
        for fn, src, key, n in (
                (chess_tactics.mate_in_1_labels, MATE1, "mate_mask",
                 TACTICS_ROWS),
                (chess_tactics.mate_in_2_labels, MATE2, "mate2_mask",
                 MATE2_LABEL_ROWS)):
            with np.load(src) as data:
                data = {k: data[k][:n] for k in data}
            (labels, legal), ms = timed(lambda: fn(
                env, chess_tactics.states_from_npz(env, data, device)))
            check(np.array_equal(labels.cpu().numpy(), data[key])
                  and np.array_equal(legal.cpu().numpy(), data["legal_mask"]),
                  f"{fn.__name__} differs from the committed {key}")
            log(f"{fn.__name__} on {n} committed rows: equal to {key} and "
                f"legal_mask ({ms:.0f} ms)")

        # Matches against the baseline opponents, MATCH_PLIES plies from the
        # first MATCH_GAMES // 2 mate-in-1 rows (so games end), the moves
        # played replayed on the CPU engine.
        _, evaluate, _, _ = strength.load_run_model(
            "chessr5", results, game="chess", device=device)
        with np.load(MATE1) as data:
            rows = {k: data[k][:MATCH_GAMES // 2] for k in data}
        decisive = 0
        # One opponent, for time (the greedy one: its scorer runs on the
        # card); CPU tests play both.
        for opponent in ("greedy",):
            (r, moves), ms = timed(lambda: played_moves(
                lambda env: chess_strength.play_vs_opponent(
                    env, evaluate, opponent=opponent, games=MATCH_GAMES,
                    sims=cfg.mcts.simulations, max_plies=MATCH_PLIES,
                    device=device), cfg.chess, rows))
            seconds[f"vs {opponent}"] = ms / 1e3
            replayed = replay_on_cpu(cfg.chess, rows, moves)
            check(r["games"] == MATCH_GAMES
                  and {k: r[k] for k in replayed} == replayed,
                  f"vs {opponent}: {r}, replayed on the CPU {replayed}")
            decisive += r["wins"] + r["losses"]
            log(f"vs {opponent} ({MATCH_GAMES} games from mate-in-1 rows, "
                f"{MATCH_PLIES} plies, {cfg.mcts.simulations} sims) in "
                f"{ms / 1e3:.1f} s: {r}; W/D/L and length equal to the CPU "
                f"replay of its moves")
        check(decisive > 0, "no match game ended")
    finally:
        shutil.rmtree(results, ignore_errors=True)
    log("chess panel seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))


def played_moves(play, chess_cfg, rows):
    """(play(env), the moves it played): ``env`` a chess env whose games
    start from the tactics rows ``rows``; the moves are one list of (games,)
    arrays per ``init`` call, the searches' own steps left out."""
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.search.mcts import MCTS
    from custom_alphazero_tpu_torch.tools.chess_tactics import states_from_npz

    env = Chess(chess_cfg)
    step, search = env.step, MCTS.search
    halves, searching = [], [False]

    def init(batch, device=None):
        check(batch == len(rows["board"]), f"init({batch})")
        halves.append([])
        return states_from_npz(env, rows, device)

    def recording_step(state, action):
        if not searching[0]:
            halves[-1].append(action.cpu().numpy())
        return step(state, action)

    def flagged_search(self, *args, **kwargs):
        searching[0] = True
        try:
            return search(self, *args, **kwargs)
        finally:
            searching[0] = False

    env.init, env.step = init, recording_step
    MCTS.search = flagged_search
    try:
        return play(env), halves
    finally:
        MCTS.search = search


def replay_on_cpu(chess_cfg, rows, halves) -> dict:
    """W/D/L and mean length of ``play_vs_opponent``'s games, replayed one
    game at a time on the CPU engine from ``played_moves``' moves (the
    tested side moves first in the first half)."""
    import numpy as np

    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.tools.chess_tactics import states_from_npz

    env = Chess(chess_cfg)
    results, lengths = [], []
    for tested_first, moves in zip((True, False), halves):
        for g in range(len(rows["board"])):
            state = states_from_npz(
                env, {k: v[g:g + 1] for k, v in rows.items()}, "cpu")
            ply = 0
            while ply < len(moves) and not bool(state.terminal[0]):
                state, _ = env.step(state,
                                    torch.from_numpy(moves[ply][g:g + 1]))
                ply += 1
            tested_last = ((ply - 1) % 2 == 0) == tested_first
            won = bool(state.terminal[0] & state.won[0])
            results.append((1 if tested_last else -1) if won else 0)
            lengths.append(ply)
    return {"wins": results.count(1), "draws": results.count(0),
            "losses": results.count(-1),
            "mean_game_plies": float(np.mean(lengths))}


# ---- slice 8: subtree reuse, the serving tier, the profiling tools ---------

REUSE_POSITIONS = 64   # phase 22, card vs CPU
TRACE_SIMS = 8         # phase 24's traced generation
REUSE_PLIES = 3
REUSE_SELFPLAY_PLIES = 4
SERVE_REQUESTS = 256   # phase 23: single-state requests
SERVE_THREADS = 32
SERVE_BATCH = 1024     # one batch request
SERVE_INFER_BATCH = 16
SERVE_TIMEOUT_S = 120
# Phase 23: a move of the bf16 service must equal the card's float32
# forward's where that forward's two best probabilities are at least this
# far apart, and at least BF16_MARGIN times the row's own bf16 rounding
# (its largest bf16-vs-float32 probability difference at B=1024) apart:
# the served batches have other shapes, hence other roundings, than any
# reference (1e-3 alone failed on 1 of 256 rows against the bf16 forward,
# H100 80GB HBM3). The float32 service is held to the CPU's within 1e-4.
ARGMAX_GAP = 1e-3
BF16_MARGIN = 4.0


def state_to(state, device):
    """A copy of an env state (a dataclass of tensors) on ``device``."""
    import dataclasses

    return type(state)(**{f.name: getattr(state, f.name).to(device)
                          for f in dataclasses.fields(state)})


def trees_differ(card, cpu, free_card, free_cpu) -> list:
    """Names of the Tree fields (root state included) and of ``free`` whose
    bits differ between a tree on the card and one on the CPU."""
    import dataclasses

    bad = [f"root_state.{name}"
           for name in same_states(card.root_state, cpu.root_state)]
    for f in dataclasses.fields(card):
        x, y = getattr(card, f.name), getattr(cpu, f.name)
        if f.name != "root_state" and x is not None and not same_bits(
                x.cpu(), y):
            bad.append(f.name)
    if not same_bits(free_card.cpu(), free_cpu):
        bad.append("free")
    return bad


def reuse_card_vs_cpu(env, states, sims: int, plies: int, gen):
    """Greedy plies of ``search_tree`` and ``advance_root`` on the card and
    on the CPU from the same positions, the dyadic evaluator and the same
    Gamma draws (c4-r5 noise), at self-play's capacity (2 x sims, kept
    subtrees cut to sims nodes). Every Tree field and ``free`` must be
    bit-equal after every search and every advance. Returns (searches
    compared, card ms per wave)."""
    from custom_alphazero_tpu_torch.config import MCTSConfig
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    device = states.board.device
    mcts = MCTS(env, MCTSConfig(simulations=sims, **NOISE))
    capacity, keep_cap = 2 * sims, sims
    evaluate = dyadic_evaluate(env.num_actions)
    bsz = states.board.shape[0]
    cpu_states = state_to(states, "cpu")
    trees = {"card": mcts.init_tree(states, capacity),
             "cpu": mcts.init_tree(cpu_states, capacity)}
    free = {"card": torch.ones(bsz, dtype=torch.int32, device=device),
            "cpu": torch.ones(bsz, dtype=torch.int32)}
    searched, wave_ms = 0, []
    for ply in range(plies):
        gamma = mcts.noise_plan(gen, sims, bsz, device)
        for where, g in (("card", gamma), ("cpu", gamma.cpu())):
            t0 = time.perf_counter()
            trees[where], free[where] = mcts.search_tree(
                trees[where], free[where], evaluate, None, sims, gamma=g)
            if where == "card":
                torch.cuda.synchronize()
                wave_ms.append((time.perf_counter() - t0) * 1e3 / sims)
        bad = trees_differ(trees["card"], trees["cpu"], free["card"],
                           free["cpu"])
        check(not bad, f"reuse, ply {ply}: search_tree card vs CPU differ "
              f"in {bad}")
        searched += 1
        actions = mcts.root_child_visits(trees["card"]).argmax(1)
        states, _ = env.step(states, actions)
        cpu_states, _ = env.step(cpu_states, actions.cpu())
        trees["card"], free["card"] = mcts.advance_root(
            trees["card"], actions, keep_cap, states)
        trees["cpu"], free["cpu"] = mcts.advance_root(
            trees["cpu"], actions.cpu(), keep_cap, cpu_states)
        bad = trees_differ(trees["card"], trees["cpu"], free["card"],
                           free["cpu"])
        check(not bad, f"reuse, ply {ply}: advance_root card vs CPU differ "
              f"in {bad}")
        check(int(free["card"].max()) <= keep_cap, "kept more than keep_cap")
    return searched, sum(wave_ms) / len(wave_ms)


def reuse_phase(env, mcts_cfg, sp_cfg, evaluate, general_sims_s, gen,
                device) -> None:
    """Phase 22: reuse card vs CPU, then c4-r5 reuse self-play on the card
    with the trained bf16 net."""
    import dataclasses

    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    states = random_positions(env, REUSE_POSITIONS, 20, gen, device)
    t0 = time.perf_counter()
    searched, card_wave_ms = reuse_card_vs_cpu(env, states, SIMS,
                                               REUSE_PLIES, gen)
    log(f"reuse, card vs CPU: {REUSE_POSITIONS} positions, {SIMS} sims, "
        f"{searched} greedy plies: every Tree field and free bit-equal "
        f"after each search and advance; card {card_wave_ms:.2f} ms per "
        f"wave at B={REUSE_POSITIONS} ({time.perf_counter() - t0:.1f} s)")

    # Self-play: the carried visits and the kept sizes, read through the
    # two reuse methods, wrapped for this run only.
    reuse_cfg = dataclasses.replace(mcts_cfg, reuse_tree=True)
    keep_cap = max(reuse_cfg.max_nodes, 2 * SIMS) - SIMS
    carried, kept = [], []
    search_tree, advance_root = MCTS.search_tree, MCTS.advance_root

    def counted_search(self, tree, free, *args, **kwargs):
        carried.append(self.root_child_visits(tree).sum(-1).float()
                       .mean().item())
        return search_tree(self, tree, free, *args, **kwargs)

    def counted_advance(self, *args, **kwargs):
        tree, free = advance_root(self, *args, **kwargs)
        kept.append(int(free.max()))
        return tree, free

    MCTS.search_tree, MCTS.advance_root = counted_search, counted_advance
    try:
        generate = make_selfplay_fn(env, reuse_cfg, sp_cfg,
                                    REUSE_SELFPLAY_PLIES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, stats = generate(evaluate, gen, BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        MCTS.search_tree, MCTS.advance_root = search_tree, advance_root
    waves = REUSE_SELFPLAY_PLIES * SIMS
    check(len(kept) == REUSE_SELFPLAY_PLIES and max(kept) <= keep_cap,
          f"reuse self-play kept {kept}, keep_cap {keep_cap}")
    check(carried[0] == 0.0 and all(c > 0 for c in carried[1:]),
          f"reuse self-play carried no visits into a search: {carried}")
    check(int(stats.plies) == waves * BATCH // SIMS,
          "reuse self-play did not play every ply")
    pi_err = (samples.policy.sum(-1) - 1.0).abs().max().item()
    check(pi_err < 1e-5, f"reuse pi rows do not sum to 1: {pi_err}")
    log(f"reuse self-play (c4-r5 bf16, B={BATCH}, {SIMS} sims, "
        f"{REUSE_SELFPLAY_PLIES} plies): {wall:.2f} s = "
        f"{waves * BATCH / wall:.0f} sims/s, {1e3 * wall / waves:.2f} ms "
        f"per wave (phase 8's fresh-tree general search: "
        f"{general_sims_s:.0f} sims/s, {1e3 * BATCH / general_sims_s:.2f} "
        f"ms per wave); mean root-edge visits carried into each search "
        f"{[round(c, 1) for c in carried]}; kept nodes (max) {kept}, "
        f"keep_cap {keep_cap}")


def read_line(stream, deadline: float, want: str) -> list:
    """Lines of ``stream`` up to and including the first that starts with
    ``want``; raises past ``deadline`` (a time.monotonic value)."""
    import queue
    import threading

    lines, box = [], queue.Queue()

    def reader():
        for line in stream:
            box.put(line)
            if line.startswith(want):
                break
        box.put(None)

    threading.Thread(target=reader, daemon=True).start()
    while True:
        line = box.get(timeout=max(deadline - time.monotonic(), 0.01))
        check(line is not None, f"stream ended before {want!r}: {lines}")
        lines.append(line.rstrip("\n"))
        if line.startswith(want):
            return lines


def top_two_gap(probs: torch.Tensor) -> torch.Tensor:
    top = probs.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def argmax_disagreements(got, want, margin=None) -> tuple:
    """(moves that differ where the reference's top two are at least
    ARGMAX_GAP and ``margin`` (per row) apart, the rows closer than
    that)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    need = torch.full((want.shape[0],), ARGMAX_GAP)
    if margin is not None:
        need = torch.maximum(need, margin)
    wide = top_two_gap(want) >= need
    differ = got.argmax(-1) != want.argmax(-1)
    return (int((differ & wide).sum()),
            torch.nonzero(~wide)[:, 0].tolist())


def serving_phase(env, gen, device, newer: str) -> None:
    """Phase 23: ``python -m custom_alphazero_tpu_torch.serving`` on a run
    laid out from the committed c4-r5 net, driven through ServingClient,
    with ``newer`` (phase 13's step-11,660 checkpoint) appearing as a newer
    lineage; then ``build_service`` in float32 in this process."""
    import threading

    import numpy as np

    from custom_alphazero_tpu_torch.config import (
        Config,
        ModelConfig,
        apply_overrides,
    )
    from custom_alphazero_tpu_torch.io.checkpoint import load_jax_checkpoint
    from custom_alphazero_tpu_torch.models.convert import from_jax_variables
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.serving import ServingClient
    from custom_alphazero_tpu_torch.serving.__main__ import build_service

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def forward(path, where, dtype="float32"):
        params, stats, _ = load_jax_checkpoint(path)
        return make_evaluate_fn(from_jax_variables(
            params, stats, 7, ModelConfig(compute_dtype=dtype),
            device=where))

    obs = env.observe(random_positions(env, SERVE_BATCH, 30, gen, device))
    obs_np = obs.cpu().numpy()
    fp32_11600 = forward(CHECKPOINT, device)(obs)[0].cpu()
    bf16_11600 = forward(CHECKPOINT, device, "bfloat16")(obs)[0].cpu()
    fp32_newer = forward(newer, device)(obs)[0].cpu()
    bf16_newer = forward(newer, device, "bfloat16")(obs)[0].cpu()
    margin = BF16_MARGIN * (bf16_11600 - fp32_11600).abs().max(-1).values
    margin_newer = BF16_MARGIN * (bf16_newer - fp32_newer).abs().max(
        -1).values

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    evaluation = os.path.join(root, "connect_n", "smoke-serve", "evaluation")
    shutil.copytree(CHECKPOINT, os.path.join(evaluation, "iteration_11600"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "custom_alphazero_tpu_torch.serving",
         f"--run.results_dir={root}", "--run.run_id=smoke-serve",
         "--serving.host=127.0.0.1", "--serving.port=0",
         f"--serving.inference_batch_size={SERVE_INFER_BATCH}"],
        cwd=REPO, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    try:
        t0 = time.perf_counter()
        lines = read_line(proc.stdout, time.monotonic() + SERVE_TIMEOUT_S,
                          "Serving run ")
        port = int(lines[-1].rsplit(":", 1)[1].split("/")[0])
        check(any("Serving best model from iteration 11600" in line
                  for line in lines), f"serving started with {lines}")
        log(f"serving: {lines[-1]} ({time.perf_counter() - t0:.1f} s to "
            f"start)")
        client = ServingClient("127.0.0.1", port, timeout=60.0)
        check(client.get_run_id() == "smoke-serve", "run-id")

        # Single-state requests from many threads at once, after one
        # untimed round (the net's first forwards at each batch size).
        replies, latency = [None] * SERVE_REQUESTS, [0.0] * SERVE_REQUESTS

        def worker(k, count):
            for i in range(k, count, SERVE_THREADS):
                t = time.perf_counter()
                replies[i] = client.infer_sample(obs_np[i])
                latency[i] = (time.perf_counter() - t) * 1e3

        for count in (SERVE_THREADS, SERVE_REQUESTS):
            threads = [threading.Thread(target=worker, args=(k, count))
                       for k in range(SERVE_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        probs = np.stack([p for p, _ in replies])
        check(probs.shape == (SERVE_REQUESTS, 7), f"replies {probs.shape}")
        n = SERVE_REQUESTS
        bad, close = argmax_disagreements(probs, fp32_11600[:n],
                                          margin[:n])
        plain_bad = [argmax_disagreements(probs, ref[:n])[0]
                     for ref in (fp32_11600, bf16_11600)]
        p50, p99 = np.percentile(latency, [50, 99])
        log(f"serving: {n} single-state requests from {SERVE_THREADS} "
            f"threads in {wall:.2f} s = {n / wall:.1f} requests/s; latency "
            f"p50 {p50:.2f} ms, p99 {p99:.2f} ms; moves equal to the card's "
            f"float32 forward but for {len(close)} rows closer than "
            f"max({ARGMAX_GAP}, {BF16_MARGIN:g} x the row's bf16 rounding, "
            f"median {float(margin[:n].median()):.4f}); where the top two "
            f"are {ARGMAX_GAP} apart, {plain_bad[0]} moves differ from the "
            f"float32 forward and {plain_bad[1]} from the bf16 one at "
            f"B={SERVE_BATCH}")
        check(bad == 0, f"{bad} served moves differ from the card's "
              f"float32 forward")

        t0 = time.perf_counter()
        out = client._call("inference", {"states": obs_np.tolist()})
        batch_ms = (time.perf_counter() - t0) * 1e3
        batch_probs = np.asarray(out["probabilities"], np.float32)
        check(batch_probs.shape == (SERVE_BATCH, 7)
              and len(out["values"]) == SERVE_BATCH
              and np.isfinite(batch_probs).all(), "batch reply")
        bad, close = argmax_disagreements(batch_probs, fp32_11600, margin)
        same_shape = float(np.abs(batch_probs - bf16_11600.numpy()).max())
        log(f"serving: one {SERVE_BATCH}-state batch request in "
            f"{batch_ms:.1f} ms; {len(close)} rows too close to hold; "
            f"max-abs against this process's bf16 forward of the same "
            f"batch {same_shape:.2e}")
        check(bad == 0, f"{bad} batch moves differ from the card's float32 "
              f"forward")

        queue_in = (obs_np[:8], fp32_11600[:8].numpy(),
                    np.linspace(-1, 1, 8).astype(np.float32))
        check(client.append_queue(*queue_in) == 8
              and client.get_queue_size() == 8, "queue append / size")
        for name, got, want in zip(("states", "policies", "values"),
                                   client.retrieve_queue(), queue_in):
            check(np.array_equal(got, want), f"queue round trip: {name}")
        check(client.get_queue_size() == 0, "queue not drained")

        # A newer lineage checkpoint appears: the update loads it.
        shutil.copytree(newer, os.path.join(evaluation, "iteration_11660"))
        check(client.update_best_model() is True, "best-model/update")
        probe = 64
        later = np.stack([client.infer_sample(obs_np[i])[0]
                          for i in range(probe)])
        bad, _ = argmax_disagreements(later, fp32_newer[:probe],
                                      margin_newer[:probe])
        check(bad == 0, f"{bad} moves after the update differ from step "
              f"11,660's float32 forward")
        nets_differ = int((fp32_newer[:probe].argmax(-1)
                           != fp32_11600[:probe].argmax(-1)).sum())
        moved = float(np.abs(later - probs[:probe]).max())
        check(moved > 1e-3, "the replies did not change with the update")
        log(f"serving: best-model/update to iteration_11660, later replies "
            f"follow it ({nets_differ} of {probe} moves differ between the "
            f"two nets; max probability change {moved:.3f})")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = None
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.dirname(newer), ignore_errors=True)
    check(code == 0, f"the serving process exited with {code}")
    log("serving: process stopped with SIGINT, exit code 0")

    # Float32 in process, TF32 off, against the CPU's forward.
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    shutil.copytree(CHECKPOINT, os.path.join(
        root, "connect_n", "smoke-fp32", "evaluation", "iteration_11600"))
    cfg = apply_overrides(Config(), {
        "run.results_dir": root, "run.run_id": "smoke-fp32",
        "model.compute_dtype": "float32"})
    service = build_service(cfg, host="127.0.0.1", port=0,
                            batch_size=SERVE_INFER_BATCH, timeout=0.5)
    service.start()
    try:
        client = ServingClient("127.0.0.1", service.port, timeout=60.0)
        count = 128
        got = [None] * count

        def worker(k):
            for i in range(k, count, SERVE_THREADS):
                got[i] = client.infer_sample(obs_np[i])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        forwards = service.batcher._generation
    finally:
        service.stop()
        shutil.rmtree(root, ignore_errors=True)
    cpu_probs, cpu_values = forward(CHECKPOINT, "cpu")(
        torch.from_numpy(obs_np[:count]))
    err = max(float(np.abs(np.stack([p for p, _ in got])
                           - cpu_probs.numpy()).max()),
              float(np.abs(np.asarray([v for _, v in got])
                           - cpu_values.numpy()).max()))
    check(err < 1e-4, f"served float32 differs from the CPU by {err}")
    check(forwards < count, f"{forwards} forwards for {count} requests: "
          "no micro-batching")
    log(f"serving, float32 in process: {count} requests in {forwards} "
        f"forwards, max-abs vs the CPU forward {err:.2e}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def profiling_phase(device) -> int:
    """Phase 24: the profiling tools on the card; returns K1's launches
    there."""
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.tools import inloop_bench, profile

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    fused_mcts_v2.wave_step.launches = 0
    fused_mcts_v2.wave_step_reference.calls = 0
    t0 = time.perf_counter()
    code, lines = captured_stdout(lambda: profile.main([]))
    check(code == 0, f"tools.profile exited {code}")
    keys = [line.split(":")[0] for line in lines[:5]]
    check(keys == ["selfplay_s", "train_step_s", "arena_s", "sims_per_s",
                   "samples_per_s"], f"tools.profile printed {lines}")
    # The trace, for time at 8 simulations (the tool's default is 64).
    path = profile.capture_trace(trace_dir, sims=TRACE_SIMS)
    seconds = time.perf_counter() - t0
    launches = fused_mcts_v2.wave_step.launches
    check(os.path.exists(path), f"no trace at {path}")
    size = os.path.getsize(path)
    with open(path) as fp:
        text = fp.read()
    # Kernel events carry the kernel's own name; the host's launch calls
    # are named after the runtime call.
    in_trace = len(re.findall(r'"name":\s*"[^"]*wave_kernel', text))
    graph_launches = len(re.findall(r'"name":\s*"cudaGraphLaunch"', text))
    events = text.count('"ph":')
    del text
    check(in_trace > 0, "the trace does not name K1's kernel")
    check(fused_mcts_v2.wave_step_reference.calls == 0,
          "the plain version ran on the card")
    shutil.rmtree(trace_dir, ignore_errors=True)
    # The traced generation: 42 plies x (8 + 1) waves, replayed.
    traced = MAX_PLIES * (TRACE_SIMS + 1)
    log(f"tools.profile main and its trace at {TRACE_SIMS} simulations: "
        f"{seconds:.1f} s, {events} trace events "
        f"({size / 1e6:.1f} MB); K1 launches over the call {launches} (one "
        f"traced generation: {traced}); K1 kernels in the trace {in_trace}, "
        f"cudaGraphLaunch calls {graph_launches}"
        + ("" if in_trace >= traced else
           f" (the profiler saw {traced - in_trace} of the traced "
           "generation's K1 launches not as kernel events)"))

    t0 = time.perf_counter()
    before = fused_mcts_v2.wave_step.launches
    code, lines = captured_stdout(
        lambda: inloop_bench.main(["256", "--iters=1"]))
    check(code == 0 and [line.split(":")[0] for line in lines
                         if line.startswith("continuous=")] == [
        "continuous=False B=256", "continuous=True B=256"],
        f"inloop_bench printed {lines}")
    launches += fused_mcts_v2.wave_step.launches - before
    log(f"tools.inloop_bench main: {time.perf_counter() - t0:.1f} s")
    return launches


def rank_task(work: str) -> None:
    """One rank of phase 25 (two ranks on the card, started by
    custom_alphazero_tpu_torch/parallel/launch.py; each reads its inputs
    from and writes its results to ``work``), in one process for time:

    ``steps``: the float32 train step of phase 10 at dp=2 (each rank takes
    its 512 of the 1024 rows; TF32 off, cuDNN deterministic), then the
    float32 forward of the c4-r5 net at mp=2. ``run``: ``run(cfg)`` on the
    c4-r5 config at dp=2 (``spec.json`` gives the overrides and each
    rank's results directory), the solver scoring 20 positions of each
    arena. ``resume``: the same run resumed at dp=2 from the coordinator's
    directory for one generation of one ply, without training. ``dryrun``:
    ``tools.dryrun_multigpu``'s ranks (mp=2) in these two processes, which
    saves a third start of two ranks."""
    import numpy as np

    from custom_alphazero_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        apply_overrides,
        from_json,
    )
    from custom_alphazero_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_jax_checkpoint,
        save_checkpoint,
    )
    from custom_alphazero_tpu_torch.models.convert import (
        from_jax_variables,
        train_state_from_jax,
        train_state_to_jax,
    )
    from custom_alphazero_tpu_torch.models.policy_value import data_parallel
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.parallel import distributed
    from custom_alphazero_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_params,
    )
    from custom_alphazero_tpu_torch.runtime.loop import run
    from custom_alphazero_tpu_torch.runtime.train import make_train_step
    from custom_alphazero_tpu_torch.tools import strength
    from custom_alphazero_tpu_torch.tools.dryrun_multigpu import dryrun_rank

    device = distributed.initialize()
    rank = distributed.rank()
    with open(os.path.join(work, "spec.json")) as fp:
        spec = json.load(fp)
    results = {"steps": {}, "run": {}, "resume": {}}
    out = results["steps"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    inputs = torch.load(os.path.join(work, "inputs.pt"))
    fp32 = ModelConfig(**spec["widths"], compute_dtype="float32")
    tree, _ = load_checkpoint(TRAINING_STATE)
    state = train_state_from_jax(tree, 7, fp32, device=device)
    mesh = make_mesh(MeshConfig(data_parallelism=2))
    data_parallel(state.net, mesh.data_group, mesh.dp)
    step = make_train_step(fp32, aux_value_weight=0.25,
                           aux_value_batch=AUX_BATCH, mesh=mesh)
    with np.load(LABELS) as labels:
        aux = tuple(torch.from_numpy(labels[k].astype(np.float32)).to(
            device) for k in ("obs", "z"))
    rows = shard_batch(tuple(inputs[k].to(device)
                             for k in ("obs", "pi", "z")), mesh)
    distributed.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, *rows, None, *aux, None,
                inputs["aux_idx"].to(device))
    torch.cuda.synchronize()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    out["step_collectives"] = dict(distributed.COUNTS)
    out["terms"] = [float(getattr(m, t)) for t in (
        "loss", "policy_loss", "value_loss", "l2", "solver_value_loss")]
    if rank == 0:
        save_checkpoint(os.path.join(work, "dp2"),
                        train_state_to_jax(state, fp32), 0.0)
    # The negative control: the same step from the same start with each
    # rank's BatchNorm over its own 512 rows (no data_parallel), the fault
    # that global statistics guard against; it must fail phase 25's rules.
    local = train_state_from_jax(tree, 7, fp32, device=device)
    step(local, *rows, None, *aux, None, inputs["aux_idx"].to(device))
    if rank == 0:
        save_checkpoint(os.path.join(work, "dp2_local_bn"),
                        train_state_to_jax(local, fp32), 0.0)
    del local
    # Five more steps on the same rows, timed (the first one above
    # includes cuDNN's set-up).
    distributed.sync_hosts("timed steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, *rows, None, *aux, None, inputs["aux_idx"].to(device))
    torch.cuda.synchronize()
    out["steady_step_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    # The collectives alone: the step's gradient all-reduce, one
    # BatchNorm layer's (2 x 128 sums), and a host gather of a
    # checkpoint's 200,000 ring rows of 16 int32 words per rank to the
    # coordinator.
    timings = {}
    numel = sum(p.numel() for p in state.net.parameters())
    for name, tensor, repeats in (
            ("all_reduce_gradient", torch.zeros(numel, device=device), 20),
            ("all_reduce_batchnorm", torch.zeros(256, device=device), 20),
            ("gather_host_ring", torch.zeros(
                (RING_CAPACITY // 2, 16), dtype=torch.int32,
                device=device), 3)):
        gather = name.startswith("gather")
        for turn in range(repeats + 1):
            if turn == 1:  # the first is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if gather:
                distributed.gather_host(tensor)
            else:
                distributed.all_reduce(tensor)
        torch.cuda.synchronize()
        timings[name] = 1e3 * (time.perf_counter() - t0) / repeats
    out["collective_ms"] = timings
    out["gradient_floats"] = numel
    params, batch_stats, _ = load_jax_checkpoint(CHECKPOINT)
    net = from_jax_variables(params, batch_stats, 7, fp32, device=device)
    shard_params(net, make_mesh(MeshConfig(data_parallelism=1,
                                           model_parallelism=2)))
    out["sharded"] = [name for name, module in net.named_modules()
                      if type(module).__name__ == "ColumnParallelLinear"]
    with torch.inference_mode():
        logits, value = net(inputs["fwd_obs"].to(device))
    torch.save({"logits": logits.cpu(), "value": value.cpu()},
               os.path.join(work, f"forward{rank}.pt"))
    torch.backends.cudnn.allow_tf32 = True  # the defaults again
    torch.backends.cudnn.deterministic = False
    score_arena_log = strength.score_arena_log
    strength.score_arena_log = lambda log: score_arena_log(
        log, max_positions=SECOND_ARENA_POSITIONS)
    for part, results_dir, extra, generations in (
            ("run", spec["dirs"][rank], {}, 2),
            ("resume", spec["dirs"][0], {
                "self_play.max_plies": "1",
                "loop.train_iterations_per_generation": "0"}, 1)):
        distributed.sync_hosts(part)
        out = results[part]
        with open(C4R5_CONFIG) as fp:
            cfg = apply_overrides(from_json(fp.read()), dict(
                spec["overrides"], **extra,
                **{"run.results_dir": results_dir}))
        captures = fused_mcts_v2.FusedConnectNSearchV2.captures
        fused_mcts_v2.wave_step.launches = 0
        fused_mcts_v2.wave_step_reference.calls = 0
        print(f"phase 25 part {part!r}", flush=True)
        t0 = time.perf_counter()
        out["summary"] = run(cfg, generations=generations)
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = fused_mcts_v2.wave_step.launches
        out["plain_calls"] = fused_mcts_v2.wave_step_reference.calls
        out["captures"] = fused_mcts_v2.FusedConnectNSearchV2.captures - (
            captures)
    with open(os.path.join(work, f"results{rank}.json"), "w") as fp:
        json.dump(results, fp)
    print("phase 25 part 'dryrun'", flush=True)
    t0 = time.perf_counter()
    dryrun_rank(2)  # leaves the process group
    if rank == 0:
        print(f"dry run: {time.perf_counter() - t0:.1f} s", flush=True)


def launch_ranks(work: str, spec: dict, timeout_s: float):
    """Phase 25's two ranks: each rank's output (printed) and results."""
    from custom_alphazero_tpu_torch.parallel import launch

    with open(os.path.join(work, "spec.json"), "w") as fp:
        json.dump(spec, fp)
    t0 = time.perf_counter()
    # The coordinator scores arenas on the host while rank 1 waits in its
    # next collective: the collectives' limit is the call's own.
    outputs = launch.launch(
        2, ["-c", f"import chip_smoke; chip_smoke.rank_task({work!r})"],
        timeout_s=timeout_s, collective_timeout_s=timeout_s)
    log(f"two ranks on the card: {time.perf_counter() - t0:.1f} s")
    results = []
    for rank, text in enumerate(outputs):
        for line in text.splitlines():
            if line.strip():
                print(f"  [rank {rank}] {line}")
        with open(os.path.join(work, f"results{rank}.json")) as fp:
            results.append(json.load(fp))
    return outputs, results


def dir_listing(root: str) -> dict:
    """{path: (size, mtime)} of every file under ``root``."""
    return {os.path.join(d, f): (os.path.getsize(os.path.join(d, f)),
                                 os.path.getmtime(os.path.join(d, f)))
            for d, _, files in os.walk(root) for f in files}


def multi_gpu_phase(card_step, obs, device) -> list:
    """Phase 25; returns each rank's K1 launches in the dp=2 run."""
    import numpy as np

    from custom_alphazero_tpu_torch import paths
    from custom_alphazero_tpu_torch.config import ModelConfig
    from custom_alphazero_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_jax_checkpoint,
        load_replay,
    )
    from custom_alphazero_tpu_torch.models.convert import (
        from_jax_variables,
        train_state_from_jax,
    )
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.parallel import distributed

    # -- 1. NCCL at world size 1 ---------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t0 = time.perf_counter()
    distributed.initialize(init_method=f"file://{work}/store", world_size=1,
                           rank=0)
    backend = distributed.backend()
    x = torch.arange(4.0, device=device)
    distributed.all_reduce(x)
    flags = (distributed.broadcast_flag(True), distributed.broadcast_flag(False))
    distributed.sync_hosts("chip_smoke")
    distributed.shutdown()
    check(backend == "nccl", f"one rank on one card: backend {backend}")
    check(x.tolist() == [0.0, 1.0, 2.0, 3.0] and flags == (True, False),
          f"NCCL at world size 1: {x.tolist()}, flags {flags}")
    log(f"multi-GPU: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} "
        f"at world size 1 on {device}: all_reduce, broadcast_flag, "
        f"sync_hosts in {time.perf_counter() - t0:.2f} s")

    # -- 2a/2b. the dp=2 float32 step and the mp=2 forward --------------------
    widths = dict(depth=4, filters=128, value_hidden=256,
                  lr_boundaries=(10000, 13000),
                  lr_values=(0.0005, 0.00025, 0.0001))
    fwd_obs = obs[:TRAIN_BATCH].cpu()
    torch.save({k: card_step[k] for k in ("obs", "pi", "z", "aux_idx")}
               | {"fwd_obs": fwd_obs}, os.path.join(work, "inputs.pt"))
    # The run's directories, one per rank, each seeded with the committed
    # training state (no ring): rank 1 reads its copy and writes nothing.
    dirs = [os.path.join(work, f"rank{r}") for r in (0, 1)]
    for d in dirs:
        shutil.copytree(TRAINING_STATE,
                        paths.training_path(d, "connect_n", "smoke"))
    before = dir_listing(dirs[1])
    overrides = {
        "arena.evaluation_frequency": "20",
        "arena.checkpoint_frequency": "20",
        "loop.solver_labels_path": LABELS,
        "run.run_id": "smoke",
    }
    os.environ["CAZ_SOLVER_CACHE"] = os.path.join(work, "solver_cache.npz")
    outputs, ranks = launch_ranks(work, {
        "widths": widths, "overrides": overrides, "dirs": dirs}, 900)
    check("distributed: world=2 backend=gloo devices=[cuda:0, cuda:0]"
          in outputs[0], "the two ranks' backend line is missing")
    results = [r["steps"] for r in ranks]
    fp32 = ModelConfig(**widths, compute_dtype="float32")
    tree, _ = load_checkpoint(os.path.join(work, "dp2"))
    dp2 = train_state_from_jax(tree, 7, fp32, device=device)
    card = card_step["state"]

    def max_err(xs, ys):
        return max((x - y).abs().max().item() for x, y in zip(xs, ys))

    param_err = max_err(dp2.net.parameters(), card.net.parameters())
    stat_err = max_err(dp2.net.buffers(), card.net.buffers())
    trace_err = max_err(dp2.trace, card.trace)
    want = [float(getattr(card_step["metrics"], t)) for t in (
        "loss", "policy_loss", "value_loss", "l2", "solver_value_loss")]
    term_err = max(abs(a - b) for a, b in zip(results[0]["terms"], want))
    check(results[0]["terms"] == results[1]["terms"],
          "the two ranks report different loss terms")

    class Reference:  # phase 10's card step, its momentum on the host
        net = card.net
        trace = [t.cpu() for t in card.trace]

    tree, _ = load_checkpoint(os.path.join(work, "dp2_local_bn"))
    local_bn = train_state_from_jax(tree, 7, fp32, device=device)
    leaves = gradient_errors(Reference, card_step["trace_before"],
                             fp32.momentum, {"dp=2": dp2,
                                             "local BN": local_bn})

    def worst_leaf(label):
        leaf = max(leaves, key=lambda leaf: leaf[3][label][1]
                   / max(leaf[2], GRAD_NORM_FLOOR))
        return leaf[0], leaf[3][label][1] / max(leaf[2], GRAD_NORM_FLOOR)

    worst, ratio = worst_leaf("dp=2")
    control, control_ratio = worst_leaf("local BN")
    control_param = max_err(local_bn.net.parameters(), card.net.parameters())
    control_stat = max_err(local_bn.net.buffers(), card.net.buffers())
    log(f"multi-GPU: dp=2 float32 train step (2 x 512 rows + the same 256 "
        f"aux rows; TF32 off, cuDNN deterministic) vs phase 10's one-rank "
        f"step on the card: max-abs parameters {param_err:.3e}, running "
        f"statistics {stat_err:.3e}, momentum {trace_err:.3e}, loss terms "
        f"{term_err:.3e}; worst gradient leaf {worst} at {ratio:.3e} of "
        f"its norm; {results[0]['step_ms']:.1f} ms for that first step "
        f"(cuDNN's set-up included), {results[0]['steady_step_ms']:.1f} ms "
        f"per step over 5 more, {results[0]['step_collectives']} "
        f"collectives per step on rank 0 (two ranks time-share one card "
        f"over Gloo)")
    # The momentum after the step is the gradient plus the same bits in
    # both runs: it is held leaf by leaf as the gradient is (phase 10's
    # rule). Its max-abs is printed, not bounded: the same float32 step on
    # the CPU with the batch's rows reversed moves it by up to 4.3e-4
    # (blocks.2.conv1.conv.weight) from this training state.
    log(f"multi-GPU: collectives over Gloo between the two ranks on the "
        f"card, ms each on rank 0: " + ", ".join(
            f"{k} {v:.3f}" for k, v in results[0]["collective_ms"].items())
        + f" (gradient: {results[0]['gradient_floats']} float32)")
    log(f"multi-GPU: the negative control, the same dp=2 step with each "
        f"rank's BatchNorm over its own 512 rows, vs phase 10's step: "
        f"max-abs parameters {control_param:.3e}, running statistics "
        f"{control_stat:.3e}; worst gradient leaf {control} at "
        f"{control_ratio:.3e} of its norm (the rule: < "
        f"{DP2_GRAD_L2_LIMIT:g})")
    check(param_err < 1e-4 and stat_err < 1e-4,
          f"dp=2 step: parameters {param_err}, statistics {stat_err}")
    check(term_err < 1e-4, f"dp=2 step: loss terms {term_err}")
    for leaf in leaves:
        check(leaf[3]["dp=2"][1] / max(leaf[2], GRAD_NORM_FLOOR)
              < DP2_GRAD_L2_LIMIT, f"dp=2 gradient of {leaf[0]}: "
              f"{leaf[3]['dp=2'][1]:.3e} from a norm of {leaf[2]:.3e}")
    params, batch_stats, _ = load_jax_checkpoint(CHECKPOINT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    net = from_jax_variables(params, batch_stats, 7, fp32, device=device)
    with torch.inference_mode():
        want_logits, want_value = net(fwd_obs.to(device))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    fwd_err = 0.0
    for rank in (0, 1):
        got = torch.load(os.path.join(work, f"forward{rank}.pt"))
        fwd_err = max(fwd_err, (got["logits"] - want_logits.cpu()).abs()
                      .max().item(), (got["value"] - want_value.cpu()).abs()
                      .max().item())
    check(results[0]["sharded"] == ["value_dense1"],
          f"mp=2 sharded {results[0]['sharded']}, expected value_dense1")
    log(f"multi-GPU: mp=2 float32 forward of the c4-r5 net on "
        f"{TRAIN_BATCH} positions (value_dense1's 256 columns split 128 + "
        f"128) vs one rank: max-abs {fwd_err:.3e} (logits, value)")
    check(fwd_err < 1e-4, f"mp=2 forward differs: {fwd_err}")

    # -- 2c. run() on the c4-r5 config at dp=2 --------------------------------
    results = [r["run"] for r in ranks]
    summaries = [dict(r["summary"]) for r in results]
    for summary in summaries:
        summary["timings"] = [{k: v for k, v in t.items()
                               if not k.endswith(("_s", "_second"))}
                              for t in summary["timings"]]
    check(summaries[0] == summaries[1],
          f"the ranks' summaries differ: {summaries}")
    _, meta0 = load_checkpoint(TRAINING_STATE)
    steps = 2 * 20
    check(summaries[0]["iterations"] == meta0["steps"] + steps,
          f"dp=2 run: {summaries[0]['iterations']} iterations")
    expected = 4 * MAX_PLIES * (SIMS + 1) + 3 * fused_mcts_v2.WARMUP_WAVES
    launches = [r["launches"] for r in results]
    check(launches == [expected, expected] and
          [r["plain_calls"] for r in results] == [0, 0] and
          [r["captures"] for r in results] == [3, 3],
          f"dp=2 run: K1 launches {launches} (expected {expected} each), "
          f"plain calls {[r['plain_calls'] for r in results]}, captures "
          f"{[r['captures'] for r in results]}")
    check(dir_listing(dirs[1]) == before, "rank 1 wrote into its directory")
    training = paths.training_path(dirs[0], "connect_n", "smoke")
    tree, meta = load_checkpoint(training)
    ring = load_replay(training)
    rows = np.asarray(ring["value"]).shape[0]
    head, size = np.asarray(ring["head"]), np.asarray(ring["size"])
    check(rows == RING_CAPACITY and head.shape == (2,) and size.shape == (2,)
          and meta["steps"] == meta0["steps"] + steps,
          f"dp=2 checkpoint: {rows} rows, head {head}, size {size}, step "
          f"{meta['steps']}")
    out = outputs[0]
    for iteration in (meta0["steps"] + 20, meta0["steps"] + 40):
        check(re.search(rf"\[iter {iteration}\] arena score=.* \(\+\d+/-\d+/="
                        rf"\d+\)", out) is not None and re.search(
                  rf"\[iter {iteration}\] solver score=", out) is not None,
              f"dp=2 run: no arena or solver score at {iteration}")
    for rank, result in enumerate(results):
        for t in result["summary"]["timings"]:
            log(f"multi-GPU run, rank {rank}, generation {t['generation']}: "
                f"{t['samples']} samples (both ranks), seconds: generate "
                f"{t['generate_s']:.2f}, replay {t['replay_s']:.3f}, train "
                f"{t['train_s']:.3f} ({t['train_iterations']} steps), arena "
                f"{t['arena_s']:.2f}, solver scoring "
                f"{t['solver_score_s']:.2f}, checkpoint "
                f"{t['checkpoint_s']:.3f}")
    log(f"multi-GPU: run(cfg, generations=2) on the c4-r5 config at dp=2 "
        f"(512 games, a 200,000-row ring and 128 arena games per rank): "
        f"{results[0]['wall_s']:.1f} s on rank 0; steps {meta0['steps']} -> "
        f"{meta['steps']}; K1 launches per rank {launches}, no plain calls; "
        f"rank 1 wrote nothing; the checkpoint holds {rows} rows, head "
        f"{head.tolist()}, size {size.tolist()}. Both ranks share one card: "
        "not a scaling figure")

    # The same run resumed at dp=2 from the coordinator's directory (one
    # ply of self-play, no training: the restore is what is checked).
    line = (f"Resumed training state at step {meta['steps']} "
            f"(replay={int(size.sum())})")
    resume = outputs[0][outputs[0].index("phase 25 part 'resume'"):]
    check(line in resume, f"dp=2 resume: no line {line!r}")
    log(f"multi-GPU: resumed at dp=2: {line}")

    # -- 3. the dry run on the card, in the same two ranks ----------------------
    text = outputs[0][outputs[0].index("phase 25 part 'dryrun'"):]
    for head in ("dryrun phase self-play OK", "dryrun phase replay OK",
                 "dryrun phase train OK", "dryrun phase arena OK",
                 "dryrun_multichip OK: mesh={'data': 1, 'model': 2}"):
        check(head in text, f"dry run at 2 ranks: no {head!r} in {text!r}")
    log("multi-GPU: tools.dryrun_multigpu's ranks (mp=2) on the card: "
        "its five lines")
    shutil.rmtree(work, ignore_errors=True)
    check(control_ratio >= DP2_GRAD_L2_LIMIT,
          f"the gradient rule does not tell BatchNorm over the local batch "
          f"from BatchNorm over the global batch: {control_ratio:.3e} in "
          f"{control}")
    return launches


# Phase 26: the fused net's kernels against the plain version. Each layer
# rounds its output to bf16 once in both; float32 sums in another order move
# a rounding by one bf16 step (2**-8 relative) now and then, and that moves
# later layers. Limits: a trunk layer's output within 2 bf16 steps of its
# magnitude, the head features and the outputs as below.
FUSED_LAYER_STEPS = 2.0
FUSED_HEAD_RTOL = 1e-5
FUSED_OUTPUT_LIMIT = 5e-2
# The 19 x 256 identity net at B=256 against its plain version: the logits'
# largest gap over their RMS, and the value's largest gap. Each layer lies
# within a bf16 step of its plain version, and those steps compound over 39
# layers. On an H100 the fused forward read 0.0505 and 0.0570, the module
# path 0.0697 and 0.0743.
FUSED_IDENTITY_LOGIT_LIMIT = 0.06
FUSED_IDENTITY_VALUE_LIMIT = 0.065
FUSED_GRAPH_SIMS = 32


def fused_flops_and_bytes(net, bsz: int, hw) -> tuple:
    """(FLOPs, bytes) of one fused forward from its shapes: each conv's
    2 x M x N x K, the heads and dense layers; each layer's input read once
    and its output written once, bf16 in the trunk, the residual block's
    input read again, float32 observations, weights and head features."""
    from custom_alphazero_tpu_torch.ops import fused_net

    h, w = hw
    m = bsz * h * w
    flops = bytes_ = 0
    for block in fused_net.trunk_convs(net):
        cout, cin, kh, kw = block.conv.weight.shape
        flops += 2 * m * cout * cin * kh * kw
        bytes_ += 4 * cout * cin * kh * kw + 2 * m * cout
    bytes_ += 4 * m * net.stem.conv.in_channels + 2 * m * net.cfg.filters * (
        2 * len(net.blocks))
    heads = (net.policy_conv.conv.out_channels
             + net.value_conv.conv.out_channels)
    flops += 2 * m * heads * net.cfg.filters
    bytes_ += 2 * m * net.cfg.filters + 4 * m * heads
    for dense in (net.policy_dense, net.value_dense1, net.value_dense2):
        flops += 2 * bsz * dense.in_features * dense.out_features
        bytes_ += 4 * dense.weight.numel()
    for block in net.blocks:
        if getattr(block, "inner", None) is not None:
            # A pooled inner block's dense layer (its bytes uncounted).
            dense = block.inner[0].gpool
            if dense is not None:
                flops += 2 * bsz * dense.dense.weight.numel()
            continue
        if block.se is not None:
            # The gate's dense layers, its second conv's output read twice
            # and the block's output written.
            for dense in (block.se.dense1, block.se.dense2):
                flops += 2 * bsz * dense.in_features * dense.out_features
                bytes_ += 4 * dense.weight.numel()
            bytes_ += 3 * 2 * m * net.cfg.filters
    return flops, bytes_


def az_net(device, depth: int = 19, filters: int = 256, se_ratio: int = 0,
           seed: int = 19):
    """AlphaZero's 19 x 256 identity-skip net at Connect-4's shapes, eval
    mode: the port's init from a fixed seed, then every BatchNorm's scale,
    offset and running statistics and every conv bias drawn away from their
    identity values (the benchmark's c4-az19x256 recipe's ranges). With
    ``se_ratio``, a squeeze-excitation gate in every block, its dense
    biases drawn with a standard deviation of 0.5 (the c4-se20x256
    recipe's), so that sigmoid(g) and the offset o stay off 1 and 0."""
    from custom_alphazero_tpu_torch.config import ModelConfig
    from custom_alphazero_tpu_torch.runtime.train import init_train_state

    gen = torch.Generator(device=device).manual_seed(seed)
    net = init_train_state(7, ModelConfig(depth=depth, filters=filters,
                                          residual_projection=False,
                                          se_ratio=se_ratio),
                           gen, (6, 7, 4), device=device).net.eval()
    with torch.no_grad():
        for module in net.modules():
            if hasattr(module, "running_var"):
                for t, lo, hi in ((module.weight, 0.5, 1.5),
                                  (module.running_var, 0.5, 2.0)):
                    t.copy_(lo + (hi - lo) * torch.rand(
                        t.shape, generator=gen, device=device))
                for t in (module.bias, module.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen,
                                              device=device))
            elif isinstance(module, torch.nn.Conv2d):
                module.bias.copy_(0.05 * torch.randn(
                    module.bias.shape, generator=gen, device=device))
        for block in net.blocks:
            if block.se is not None:
                for dense in (block.se.dense1, block.se.dense2):
                    dense.bias.copy_(0.5 * torch.randn(
                        dense.bias.shape, generator=gen, device=device))
    return net


def se_net(device, depth: int = 20, filters: int = 256, ratio: int = 8):
    """Leela Chess Zero's squeeze-excitation tower (20 x 256, a gate of
    ratio 8 in every identity block) at Connect-4's shapes: ``az_net``
    with gates."""
    return az_net(device, depth, filters, ratio, seed=20)


# An SE net's forward on the card against its module path and its plain
# version: logits as a share of the plain logits' RMS, the value as is.
# Two forwards of the same observations are bit-equal (the gates' means
# are summed in a fixed order).
FUSED_SE_LOGIT_LIMIT = 0.06
FUSED_SE_VALUE_LIMIT = 0.065


def se_forward_check(device, bsz: int, filters: int, depth: int = 20) -> dict:
    """An SE net (``se_net``) of ``filters`` at B=``bsz`` through the fused
    forward, twice, against the plain version and the module path (bf16
    autocast, cuDNN): the gaps, whether the two forwards were bit-equal,
    the launches counted in one forward and the block convs' tile."""
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.ops import fused_net

    env = ConnectN(ConnectNConfig())
    gen = torch.Generator(device=device).manual_seed(bsz + filters)
    net = se_net(device, depth, filters)
    obs = env.observe(random_positions(env, bsz, 30, gen, device))
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        counts = (fused_net.conv.launches, fused_net.se.launches,
                  fused_net.forward_plain.calls)
        got = forward(obs)
        counts = tuple(after - before for after, before in zip(
            (fused_net.conv.launches, fused_net.se.launches,
             fused_net.forward_plain.calls), counts))
        again = forward(obs)
        plain = fused_net.forward_plain(net, obs)
        module = net(obs)
        torch.cuda.synchronize()
    rms = plain[0].float().square().mean().sqrt().item()

    def gaps(a):
        return ((a[0].float() - plain[0]).abs().max().item() / rms,
                (a[1].float() - plain[1]).abs().max().item())

    m = bsz * 42
    return {"logit_gap": gaps(got)[0], "value_gap": gaps(got)[1],
            "module_logit_gap": gaps(module)[0],
            "module_value_gap": gaps(module)[1],
            "fused_module_logit_gap": (got[0].float() - module[0].float()
                                       ).abs().max().item() / rms,
            "fused_module_value_gap": (got[1].float() - module[1].float()
                                       ).abs().max().item(),
            "repeat_equal": bool(torch.equal(got[0], again[0])
                                 and torch.equal(got[1], again[1])),
            "conv_launches": counts[0], "se_launches": counts[1],
            "plain_calls": counts[2],
            "tile": fused_net.conv_tile(m, filters, filters, 9,
                                        fused_net._sm_count(device))[0]}


def nbt_net(device, depth: int = 18, filters: int = 384, mid: int = 192,
            pooled: int = 64, pooled_blocks=(5, 10, 15), seed: int = 18):
    """KataGo's b18c384nbt tower (18 nested bottleneck blocks, 384 / 192 /
    64 channels, blocks 5, 10 and 15 pooled) at Connect-4's shapes, eval
    mode: the port's init from a fixed seed, then every BatchNorm's scale,
    offset and running statistics and every conv bias drawn away from their
    identity values (``az_net``'s ranges)."""
    from custom_alphazero_tpu_torch.config import ModelConfig
    from custom_alphazero_tpu_torch.runtime.train import init_train_state

    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = ModelConfig(depth=depth, filters=filters, mid_filters=mid,
                      gpool_filters=pooled, gpool_blocks=tuple(pooled_blocks),
                      residual_projection=False)
    net = init_train_state(7, cfg, gen, (6, 7, 4), device=device).net.eval()
    with torch.no_grad():
        for module in net.modules():
            if hasattr(module, "running_var"):
                for t, lo, hi in ((module.weight, 0.5, 1.5),
                                  (module.running_var, 0.5, 2.0)):
                    t.copy_(lo + (hi - lo) * torch.rand(
                        t.shape, generator=gen, device=device))
                for t in (module.bias, module.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen,
                                              device=device))
            elif isinstance(module, torch.nn.Conv2d):
                module.bias.copy_(0.05 * torch.randn(
                    module.bias.shape, generator=gen, device=device))
    # Running statistics from the batch statistics of 1,024 random
    # positions (the c4-b18c384nbt recipe's calibration): drawn alone they
    # leave 18 blocks' activations far from unit scale, where rounding
    # differences grow from block to block.
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.models.policy_value import BatchNorm

    env = ConnectN(ConnectNConfig())
    obs = env.observe(random_positions(env, 1024, 30, gen, device))
    norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
    for module in norms:
        module.momentum = 1.0  # the running statistics become the batch's
    with torch.no_grad():
        net.train()(obs)
    net.eval()
    with torch.no_grad():
        for module in norms:
            del module.momentum
            std = module.running_var.sqrt()
            module.running_mean.add_(0.1 * std * torch.randn(
                std.shape, generator=gen, device=device))
            module.running_var.mul_(0.5 + 1.5 * torch.rand(
                std.shape, generator=gen, device=device))
    return net


# The nested bottleneck tower's forward on the card against its plain
# version: logits as a share of the plain logits' RMS, the value as is.
# Every launch sits within a bf16 step of its plain layer, but 108 convs
# deep the tower carries those steps on. Over twelve nets (``nbt_net``'s
# seeds 18-29) on an H100 the fused forward read 0.170-0.371 and
# 0.033-0.118 (seed 18, the one checked here: 0.150-0.175 and 0.049 over
# runs), the module path (cuDNN, bf16 autocast), another sound bf16
# forward, 0.289-0.601 and 0.051-0.229. Limits: one and a half times the
# twelve nets' largest, below the module path's largest. A wiring fault
# lies far above: without its pooled biases or inner skips the reference
# moves the log-priors by 2.1 to 9.9 times the logits' RMS
# (azbench.drivers.selfplay_nbt's readings).
FUSED_NBT_LOGIT_LIMIT = 0.55
FUSED_NBT_VALUE_LIMIT = 0.18


@contextlib.contextmanager
def nbt_layers(net, obs):
    """While open, each launch of the nested tower's forward (the stem's
    two outputs, ``conv_pre``, ``conv``, ``gpool``) is held to the plain
    layer on the kernel's own inputs, after it runs: yields a dict of the
    largest gap in bf16 steps by kind of launch."""
    from custom_alphazero_tpu_torch.ops import fused_net as fn

    bsz, h, w, _ = obs.shape
    worst = {}
    bf16 = torch.bfloat16

    def nchw(t):
        return t.reshape(bsz, h, w, -1).permute(0, 3, 1, 2).float()

    def nhwc(t):
        return t.permute(0, 2, 3, 1).reshape(bsz * h * w, -1)

    def note(kind, got, want):
        torch.cuda.synchronize()
        worst[kind] = max(worst.get(kind, 0.0), bf16_steps(got, want))

    orig = (fn.conv_pre, fn.conv, fn.gpool)

    def conv_pre(x, wt, block, hw, raw=None, act=None, skip=None):
        orig[0](x, wt, block, hw, raw, act, skip)
        z = (fn._conv_plain(nchw(x), block, bf16)
             + block.conv.bias[:, None, None])
        if skip is not None:
            z = z + nchw(skip)
        kind = (f"{block.conv.kernel_size[0]}x{block.conv.kernel_size[0]}"
                f"{' +skip' if skip is not None else ''}")
        if raw is not None:
            note(kind + " raw", raw, nhwc(z))
        if act is not None:
            base = raw if raw is not None else nhwc(z).to(bf16)
            note(kind + " act", act[0], nhwc(fn._norm_plain(
                nchw(base), act[1])))

    def conv(x, wt, block, hw, out, residual=None, relu=True, act=None):
        orig[1](x, wt, block, hw, out, residual, relu, act)
        y = torch.relu(fn._epilogue_plain(fn._conv_plain(
            nchw(x), block, bf16), block))
        note("stem" if act is not None else "conv1 folded", out, nhwc(y))
        if act is not None:
            note("stem act", act[0], nhwc(fn._norm_plain(nchw(out), act[1])))

    def gpool(r, g, inner, hw, out):
        orig[2](r, g, inner, hw, out)
        note("gpool", out, nhwc(fn._gpool_plain(nchw(r), nchw(g), inner)))

    # The kernels' counters live on the functions: the stand-ins share them.
    for wrapper, fn_orig in zip((conv_pre, conv, gpool), orig):
        wrapper.__dict__ = fn_orig.__dict__
    fn.conv_pre, fn.conv, fn.gpool = conv_pre, conv, gpool
    try:
        yield worst
    finally:
        fn.conv_pre, fn.conv, fn.gpool = orig


def nbt_forward_check(device, bsz: int) -> dict:
    """The b18c384nbt tower (``nbt_net``) at B=``bsz`` through the fused
    forward: one forward with each launch held to its plain layer
    (``nbt_layers``), then twice unwatched, against the plain version and
    the module path (bf16 autocast, cuDNN): the gaps, the layers' worst
    bf16 steps by kind, whether the two forwards were bit-equal, and the
    launches counted in one forward."""
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.ops import fused_net

    env = ConnectN(ConnectNConfig())
    gen = torch.Generator(device=device).manual_seed(bsz + 18)
    net = nbt_net(device)
    obs = env.observe(random_positions(env, bsz, 30, gen, device))
    forward = fused_net.FusedForward(net)
    counters = (lambda: (fused_net.conv.launches,
                         fused_net.conv.pointwise_launches,
                         fused_net.conv.preact_launches,
                         fused_net.gpool.launches,
                         fused_net.forward_plain.calls))
    with torch.inference_mode():
        with nbt_layers(net, obs) as layers:
            forward(obs)
        before = counters()
        got = forward(obs)
        counts = tuple(a - b for a, b in zip(counters(), before))
        again = forward(obs)
        plain = fused_net.forward_plain(net, obs)
        module = net(obs)
        torch.cuda.synchronize()
    rms = plain[0].float().square().mean().sqrt().item()

    def gaps(a, b=plain):
        return ((a[0].float() - b[0].float()).abs().max().item() / rms,
                (a[1].float() - b[1].float()).abs().max().item())

    return {"logit_gap": gaps(got)[0], "value_gap": gaps(got)[1],
            "module_logit_gap": gaps(module)[0],
            "module_value_gap": gaps(module)[1],
            "fused_module_logit_gap": gaps(got, module)[0],
            "fused_module_value_gap": gaps(got, module)[1],
            "logit_rms": rms, "layers": layers,
            "repeat_equal": bool(torch.equal(got[0], again[0])
                                 and torch.equal(got[1], again[1])),
            "conv_launches": counts[0], "pointwise_launches": counts[1],
            "preact_launches": counts[2], "gpool_launches": counts[3],
            "plain_calls": counts[4]}


def conv_layer_case(device, bsz: int, filters: int, skip: str,
                    seed: int = 0):
    """One trunk conv layer at Connect-4's board (6 x 7), ``filters`` in
    and out, its skip "none", "projection" or "identity": (the bf16 NHWC
    input rows, the packed weight, the ConvBlock, the ``residual`` argument
    of ``fused_net.conv``, the plain layer's bf16 output rows, the plain
    layer as a function of no arguments). Weights, biases and BatchNorm
    parameters and statistics drawn from ``seed``; the input and the skip
    are ReLU'd normals rounded to bf16."""
    import torch.nn.functional as F

    from custom_alphazero_tpu_torch.models.policy_value import ConvBlock
    from custom_alphazero_tpu_torch.ops import fused_net

    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = 6, 7
    m = bsz * h * w

    def block(kernel):
        b = ConvBlock(filters, filters, kernel).to(device).eval()
        with torch.no_grad():
            b.conv.weight.copy_(torch.randn(
                b.conv.weight.shape, generator=gen, device=device)
                / (filters * kernel * kernel) ** 0.5)
            b.conv.bias.copy_(0.05 * torch.randn(filters, generator=gen,
                                                 device=device))
            for t, lo, hi in ((b.bn.weight, 0.5, 1.5),
                              (b.bn.running_var, 0.5, 2.0)):
                t.copy_(lo + (hi - lo) * torch.rand(filters, generator=gen,
                                                    device=device))
            for t in (b.bn.bias, b.bn.running_mean):
                t.copy_(0.1 * torch.randn(filters, generator=gen,
                                          device=device))
        packed = b.conv.weight.permute(0, 2, 3, 1).flatten(1)
        packed = F.pad(packed, (0, fused_net.padded_depth(
            filters, kernel * kernel) - packed.shape[1]))
        return b, packed.bfloat16().contiguous()

    def rows():
        return torch.randn(m, filters, generator=gen, device=device).relu(
            ).bfloat16()

    def plain(inp, b):
        nchw = inp.view(bsz, h, w, filters).permute(0, 3, 1, 2)
        return fused_net._epilogue_plain(
            fused_net._conv_plain(nchw, b, torch.bfloat16), b)

    x = rows()
    conv_block, packed = block(3)
    residual = None
    if skip == "identity":
        residual = rows()
    elif skip == "projection":
        proj, wr = block(1)
        residual = (rows(), wr, proj)

    def layer():
        z = plain(x, conv_block)
        if skip == "identity":
            z = z + residual.view(bsz, h, w, filters).permute(
                0, 3, 1, 2).float()
        elif skip == "projection":
            z = z + plain(residual[0], proj)
        return torch.relu(z).permute(0, 2, 3, 1).reshape(
            m, filters).bfloat16()

    return x, packed, conv_block, residual, layer(), layer


def bf16_steps(got, want) -> float:
    """The largest gap in bf16 steps (2**-8) of ``want``'s magnitude."""
    scale = want.float().abs().max().item() * 2.0 ** -8
    return (got.float() - want.float()).abs().max().item() / scale


def pipelined_conv_check(device, bsz: int, filters: int, skip: str) -> dict:
    """One block conv layer (``conv_layer_case``) through ``fused_net.conv``
    (the pipelined kernel on ``conv_tile``'s tile): its gap from the plain
    layer in bf16 steps and the conv launches counted."""
    from custom_alphazero_tpu_torch.ops import fused_net

    x, packed, block, residual, want, _ = conv_layer_case(device, bsz,
                                                          filters, skip)
    got = torch.empty_like(want)
    with torch.inference_mode():
        launches = fused_net.conv.launches
        fused_net.conv(x, packed, block, (6, 7), got, residual)
        launches = fused_net.conv.launches - launches
        torch.cuda.synchronize()
    return {"steps_plain": bf16_steps(got, want), "launches": launches}


def time_launches(fn, repeats: int = 20) -> float:
    """Mean device ms of ``fn``'s launches, queued behind a GPU sleep."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# The trunk conv shapes of the benchmark's cells and the arenas: (label,
# batch, filters, skip).
CONV_SHAPES = (("c4-r5 B=1024", 1024, 128, "none"),
               ("c4-r5 B=1024", 1024, 128, "projection"),
               ("c4-r5 B=256", 256, 128, "none"),
               ("c4-r5 B=256", 256, 128, "projection"),
               ("az19x256 B=256", 256, 256, "none"),
               ("az19x256 B=256", 256, 256, "identity"),
               ("az19x256 B=1024", 1024, 256, "identity"))


def conv_plans(device) -> None:
    """A tuning aid for ``fused_net.conv_tile``: at each of CONV_SHAPES, the
    pipelined kernel on each tile (128 cells only with a projection),
    checked against the plain layer, and their device times."""
    from custom_alphazero_tpu_torch.ops import fused_net

    sms = fused_net._sm_count(device)
    for label, bsz, filters, skip in CONV_SHAPES:
        x, packed, block, residual, want, _ = conv_layer_case(
            device, bsz, filters, skip)
        m = x.shape[0]
        out = torch.empty(m, filters, dtype=torch.bfloat16, device=device)
        chosen = fused_net.conv_tile(m, filters, filters, 9, sms,
                                     projection=skip == "projection")[0]
        flops = 2 * m * filters * 9 * filters * (
            1 + (skip == "projection") / 9)
        log(f"conv plans, {label} {skip}: conv_tile picks {chosen} cells")
        with torch.inference_mode():
            for bm in fused_net.UNIT_US:
                if skip == "projection" and bm != 128:
                    continue
                ms = time_launches(lambda: fused_net.launch_conv(
                    x, packed, block, (6, 7), out, residual, bm))
                log(f"  {bm} x {fused_net.TILE_FILTERS}: {ms * 1e3:.1f} us "
                    f"({flops / ms / 1e9 / 989:.1%}), "
                    f"{bf16_steps(out, want):.2f} steps from plain")


def conv_times(device) -> dict:
    """Each block conv of the benchmark's self-play paths (c4-r5 at
    B=1,024, the 19 x 256 net at B=256) on the card: the pipelined kernel
    on ``conv_tile``'s tile (checked against the plain layer), the bound
    (the conv's FLOPs at the bf16 peak), the plain layer (TF32 off) and
    cuDNN's bf16 conv alone (the library yardstick): us a launch."""
    import torch.nn.functional as F

    from custom_alphazero_tpu_torch.ops import fused_net

    sms = fused_net._sm_count(device)
    times = {}
    for label, bsz, filters, skip in (CONV_SHAPES[0], CONV_SHAPES[1],
                                      CONV_SHAPES[4], CONV_SHAPES[5]):
        x, packed, block, residual, want, plain = conv_layer_case(
            device, bsz, filters, skip)
        m = x.shape[0]
        tile = fused_net.conv_tile(m, filters, filters, 9, sms,
                                   projection=skip == "projection")[0]
        flops = 2 * m * filters * filters * (9 + (skip == "projection"))
        out = torch.empty_like(want)
        with torch.inference_mode():
            pipelined_us = 1e3 * time_launches(lambda: fused_net.conv(
                x, packed, block, (6, 7), out, residual))
            torch.backends.cudnn.allow_tf32 = False
            plain_us = 1e3 * time_launches(plain, 5)
            torch.backends.cudnn.allow_tf32 = True
            nchw = x.view(bsz, 6, 7, filters).permute(0, 3, 1, 2)
            weight = block.conv.weight.bfloat16()
            library_us = 1e3 * time_launches(
                lambda: F.conv2d(nchw, weight, None, padding=1))
        name = f"{label} {skip}"
        times[name] = {
            "tile": tile, "pipelined_us": pipelined_us,
            "bound_us": flops / 989e6, "plain_us": plain_us,
            "library_us": library_us, "steps_plain": bf16_steps(out, want)}
        check(times[name]["steps_plain"] <= FUSED_LAYER_STEPS,
              f"{name}: the pipelined conv is "
              f"{times[name]['steps_plain']:.2f} bf16 steps from plain")
        log(f"fused net conv, {name}: pipelined {tile} x "
            f"{fused_net.TILE_FILTERS} {pipelined_us:.1f} us "
            f"({flops / pipelined_us / 989e6:.1%} of the bf16 peak), bound "
            f"{flops / 989e6:.1f} us, plain layer {plain_us:.1f} us, cuDNN "
            f"bf16 conv alone {library_us:.1f} us")
    return times


def train_between_searches(device, arena: bool = False) -> dict:
    """A captured K1 search (B=64, 24 noisy simulations) with a fused-net
    evaluator of a fresh 2 x 64 bf16 net (``arena``: the arena's odd-ply
    evaluator, ``_mixed_evaluators``, of a candidate and an incumbent net,
    each forwarding its half), then an in-place train step of that (the
    candidate's) net, then the same search again on the same graph.
    Returns whether the second search's root visits and value sums equal
    bit for bit those of a fresh capture of copies of the trained nets,
    whether they changed from the first search's, the graph captures of
    the two searches, and each search's packs (``pack.search_launches``)."""
    import copy

    from custom_alphazero_tpu_torch.config import (
        ConnectNConfig,
        MCTSConfig,
        ModelConfig,
    )
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.ops import fused_net
    from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
        FusedConnectNSearchV2,
    )
    from custom_alphazero_tpu_torch.runtime.arena import _mixed_evaluators
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.runtime.train import (
        init_train_state,
        make_train_step,
    )

    bsz, sims = 64, 24
    env = ConnectN(ConnectNConfig())
    gen = torch.Generator(device=device).manual_seed(21)
    cfg = ModelConfig(depth=2, filters=64, value_hidden=64)
    states = [init_train_state(7, cfg, gen, env.obs_shape, device)
              for _ in range(2 if arena else 1)]
    nets = [state.net for state in states]
    starters = (torch.arange(bsz, device=device) >= bsz // 2).to(torch.int32)
    mcts_cfg = MCTSConfig(simulations=sims, **NOISE)
    positions = random_positions(env, bsz, 20, gen, device)

    def evaluator(of):
        fns = [make_evaluate_fn(net) for net in of]
        return _mixed_evaluators(*fns, starters)[1] if arena else fns[0]

    def run(search, evaluate):
        noise = torch.Generator(device=device).manual_seed(7)
        packs = fused_net.pack.search_launches
        stats = search.search_root_stats(positions, evaluate, noise, sims)
        return stats, fused_net.pack.search_launches - packs

    search = FusedConnectNSearchV2(env, mcts_cfg, device)
    evaluate = evaluator(nets)
    captures = FusedConnectNSearchV2.captures
    before, first_packs = run(search, evaluate)
    obs = env.observe(random_positions(env, 128, 30, gen, device))
    target_pi = torch.softmax(torch.randn(128, 7, generator=gen,
                                          device=device), dim=-1)
    target_z = torch.randint(-1, 2, (128,), generator=gen,
                             device=device).float()
    make_train_step(cfg)(states[0], obs, target_pi, target_z)
    after, second_packs = run(search, evaluate)
    captures = FusedConnectNSearchV2.captures - captures
    fresh, _ = run(FusedConnectNSearchV2(env, mcts_cfg, device),
                   evaluator([copy.deepcopy(net) for net in nets]))
    return {"fresh_equal": same_bits(after[0], fresh[0])
            and same_bits(after[1], fresh[1]),
            "changed": not same_bits(before[1], after[1]),
            "captures": captures, "packs": [first_packs, second_packs]}


def fused_net_phase(device) -> dict:
    """Phase 26: ops/fused_net.py's kernels on the card. Each kernel against
    its plain version (the pack bit-equal, every conv layer and the heads
    on the kernel's own inputs, then whole forwards) at c4 B=1,024 and 256,
    chess B=128, the 19 x 256 identity net and the SE 20 x 256 net at c4
    B=256; a promote between two replays of a captured search graph changes
    its results as it changes the module path's; the identity and SE nets'
    captured searches count their launches; the SE net's forward on both
    tiles, twice bit-equal; times."""
    import copy

    import torch.nn.functional as F

    from custom_alphazero_tpu_torch.config import (
        ConnectNConfig,
        MCTSConfig,
        ModelConfig,
    )
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.io.checkpoint import load_jax_checkpoint
    from custom_alphazero_tpu_torch.models.convert import from_jax_variables
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2, fused_net
    from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
        FusedConnectNSearchV2,
    )
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn

    widths = dict(depth=4, filters=128, value_hidden=256)
    params, batch_stats, meta = load_jax_checkpoint(CHECKPOINT)
    net = from_jax_variables(params, batch_stats, 7, ModelConfig(**widths))
    env = ConnectN(ConnectNConfig())
    gen = torch.Generator(device=device).manual_seed(26)
    chess, _ = chess_net(chess_config(), "bfloat16", device)
    chess_obs = (torch.rand((128, 8, 8, 118), generator=gen, device=device)
                 < 0.1).float()
    az = az_net(device)
    se = se_net(device)
    cases = [("c4 B=1024", net, env.observe(random_positions(
                  env, 1024, 30, gen, device))),
             ("c4 B=256", net, env.observe(random_positions(
                  env, 256, 30, gen, device))),
             ("chess B=128", chess, chess_obs),
             ("az19x256 B=256", az, env.observe(random_positions(
                  env, 256, 30, gen, device))),
             ("se20x256 B=256", se, env.observe(random_positions(
                  env, 256, 30, gen, device)))]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def gap(got, want):
        return max((g - w).abs().max().item() for g, w in zip(got, want))

    compile_s = None
    for label, case_net, obs in cases:
        forward = fused_net.FusedForward(case_net)
        bsz, h, w, _ = obs.shape
        with torch.inference_mode():
            t0 = time.perf_counter()
            got = forward(obs)
            torch.cuda.synchronize()
            if compile_s is None:
                compile_s = time.perf_counter() - t0
            # The pack, bit for bit.
            table, rows, length = forward._table(device)
            packed = torch.empty(length, dtype=torch.bfloat16, device=device)
            fused_net.pack(table, packed, rows)
            want_packed = torch.cat([F.pad(
                b.conv.weight.permute(0, 2, 3, 1).flatten(1),
                (0, fused_net.padded_depth(i, t) - i * t)).flatten()
                for b, (_, _, _, i, t) in zip(
                    fused_net.trunk_convs(case_net), rows)]).bfloat16()
            check(torch.equal(packed, want_packed),
                  f"{label}: packed weights differ")
            # Each conv layer and the heads on the kernel's own input.
            offsets = iter(packed[o:o + c * fused_net.padded_depth(i, t)]
                           for _, o, c, i, t in rows)
            worst = 0.0
            x_flat, x_nchw = obs, obs.permute(0, 3, 1, 2)
            m = bsz * h * w

            def plain_layer(inp, block):
                return fused_net._epilogue_plain(
                    fused_net._conv_plain(inp, block, torch.bfloat16), block)

            out = torch.empty(m, case_net.cfg.filters, dtype=torch.bfloat16,
                              device=device)
            fused_net.conv(x_flat, next(offsets), case_net.stem, (h, w), out)
            want = torch.relu(plain_layer(x_nchw, case_net.stem))
            nhwc = want.permute(0, 2, 3, 1).reshape(m, -1)
            worst = max(worst, bf16_steps(out, nhwc))
            x_flat = out
            for block in case_net.blocks:
                x_nchw = x_flat.view(bsz, h, w, -1).permute(0, 3, 1, 2)
                y = torch.empty_like(x_flat)
                fused_net.conv(x_flat, next(offsets), block.conv1, (h, w), y)
                want_y = torch.relu(plain_layer(x_nchw, block.conv1))
                worst = max(worst, bf16_steps(
                    y, want_y.permute(0, 2, 3, 1).reshape(m, -1)))
                z = torch.empty_like(x_flat)
                w2 = next(offsets)
                y_nchw = y.view(bsz, h, w, -1).permute(0, 3, 1, 2)
                if block.se is not None:
                    # The second conv without skip or ReLU, then the gate.
                    fused_net.conv(y, w2, block.conv2, (h, w), z, relu=False)
                    worst = max(worst, bf16_steps(z, plain_layer(
                        y_nchw, block.conv2).permute(0, 2, 3, 1).reshape(
                            m, -1)))
                    gated = torch.empty_like(x_flat)
                    fused_net.se(x_flat, z, block, (h, w), gated)
                    want_g = torch.relu(fused_net._gate_plain(
                        x_nchw, z.view(bsz, h, w, -1).permute(0, 3, 1, 2),
                        block.se))
                    worst = max(worst, bf16_steps(
                        gated, want_g.permute(0, 2, 3, 1).reshape(m, -1)))
                    x_flat = gated
                    continue
                if block.proj is None:
                    fused_net.conv(y, w2, block.conv2, (h, w), z,
                                   residual=x_flat)
                    skip = x_nchw.float()
                else:
                    fused_net.conv(y, w2, block.conv2, (h, w), z,
                                   residual=(x_flat, next(offsets),
                                             block.proj))
                    skip = plain_layer(x_nchw, block.proj)
                want_z = torch.relu(plain_layer(y_nchw, block.conv2) + skip)
                worst = max(worst, bf16_steps(
                    z, want_z.permute(0, 2, 3, 1).reshape(m, -1)))
                x_flat = z
            pc = case_net.policy_conv.conv.out_channels
            p = torch.empty(bsz, h * w * pc, device=device)
            v = torch.empty(bsz, h * w, device=device)
            fused_net.heads(x_flat, case_net, p, v)
            x_nchw = x_flat.view(bsz, h, w, -1).permute(0, 3, 1, 2)
            head_err = 0.0
            for feats, head in ((p, case_net.policy_conv),
                                (v, case_net.value_conv)):
                want_h = torch.relu(plain_layer(x_nchw, head)).permute(
                    0, 2, 3, 1).reshape(bsz, -1)
                head_err = max(head_err, ((feats - want_h).abs().max()
                                          / want_h.abs().max()).item())
            plain = fused_net.forward_plain(case_net, obs)
            module = case_net(obs)
        check(worst <= FUSED_LAYER_STEPS, f"{label}: a conv layer is "
              f"{worst:.2f} bf16 steps from its plain version")
        check(head_err <= FUSED_HEAD_RTOL, f"{label}: heads {head_err}")
        if case_net is az or case_net is se:
            # Logits grow with the identity tower's depth: the logit gap is
            # held relative to the plain logits' RMS, the value gap as is.
            rms = plain[0].float().square().mean().sqrt().item()
            gaps = [((a[0] - plain[0]).abs().max().item() / rms,
                     (a[1] - plain[1]).abs().max().item())
                    for a in (got, module)]
            log(f"fused net, {label}: pack bit-equal; conv layers within "
                f"{worst:.2f} bf16 steps of the plain layer, heads "
                f"{head_err:.2e} relative; forward vs plain: logits "
                f"{gaps[0][0]:.4e} of their RMS {rms:.4f}, value max-abs "
                f"{gaps[0][1]:.4e}; module path vs plain {gaps[1][0]:.4e}, "
                f"{gaps[1][1]:.4e}")
            limits = ((FUSED_IDENTITY_LOGIT_LIMIT, FUSED_IDENTITY_VALUE_LIMIT)
                      if case_net is az else
                      (FUSED_SE_LOGIT_LIMIT, FUSED_SE_VALUE_LIMIT))
            check(gaps[0][0] <= limits[0],
                  f"{label}: forward logits {gaps[0][0]}")
            check(gaps[0][1] <= limits[1],
                  f"{label}: forward value {gaps[0][1]}")
            continue
        out_err, module_err = gap(got, plain), gap(module, plain)
        log(f"fused net, {label}: pack bit-equal; conv layers within "
            f"{worst:.2f} bf16 steps of the plain layer, heads "
            f"{head_err:.2e} relative; forward vs plain max-abs {out_err:.3e} "
            f"(logits, value), module path vs plain {module_err:.3e}")
        check(out_err <= FUSED_OUTPUT_LIMIT, f"{label}: forward {out_err}")

    # The identity net's captured search: its launches from zero.
    az_search = FusedConnectNSearchV2(env, MCTSConfig(simulations=8, **NOISE))
    az_states = random_positions(env, 256, 20, gen, device)
    with FusedNetCount() as count:
        az_search.search_root_stats(az_states, make_evaluate_fn(az),
                                    torch.Generator(device=device)
                                    .manual_seed(5), 8)
    az_counts = count.check("19 x 256 captured search", len(az.blocks),
                            identity=len(az.blocks))
    check(count.recorded == 1 and count.noise == 1,
          f"19 x 256 captured search: {az_counts}")
    log(f"fused net: the 19 x 256 identity net's captured search (256 games, "
        f"8 sims): launches {az_counts}")

    # The SE net's captured search: one se launch a block a forward.
    se_search = FusedConnectNSearchV2(env, MCTSConfig(simulations=8, **NOISE))
    with FusedNetCount() as count:
        se_search.search_root_stats(az_states, make_evaluate_fn(se),
                                    torch.Generator(device=device)
                                    .manual_seed(5), 8)
    se_counts = count.check("SE 20 x 256 captured search", len(se.blocks),
                            se=len(se.blocks))
    check(count.recorded == 1 and count.noise == 1,
          f"SE 20 x 256 captured search: {se_counts}")
    log(f"fused net: the SE 20 x 256 net's captured search (256 games, 8 "
        f"sims): launches {se_counts}")
    # Both tiles of its block convs: 192 cells at 256 filters, 128 at 128;
    # two forwards bit-equal.
    se_tiles = {}
    for filters in (256, 128):
        got = se_forward_check(device, 256, filters)
        se_tiles[filters] = got
        log(f"fused net: SE 20 x {filters} at B=256 on {got['tile']}-cell "
            f"tiles: {got}")
        check(got["repeat_equal"] and got["plain_calls"] == 0
              and got["se_launches"] == 20
              and got["conv_launches"] == 41
              and got["logit_gap"] <= FUSED_SE_LOGIT_LIMIT
              and got["value_gap"] <= FUSED_SE_VALUE_LIMIT,
              f"SE 20 x {filters} forward: {got}")

    # KataGo's b18c384nbt tower: its pack bit-equal, each launch against
    # its plain layer and the forward against the plain version and the
    # module path (``nbt_forward_check``), then its captured search's
    # launches from zero: per forward 112 convs (36 of them 1x1, 54 with
    # the dual output), 3 gpool launches, one heads.
    nbt = nbt_net(device)
    nbt_forward = fused_net.FusedForward(nbt)
    with torch.inference_mode():
        nbt_forward(cases[4][2])
        table, rows, length = nbt_forward._table(device)
        packed = torch.empty(length, dtype=torch.bfloat16, device=device)
        fused_net.pack(table, packed, rows)
        want_packed = torch.cat([F.pad(
            b.conv.weight.permute(0, 2, 3, 1).flatten(1),
            (0, fused_net.padded_depth(i, t) - i * t)).flatten()
            for b, (_, _, _, i, t) in zip(fused_net.trunk_convs(nbt),
                                          rows)]).bfloat16()
    check(torch.equal(packed, want_packed),
          "b18c384nbt: packed weights differ")
    nbt_check = nbt_forward_check(device, 256)
    log(f"fused net: b18c384nbt at B=256: pack bit-equal; {nbt_check}")
    check(nbt_check["repeat_equal"] and nbt_check["plain_calls"] == 0
          and (nbt_check["conv_launches"], nbt_check["pointwise_launches"],
               nbt_check["preact_launches"], nbt_check["gpool_launches"])
          == (112, 36, 54, 3)
          and len(nbt_check["layers"]) == 11
          and max(nbt_check["layers"].values()) <= FUSED_LAYER_STEPS
          and nbt_check["logit_gap"] <= FUSED_NBT_LOGIT_LIMIT
          and nbt_check["value_gap"] <= FUSED_NBT_VALUE_LIMIT,
          f"b18c384nbt forward: {nbt_check}")
    nbt_search = FusedConnectNSearchV2(env, MCTSConfig(simulations=8,
                                                       **NOISE))
    with FusedNetCount() as count:
        nbt_search.search_root_stats(az_states, make_evaluate_fn(nbt),
                                     torch.Generator(device=device)
                                     .manual_seed(5), 8)
    nbt_counts = count.check("b18c384nbt captured search", len(nbt.blocks),
                             nested=(112, 36, 54, 3))
    check(count.recorded == 1 and count.noise == 1,
          f"b18c384nbt captured search: {nbt_counts}")
    log(f"fused net: the b18c384nbt net's captured search (256 games, 8 "
        f"sims): launches {nbt_counts}")

    # A promote between two replays of one captured search graph.
    # The promoted net: every parameter and running statistic of the c4-r5
    # net scaled by its own factor in [0.9, 1.1].
    newer = copy.deepcopy(net)
    with torch.no_grad():
        for t in list(newer.parameters()) + list(newer.buffers()):
            t.mul_(0.9 + 0.2 * torch.rand(t.shape, generator=gen,
                                          device=device))
    mcts_cfg = MCTSConfig(simulations=FUSED_GRAPH_SIMS, **NOISE)
    states = random_positions(env, 256, 20, gen, device)

    def module_evaluate(module_net):
        @torch.inference_mode()
        def evaluate(obs):
            logits, value = module_net(obs)
            return torch.softmax(logits, dim=-1), value
        return evaluate

    # One algorithm per convolution on the module path, so that equal
    # batches give equal bits.
    torch.backends.cudnn.deterministic = True
    for label, make in (("fused", make_evaluate_fn),
                        ("module", module_evaluate)):
        best = copy.deepcopy(net)
        search = FusedConnectNSearchV2(env, mcts_cfg)
        evaluate = make(best)

        def run(s, e):
            noise = torch.Generator(device=device).manual_seed(5)
            return s.search_root_stats(states, e, noise, FUSED_GRAPH_SIMS)

        captures = FusedConnectNSearchV2.captures
        with FusedNetCount() as count:
            before = run(search, evaluate)
            best.load_state_dict(newer.state_dict())
            after = run(search, evaluate)
        if label == "fused":
            # One capture: its warm-up waves and its recorded wave; the
            # two searches' 2 x FUSED_GRAPH_SIMS waves are replays.
            search_counts = count.check("captured search", len(net.blocks))
            check((count.recorded, count.eager, count.noise)
                  == (1, fused_mcts_v2.WARMUP_WAVES, 2),
                  f"captured search: fused forwards {search_counts}")
        check(FusedConnectNSearchV2.captures == captures + 1,
              f"{label}: the promote made a new capture")
        fresh = run(FusedConnectNSearchV2(env, mcts_cfg), make(newer))
        check(same_bits(after[0], fresh[0]) and same_bits(after[1], fresh[1]),
              f"{label}: the replayed graph after promote differs from a "
              f"fresh capture of the promoted net")
        check(not same_bits(before[1], after[1]),
              f"{label}: the promote did not reach the replayed graph")
        log(f"fused net: {label} path, one captured search graph (256 games, "
            f"{FUSED_GRAPH_SIMS} sims): a promote (step {meta['steps']}'s "
            f"weights and statistics each scaled by 0.9-1.1) between replays "
            f"gives a fresh capture's root visits and values bit for bit; "
            f"root visits changed at {int((before[0] != after[0]).sum())} "
            f"edges")

    # An in-place train step between two searches on one graph reaches the
    # second: in self-play and through the arena's mixed evaluator, whose
    # graph records two forwards, so two packs a search.
    trained = {}
    for label, forwards in (("self-play", 1), ("arena", 2)):
        got = train_between_searches(device, arena=label == "arena")
        trained[label] = got
        check(got["fresh_equal"] and got["changed"] and got["captures"] == 1
              and got["packs"] == [forwards, forwards],
              f"{label}: a train step between two searches on one graph: "
              f"{got}")
        log(f"fused net: {label}, an in-place train step between two "
            f"searches on one graph (64 games, 24 sims): a fresh capture's "
            f"root visits and values bit for bit; {got}")

    # Times at the self-play shape (TF32 back on for the module path).
    torch.backends.cudnn.deterministic = False
    conv_us = conv_times(device)
    torch.backends.cudnn.allow_tf32 = True
    obs = cases[0][2]
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        fused_ms, fused_host_ms = time_forward(forward, obs, 20)
        module_ms, module_host_ms = time_forward(net, obs, 5)
        torch.backends.cudnn.allow_tf32 = False
        plain_ms, _ = time_forward(
            lambda o: fused_net.forward_plain(net, o), obs, 5)
        torch.backends.cudnn.allow_tf32 = True
        _, ms_by_name, count_by_name, _ = profiled(
            lambda: [forward(obs) for _ in range(10)], host=False)
    flops, bytes_ = fused_flops_and_bytes(net, 1024, (6, 7))
    bound_ms = max(flops / 989e12, bytes_ / HBM_BYTES_PER_S) * 1e3
    # Mean ms of each kernel and the events the profiler kept (it may keep
    # fewer after the earlier phases' traces); the convs of one forward
    # (the stem's, the plain and the residual kernel's instantiations).
    kernels = {name: (ms / count_by_name[name], count_by_name[name])
               for name, ms in ms_by_name.items()}
    convs = [name for name in kernels if "conv_kernel" in name]
    heads_name = [name for name in kernels if "heads_kernel" in name]
    check(len(convs) == 3 and len(heads_name) == 1,
          f"fused net: kernels {sorted(kernels)}")
    conv_ms = (sum(ms_by_name[name] for name in convs)
               / count_by_name[heads_name[0]])
    log(f"fused net at B=1024 (c4-r5): build and first call {compile_s:.1f} s;"
        f" device {fused_ms:.4f} ms a forward (host enqueue "
        f"{fused_host_ms:.4f} ms), bound {bound_ms:.4f} ms ({flops / 1e9:.1f}"
        f" GFLOP, {bytes_ / 1e6:.1f} MB), {flops / fused_ms / 1e9:.1f} "
        f"TFLOP/s; plain version {plain_ms:.4f} ms; module path (cuDNN) "
        f"{module_ms:.4f} ms (host {module_host_ms:.4f} ms)")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        log(f"  {name[:70]}: {ms:.4f} ms ({n} events in 10 forwards)")

    # The 19 x 256 identity net at its self-play shape, B=256.
    az_obs = cases[3][2]
    az_forward = fused_net.FusedForward(az)
    with torch.inference_mode():
        az_ms, az_host_ms = time_forward(az_forward, az_obs, 10)
        az_module_ms, az_module_host_ms = time_forward(az, az_obs, 3)
        _, az_by_name, az_count_by_name, _ = profiled(
            lambda: [az_forward(az_obs) for _ in range(5)], host=False)
    az_flops, az_bytes = fused_flops_and_bytes(az, 256, (6, 7))
    az_bound_ms = max(az_flops / 989e12, az_bytes / HBM_BYTES_PER_S) * 1e3
    check(az_ms < az_module_ms, f"19 x 256 B=256: fused {az_ms:.4f} ms, "
          f"module path {az_module_ms:.4f} ms")
    log(f"fused net at B=256 (19 x 256 identity): device {az_ms:.4f} ms a "
        f"forward (host enqueue {az_host_ms:.4f} ms), bound "
        f"{az_bound_ms:.4f} ms ({az_flops / 1e9:.1f} GFLOP, "
        f"{az_bytes / 1e6:.1f} MB), {az_flops / az_ms / 1e9:.1f} TFLOP/s; "
        f"module path (cuDNN) {az_module_ms:.4f} ms (host "
        f"{az_module_host_ms:.4f} ms)")
    for name, ms in sorted(az_by_name.items(), key=lambda kv: -kv[1]):
        n = az_count_by_name[name]
        log(f"  {name[:70]}: {ms / n:.4f} ms ({n} events in 5 forwards)")

    # The SE 20 x 256 net at the same shape, in the same run.
    se_obs = cases[4][2]
    se_forward = fused_net.FusedForward(se)
    with torch.inference_mode():
        se_ms, se_host_ms = time_forward(se_forward, se_obs, 10)
        se_module_ms, _ = time_forward(se, se_obs, 3)
        _, se_by_name, se_count_by_name, _ = profiled(
            lambda: [se_forward(se_obs) for _ in range(5)], host=False)
    se_flops, se_bytes = fused_flops_and_bytes(se, 256, (6, 7))
    se_bound_ms = max(se_flops / 989e12, se_bytes / HBM_BYTES_PER_S) * 1e3
    check(se_ms < se_module_ms, f"SE 20 x 256 B=256: fused {se_ms:.4f} ms, "
          f"module path {se_module_ms:.4f} ms")
    log(f"fused net at B=256 (SE 20 x 256): device {se_ms:.4f} ms a forward "
        f"(host enqueue {se_host_ms:.4f} ms; the 19 x 256 identity net "
        f"{az_ms:.4f} ms), bound {se_bound_ms:.4f} ms "
        f"({se_flops / 1e9:.1f} GFLOP, {se_bytes / 1e6:.1f} MB), "
        f"{se_flops / se_ms / 1e9:.1f} TFLOP/s; module path (cuDNN) "
        f"{se_module_ms:.4f} ms")
    for name, ms in sorted(se_by_name.items(), key=lambda kv: -kv[1]):
        n = se_count_by_name[name]
        log(f"  {name[:70]}: {ms / n:.4f} ms ({n} events in 5 forwards)")

    # The b18c384nbt tower at the same shape: its FLOPs from the shapes
    # (every conv of ``trunk_convs``, the pooled biases' dense layers, the
    # heads), bound by them.
    with torch.inference_mode():
        nbt_ms, nbt_host_ms = time_forward(nbt_forward, se_obs, 10)
        nbt_module_ms, _ = time_forward(nbt, se_obs, 3)
        _, nbt_by_name, nbt_count_by_name, _ = profiled(
            lambda: [nbt_forward(se_obs) for _ in range(5)], host=False)
    nbt_flops = fused_flops_and_bytes(nbt, 256, (6, 7))[0]
    nbt_bound_ms = nbt_flops / 989e12 * 1e3
    check(nbt_ms < nbt_module_ms, f"b18c384nbt B=256: fused {nbt_ms:.4f} "
          f"ms, module path {nbt_module_ms:.4f} ms")
    log(f"fused net at B=256 (b18c384nbt): device {nbt_ms:.4f} ms a forward "
        f"(host enqueue {nbt_host_ms:.4f} ms), bound {nbt_bound_ms:.4f} ms "
        f"({nbt_flops / 1e9:.1f} GFLOP), {nbt_flops / nbt_ms / 1e9:.1f} "
        f"TFLOP/s; module path (cuDNN) {nbt_module_ms:.4f} ms")
    for name, ms in sorted(nbt_by_name.items(), key=lambda kv: -kv[1]):
        n = nbt_count_by_name[name]
        log(f"  {name[:70]}: {ms / n:.4f} ms ({n} events in 5 forwards)")
    return {
        "name": "fused_net_forward",
        "route": "cuda",
        "source": "custom_alphazero_tpu_torch/csrc/fused_net.cu",
        "replaces": None,
        "launches_captured_search": search_counts,
        "train_between_searches": trained,
        "max_abs_err": out_err,
        "ms": fused_ms,
        "conv_kernels_ms": conv_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "flops" if flops / 989e12 > bytes_ / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": module_ms,
        "az19x256_b256": {"ms": az_ms, "bound_ms": az_bound_ms,
                          "library_ms": az_module_ms,
                          "launches_captured_search": az_counts},
        "se20x256_b256": {"ms": se_ms, "bound_ms": se_bound_ms,
                          "library_ms": se_module_ms,
                          "launches_captured_search": se_counts,
                          "tiles": se_tiles},
        "b18c384nbt_b256": {"ms": nbt_ms, "bound_ms": nbt_bound_ms,
                            "library_ms": nbt_module_ms,
                            "launches_captured_search": nbt_counts,
                            "check": nbt_check},
        "convs_us": conv_us,
    }


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
    if sys.argv[1:] == ["--conv-plans"]:
        conv_plans(torch.device("cuda"))
        return 0
    if sys.argv[1:] == ["--fused-net"]:
        print(json.dumps({"kernels": [fused_net_phase(torch.device("cuda"))]}))
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
    plies_of = {"graph": MAX_PLIES, "host launches": HOST_PLIES}
    generators = {
        "graph": make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES),
        "host launches": make_selfplay_fn(env, mcts_cfg, sp_cfg, HOST_PLIES,
                                          graph=False),
    }
    for turn, label in enumerate(("graph", "host launches")):
        plies = plies_of[label]
        forwards = plies * SIMS
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
        expected = plies * (SIMS + 1) + (
            fused_mcts_v2.WARMUP_WAVES if turn == 0 else 0)
        check(turn_launches == expected, f"{label}: kernel launched "
              f"{turn_launches} times, expected {expected}")
        check(plain_calls == 0, f"plain version ran {plain_calls} times")
        kernel_s = turn_launches * kernel_ms / 1e3
        net_s = forwards * net_ms / 1e3
        log(f"self-play, {label}: {plies} plies x {BATCH} games x "
            f"{SIMS} sims in {wall:.2f} s = "
            f"{plies * BATCH * SIMS / wall:.0f} sims/s; {turn_launches} "
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
    general_sims_s = general_selfplay(env, mcts_cfg, sp_cfg, eval_bf16,
                                      device)
    torch.backends.cudnn.deterministic = False

    # ---- 9. codec and replay ring -------------------------------------------
    ring, codec = ring_phase(env, samples, gen, device)

    # ---- 10. train step -----------------------------------------------------
    card_step = train_phase(ring, codec, gen, device)
    del ring

    # ---- 11. arena ----------------------------------------------------------
    arena_launches, arena_fused = arena_phase(env, mcts_cfg, net_bf16, gen,
                                              device)

    # ---- 12. the entry point ------------------------------------------------
    (learner_launches, learner_fused), run_copy = learner_phase(device)

    # ---- 13. the supervisor with run_c4_r5.sh's flags -----------------------
    step_11660 = supervisor_phase(run_copy)

    # ---- 14. the strength tool ----------------------------------------------
    strength_phase(device)

    # ---- 15. chess engine on the card ---------------------------------------
    positions = chess_engine_phase(device)

    # ---- 16. Gumbel search, card vs CPU -------------------------------------
    chess_gumbel_phase(positions, device)

    # ---- 17. chess-r5 Gumbel self-play --------------------------------------
    chess_selfplay_phase(device)

    # ---- 18. the entry point on chess-r5 ------------------------------------
    chess_run_copy = chess_learner_phase(device)

    # ---- 19. the supervisor with run_chess_r5.sh's flags --------------------
    chess_supervisor_phase(chess_run_copy)

    # ---- 20. the Connect-4 evaluation battery -------------------------------
    battery_launches = c4_battery_phase(device)

    # ---- 21. the chess panel ------------------------------------------------
    chess_panel_phase(device)

    # ---- 22. subtree reuse --------------------------------------------------
    reuse_phase(env, mcts_cfg, sp_cfg, eval_bf16, general_sims_s, gen, device)

    # ---- 23. the serving tier -----------------------------------------------
    serving_phase(env, gen, device, step_11660)

    # ---- 24. the profiling tools --------------------------------------------
    profiling_launches = profiling_phase(device)

    # ---- 25. multi-GPU ------------------------------------------------------
    multi_gpu_launches = multi_gpu_phase(card_step, obs, device)

    # ---- 26. the fused net --------------------------------------------------
    fused_kernel = fused_net_phase(device)
    fused_kernel["launches_arena"] = arena_fused
    fused_kernel["launches_learner"] = learner_fused

    # ---- 27. result lines ---------------------------------------------------
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
        "launches_strength_tool": battery_launches,
        "launches_profiling_tools": profiling_launches,
        "launches_multi_gpu_per_rank": multi_gpu_launches,
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
    }, fused_kernel]
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
