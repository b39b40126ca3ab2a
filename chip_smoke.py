#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the repo root on a machine with a CUDA card, the CUDA toolkit and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failed check raises and exits non-zero):

1. Device: CUDA present; the card's name and power limit (nvidia-smi).
2. Build: nvcc builds every kernel of the path from the repo's sources into
   build/kernels/.
3. Kernel vs plain version: whole searches (B=1024, 250 simulations, root
   noise on, a dyadic evaluator) from random positions at 7x6 n=4 and 5x4
   n=3, through the CUDA wave kernel and ``wave_reference`` side by side;
   all 12 carry arrays and the leaf board must be bit-equal after every
   wave. Times of the kernel (CUDA events over back-to-back launches), of
   the plain version, and the kernel's bytes bound.
4. Net: the committed c4-r5 checkpoint through load_jax_checkpoint; the
   card's fp32 forward (TF32 off) against the CPU's, and bf16 against fp32.
5. Main path: c4-r5 self-play (depth 4, 128 filters, 250 simulations,
   Dirichlet alpha 1.0, continuous auto-reset, 1024 games, 42 plies) with
   the trained weights in bf16; every search wave must go through the
   kernel and none through the plain version. Prints simulations/s, the
   kernel / net / rest split and the sample checks.
6. The kernels' JSON line, the card's line, and the result line.
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
SNAPSHOT_LAUNCHES = 10


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


def leaf_depth(carry, leaf):
    """(B,) tree depth of each game's ``leaf`` node."""
    parent = carry.parent
    batch = torch.arange(parent.shape[0], device=parent.device)
    node = leaf[:, 0].long()
    depth = torch.zeros_like(node)
    for _ in range(parent.shape[1]):
        active = node > 0
        if not bool(active.any()):
            break
        depth += active.long()
        node = torch.where(active, parent[batch, node].long(), node)
    return depth


def touched_bytes(prev_depth, new_depth, actions: int) -> int:
    """Bytes one wave must move for this data: phase A writes the leaf's
    prior column and flag and reads/writes two edge statistics per backup
    level (plus the parent links); phase B reads the root board, per
    descent level a node's row of prior, visits and value sums and its
    child/terminal/expanded entries, and writes the new node and the leaf
    board. Inputs (mixed, renormed, value) read once."""
    per_game = (
        (actions + 1) + 2 + 6 * prev_depth            # expand + backup
        + 64 + (new_depth + 1) * (3 * actions + 3)    # descent
        + 6 + 3 + 64                                  # create + leaf
        + 2 * actions + 1                             # wave inputs
    )
    return int(4 * per_game.sum().item())


def kernel_vs_plain(env, cfg, states, sims, gen, timed: bool):
    """Lockstep searches through the kernel and the plain version; returns
    (max_abs_err, kernel_ms, plain_ms, bound_ms, carry_bound_ms)."""
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2 as fm

    device = states.board.device
    bsz, a = states.board.shape[0], env.num_actions
    search = fm.FusedConnectNSearchV2(env, cfg, device)
    geom = search.geometry(sims)
    evaluate = dyadic_evaluate(a)
    root_board = fm.padded_board(states.board)
    carry_k = fm.init_carry(env, states, sims + 1)
    carry_p = fm.Carry(*(t.clone() for t in carry_k))
    root_live = ~env.is_terminal(states)
    leaf_board = torch.zeros((bsz, 64), device=device)
    probs = torch.zeros((bsz, a), device=device)
    value = torch.zeros((bsz, 1), device=device)
    root_prior = torch.zeros((bsz, a), device=device)
    names = fm.Carry._fields + ("leaf_board",)
    snap_waves = {1, sims // 4, sims // 2, (3 * sims) // 4, sims - 1}
    snapshots = []
    max_err = 0.0
    for w in range(sims + 1):
        gamma = search._mcts.wave_noise(gen, bsz, device) if w < sims else None
        renormed, mixed, root_prior = search.wave_inputs(
            w, sims, leaf_board, carry_k.leaf_terminal, probs, root_prior,
            root_live, gamma,
        )
        inputs = (mixed.contiguous(), renormed, value, root_board)
        if timed and w in snap_waves:
            snapshots.append((w, inputs, fm.Carry(*(t.clone()
                                                    for t in carry_k))))
        carry_k, leaf_board = fm.wave(w, *inputs, carry_k, geom)
        carry_p, leaf_p = fm.wave_reference(w, *inputs, carry_p, geom)
        for name, k_t, p_t in zip(names, list(carry_k) + [leaf_board],
                                  list(carry_p) + [leaf_p]):
            if not torch.equal(k_t.view(torch.int32), p_t.view(torch.int32)):
                bad = (k_t.view(torch.int32) != p_t.view(torch.int32))
                idx = bad.nonzero()[0].tolist()
                raise AssertionError(
                    f"wave {w}: kernel and plain version differ in {name} "
                    f"at {idx}: {k_t[tuple(idx)].item()} vs "
                    f"{p_t[tuple(idx)].item()}"
                )
            max_err = max(max_err, (k_t - p_t).abs().max().item())
        if w < sims:
            probs, v = evaluate(fm.observe_board(leaf_board, env.cfg.height,
                                                 env.cfg.width))
            value = v.reshape(bsz, 1).contiguous()
    if not timed:
        return max_err, None, None, None, None

    # Times at the snapshot waves. The kernel: back-to-back launches on
    # copies of the carry, queued behind a GPU sleep so that host launch
    # cost stays out of the events. The plain version synchronises
    # internally; it is timed per call.
    kernel_ms, plain_ms, bound_ms = [], [], []
    carry_bytes = 4 * bsz * (4 * a * (sims + 1) + 5 * (sims + 1) + 3)
    for w, inputs, snap in snapshots:
        copies = [fm.Carry(*(t.clone() for t in snap))
                  for _ in range(SNAPSHOT_LAUNCHES)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        start.record()
        for copy in copies:
            after, _ = fm.wave(w, *inputs, copy, geom)
        end.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(end) / SNAPSHOT_LAUNCHES)
        prev_depth = leaf_depth(snap, snap.leaf)
        new_depth = leaf_depth(after, after.leaf)
        bound_ms.append(touched_bytes(prev_depth, new_depth, a)
                        / HBM_BYTES_PER_S * 1e3)
        copy = fm.Carry(*(t.clone() for t in snap))
        start.record()
        fm.wave_reference(w, *inputs, copy, geom)
        end.record()
        torch.cuda.synchronize()
        plain_ms.append(start.elapsed_time(end))
        log(f"  wave {w}: kernel {kernel_ms[-1]:.4f} ms, plain "
            f"{plain_ms[-1]:.3f} ms, bound {bound_ms[-1]:.5f} ms, mean "
            f"depth {new_depth.float().mean().item():.2f}")
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return (max_err, mean(kernel_ms), mean(plain_ms), mean(bound_ms),
            2 * carry_bytes / HBM_BYTES_PER_S * 1e3)


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


def profile_ply(generate, evaluate, gen) -> None:
    """One more ply of the main path under torch.profiler: device busy time
    by kernel, and the device's idle share of the ply's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    generate(evaluate, gen, BATCH)  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(evaluate, gen, BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    if not by_name:
        log("profiled ply: device time not measured (no device events)")
        return
    search = sum(ms for name, ms in by_name.items() if "wave_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profiled ply ({SIMS + 1} waves, B={BATCH}): wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; "
        f"wave kernel {search:.2f} ms ({search / (SIMS + 1):.4f} ms/wave)")
    for name, ms in top:
        log(f"  {ms:8.2f} ms  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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
    logs = _build.build(["fused_mcts_v2"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in logs["fused_mcts_v2"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain version ------------------------------------------
    gen = torch.Generator(device=device).manual_seed(0)
    noise = dict(use_dirichlet=True, dirichlet_alpha=1.0,
                 dirichlet_fraction=0.25, c_puct=1.5)
    results = {}
    for geometry, timed in ((dict(width=7, height=6, n=4), True),
                            (dict(width=5, height=4, n=3), False)):
        env = ConnectN(ConnectNConfig(**geometry))
        cfg = MCTSConfig(simulations=SIMS, **noise)
        states = random_positions(env, BATCH, 20, gen, device)
        t0 = time.perf_counter()
        results[geometry["width"]] = kernel_vs_plain(env, cfg, states, SIMS,
                                                     gen, timed)
        log(f"kernel vs plain {geometry}: bit-equal on all 13 arrays at "
            f"every wave of a B={BATCH}, {SIMS}-simulation search "
            f"({time.perf_counter() - t0:.1f} s)")
    max_err, kernel_ms, plain_ms, bound_ms, carry_bound_ms = results[7]
    max_err = max(max_err, results[5][0])
    log(f"wave at B={BATCH}, N={SIMS + 1}, 7x6: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, touched-bytes bound {bound_ms:.5f} ms, "
        f"carry-bytes bound {carry_bound_ms:.4f} ms")

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
    mcts_cfg = MCTSConfig(simulations=SIMS, c_puct=1.5, dirichlet_alpha=1.0,
                          dirichlet_fraction=0.25, use_dirichlet=True,
                          greedy_from_move=12)
    sp_cfg = SelfPlayConfig(games_per_generation=BATCH, continuous=True,
                            exclude_draws=False)
    generate = make_selfplay_fn(env, mcts_cfg, sp_cfg, MAX_PLIES)
    fused_mcts_v2.wave.launches = 0
    fused_mcts_v2.wave_reference.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, stats = generate(eval_bf16, gen, BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_mcts_v2.wave.launches
    plain_calls = fused_mcts_v2.wave_reference.calls
    expected = MAX_PLIES * (SIMS + 1)
    check(launches == expected,
          f"kernel launched {launches} times, expected {expected}")
    check(plain_calls == 0, f"plain version ran {plain_calls} times")
    sims_per_s = MAX_PLIES * BATCH * SIMS / wall
    forwards = MAX_PLIES * SIMS
    kernel_s = launches * kernel_ms / 1e3
    net_s = forwards * net_ms / 1e3
    log(f"self-play: {MAX_PLIES} plies x {BATCH} games x {SIMS} sims in "
        f"{wall:.2f} s = {sims_per_s:.0f} sims/s; {launches} kernel "
        f"launches, {plain_calls} plain-version calls")
    log(f"  per wave {1e3 * wall / launches:.3f} ms wall; split by "
        f"standalone device times x counts: kernel {kernel_s:.2f} s "
        f"({100 * kernel_s / wall:.1f}%), net {net_s:.2f} s "
        f"({100 * net_s / wall:.1f}%), rest (host work the device waits "
        f"for, small ops) {wall - kernel_s - net_s:.2f} s "
        f"({100 * (wall - kernel_s - net_s) / wall:.1f}%)")

    profile_ply(make_selfplay_fn(env, mcts_cfg, sp_cfg, 1), eval_bf16, gen)

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

    # ---- 6. result lines ----------------------------------------------------
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
