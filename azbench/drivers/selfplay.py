"""Self-play traffic: whole generations of ``Learner.generate`` followed by
``Learner.replay_add``, back to back, as the training loop runs them.

Set-up builds the Learner with the configuration's weights and plays one
generation (the fused search's CUDA graph is captured there). The window
plays whole generations: the last one starts before ``--seconds`` have
run out, and the rate is over all of them, from the first start to the
last ``torch.cuda.synchronize()``. ``--trace 1`` profiles the window's
first generation and its ring add.

Parameters (the traffic file): ``search_roots``, how many roots of the
last ply the check searches again with the reference.

The check (Connect-4 only) judges every generation of the window by the
rules (``checks.selfplay_faults``), the ring rows the last generation added
against its batch, decoded by the reference codec, and the root visits of
the last ply on a seeded sample of roots against the reference search at
the same root noise, with the reference net in float32.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from azbench import checks
from azbench.drivers import common
from azbench.reference import search as ref_search


def setup(run):
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    lrn = common.learner(run)
    replay = lrn.init_replay()
    with run.span("warmup_generation"):
        batch, _ = lrn.generate()
        replay = lrn.replay_add(replay, batch)
    del batch
    return SimpleNamespace(learner=lrn, replay=replay, gens=[], elapsed=0.0)


def _launches():
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    return fused_mcts_v2.wave_step.launches


def window(run, st):
    lrn = st.learner
    t0 = time.perf_counter()
    while True:
        traced = run.trace and not st.gens
        launches = _launches()
        with (run.bracket(keep=("wave_kernel",)) if traced
              else contextlib.nullcontext()):
            batch, _ = lrn.generate()
            run.sync()
            head = st.replay.head.clone()
            with run.span("replay_add"):
                st.replay = lrn.replay_add(st.replay, batch)
        if traced:
            run.values["bracket_waves"] = _launches() - launches
            run.values["bracket_plies"] = batch.valid.shape[0] // (
                lrn.cfg.self_play.games_per_generation)
            run.values["bracket_depths"] = _last_ply_depths(lrn)
        st.gens.append((batch, head))
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    st.elapsed = time.perf_counter() - t0
    positions = sum(int(b.valid.shape[0]) for b, _ in st.gens)
    run.attempted = positions
    run.metrics["selfplay_positions_per_s"] = positions / st.elapsed
    run.values["positions"] = positions
    run.values["generations"] = len(st.gens)


def _last_ply_depths(lrn):
    """Per game, the depths of the leaves that the last search's waves
    reached (the created nodes in order, then the terminal revisits at the
    mean depth of the game's terminal nodes), read from the fused search's
    tree: the depths K1's launches of that ply saw."""
    search = common.fused_search(lrn.selfplay)
    if search is None:
        return None
    sims = lrn.cfg.mcts.simulations
    static = search._static[(lrn.cfg.self_play.games_per_generation, sims)]
    parent = static.carry.parent.cpu().numpy().astype(np.int64)
    terminal = static.carry.is_terminal.cpu().numpy() > 0
    count = static.carry.node_count.cpu().numpy().reshape(-1).astype(int)
    bsz, n = parent.shape
    depth = np.zeros((bsz, n), np.int64)
    rows = np.arange(bsz)
    for node in range(1, n):  # a parent's slot precedes its children's
        p = parent[:, node]
        depth[:, node] = np.where(p >= 0, depth[rows, np.maximum(p, 0)] + 1,
                                  0)
    out = []
    for b in range(bsz):
        created = depth[b, 1:count[b]]
        revisits = sims - 1 - len(created)
        term = depth[b, :count[b]][terminal[b, :count[b]]]
        fill = float(term.mean()) if len(term) else 0.0
        out.append(np.concatenate([[0.0], created, np.full(revisits, fill)]))
    return out


def check(run, st):
    lrn = st.learner
    cfg = lrn.cfg
    if cfg.game != "connect_n":
        raise NotImplementedError("the self-play check reads Connect-4")
    h, w = cfg.connect_n.height, cfg.connect_n.width
    bsz = cfg.self_play.games_per_generation
    sims = cfg.mcts.simulations
    faults = 0
    for batch, _ in st.gens:
        t_len = batch.valid.shape[0] // bsz
        obs = batch.obs.reshape(t_len, bsz, h, w, 4).cpu().numpy()
        n, kinds = checks.selfplay_faults(
            obs, batch.policy.reshape(t_len, bsz, -1).cpu().numpy(),
            batch.value.reshape(t_len, bsz).cpu().numpy(),
            batch.valid.reshape(t_len, bsz).cpu().numpy(),
            cfg.connect_n.n, sims, cfg.mcts.greedy_from_move)
        faults += n
        if kinds:
            print(f"selfplay faults: {kinds}", flush=True)
    run.compare("selfplay_faults", faults)

    # The last generation's rows in the ring.
    batch, head = st.gens[-1]
    valid = batch.valid.cpu().numpy()
    capacity = st.replay.capacity
    count = int(valid.sum())
    slots = (int(head) + np.arange(count)) % capacity
    ring = st.replay
    run.compare("ring_faults", checks.ring_faults(
        ring.obs.words.cpu().numpy(), ring.obs.scalars.cpu().numpy(),
        ring.policy.cpu().numpy(), ring.value.cpu().numpy(), slots,
        batch.obs[batch.valid].cpu().numpy(),
        batch.policy[batch.valid].cpu().numpy(),
        batch.value[batch.valid].cpu().numpy(), (h, w, 4),
        lrn.codec.binary_channels, lrn.codec.scalar_channels))

    # The last ply's searches, again with the reference at the same noise.
    t_len = batch.valid.shape[0] // bsz
    obs = batch.obs.reshape(t_len, bsz, h, w, 4)[-1].cpu().numpy()
    pi = batch.policy.reshape(t_len, bsz, -1)[-1].cpu().numpy()
    search = common.fused_search(lrn.selfplay)
    gamma = search._static[(bsz, sims)].buffers.gamma.cpu().numpy()
    # The root noise is the program's own draw, which the reference takes
    # as it is: the draws' mean is held to Gamma(alpha)'s, in standard
    # errors (alpha / n is the variance of a mean of n draws).
    alpha = cfg.mcts.dirichlet_alpha
    run.compare("noise_mean_z", abs(float(gamma.astype(np.float64).mean())
                                    - alpha) / np.sqrt(alpha / gamma.size))
    del st.gens[:-1]
    st.learner = None
    if run.cuda:
        torch.cuda.empty_cache()
    visits_ref, visits_prog = search_again(run, cfg, obs, pi, gamma)
    run.compare("search_tv_mean",
                checks.visit_distance(visits_prog, visits_ref))


def search_again(run, cfg, obs, pi, gamma, quantize=None):
    """(reference visits, program visits) at a seeded sample of the last
    ply's roots that are not yet played greedily."""
    boards = ref_search.connect4.boards_from_obs(obs)
    plies = (boards != 0).sum(axis=(-1, -2))
    candidates = np.nonzero(plies < cfg.mcts.greedy_from_move)[0]
    rng = np.random.default_rng(run.seed)
    k = min(int(run.traffic["search_roots"]), len(candidates))
    pick = np.sort(rng.choice(candidates, size=k, replace=False))
    sims = cfg.mcts.simulations
    program = np.round(pi[pick] * (sims - 1)).astype(np.int64)
    device = run.device
    common.strict_float32()
    params, stats, _, _ = common.reference_weights(run, device)
    evaluate = common.reference_evaluator(params, stats, cfg.model.depth,
                                          device, quantize)
    fraction = cfg.mcts.dirichlet_fraction if cfg.mcts.use_dirichlet else 0.0
    reference = ref_search.search(
        boards[pick], evaluate, sims, cfg.mcts.c_puct, cfg.connect_n.n,
        gamma[:, pick, :] if cfg.mcts.use_dirichlet else None, fraction)
    return reference, program


def close(st):
    st.learner = None
    st.gens = []
