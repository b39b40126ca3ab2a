"""Self-play traffic on weights made from the seed: whole generations of
``Learner.generate`` followed by ``Learner.replay_add``, back to back, as
the training loop runs them (``selfplay.py``'s window), for a configuration
of identity-skip residual blocks whose weights are a recipe
(``<weights>/seeded.json``) and not a checkpoint.

Set-up refuses, before it plays anything, a configuration with projection
blocks (the reference here is ``reference/net_identity.py``) and a program
that cannot build the configuration's residual path: one whose
``ModelConfig`` lacks ``residual_projection``, or whose built net's blocks
have a projection. It then builds the Learner from the configuration with
``--seed``, draws the weights by the recipe (``seeded_tree``, numpy alone,
in the Flax layout), loads them into the candidate through the program's
converter, promotes them to the best net that self-play searches with, and
plays one generation (the search's CUDA graph is captured there). The
window is ``selfplay``'s; ``--trace 1`` also keeps the traced generation's
``conv_kernel`` events.

Parameters (the traffic file): ``search_roots``, how many roots of the
last ply the readings search again with the float32 reference net.

The check (Connect-4 only): ``selfplay``'s rule faults of every window
generation, the last generation's ring rows and the root noise's mean;
then the last ply's search played again from its roots at the same root
noise through the program's own graph (``replay_search``: on the card one
replay of the CUDA graph that the window replays per wave, its step kernel
and then the net into the search's buffers), and read from those buffers:

- ``search_faults``: roots at which the reference search
  (``reference/search.py``), fed the program's own evaluations wave by
  wave, reaches other root visits, or a leaf with another observation;
- ``logit_gap``: of the first wave's evaluation (the roots), the largest
  gap of the log-priors from the float32 identity-skip reference net's
  (``reference/net_identity.py``) on the recipe's weights, over the root
  mean square of the reference's logits, centred per row;
- ``value_gap``: the largest value gap, the same rows.

The readings that the limits are set from, on the card at the cell's size:

    python3 -m azbench.drivers.selfplay_seeded --workload <cell> \\
        --seeds 1,2,3

prints one JSON line a seed with the compared numbers of the program
(``program``) and of the precision control (``float8``: the reference one
precision below the configuration's bfloat16, ``net.float8_rounding``, in
the program's place), each against the float32 reference, and beside them
``search_tv_mean``, which the check leaves out: the mean total-variation
distance of the last ply's root visits (``search_roots`` seeded roots not
yet played greedily) from the reference search with the float32 reference
net (``search_again``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from azbench import checks, harness
from azbench.drivers import common, selfplay
from azbench.reference import net_identity as ref_net
from azbench.reference import search as ref_search

# Flax's default kernel init (lecun_normal): a normal truncated at two
# standard deviations, rescaled to the variance asked for.
TRUNCATED_STD = 0.87962566103423978


def refuse_other_net(run, lrn=None) -> None:
    """Raise unless the configuration has identity blocks and the program
    builds them: its ``ModelConfig`` has ``residual_projection`` and (given
    a Learner) no block of its nets has a projection."""
    from custom_alphazero_tpu_torch.config import ModelConfig

    want = run.config["config"]["model"].get("residual_projection", True)
    if want:
        raise ValueError(
            "selfplay_seeded compares identity-skip nets: the configuration "
            "asks for projection blocks (model.residual_projection)")
    if "residual_projection" not in {f.name for f in
                                     dataclasses.fields(ModelConfig)}:
        raise RuntimeError(
            "the program's ModelConfig has no residual_projection option: it "
            f"cannot build this configuration's net (residual_projection="
            f"{want}); refused before any generation")
    if lrn is None:
        return
    for name, net in (("candidate", lrn.candidate), ("best", lrn.best)):
        have = {getattr(block, "proj", None) is not None
                for block in net.blocks}
        if have != {want}:
            raise RuntimeError(
                f"the program's {name} net has blocks with projection "
                f"{sorted(have)}; the configuration asks for {want}")


def _recipe(run) -> dict:
    with open(os.path.join(run.path(run.config["weights"]),
                           "seeded.json")) as fp:
        return json.load(fp)


def _leaves(tree: dict, prefix: str = ""):
    """(path, parent dict, key) of every array leaf, in sorted path order."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, path + "/")
        else:
            yield path, tree, key


def param_shapes(config: dict) -> dict:
    """The Flax-layout parameter tree of a configuration's identity-skip
    net, as shapes: conv kernels HWIO, dense kernels (in, out)."""
    m, c = config["model"], config["connect_n"]
    cells, filters = c["height"] * c["width"], m["filters"]

    def conv_block(kernel, cin, cout):
        return {"Conv_0": {"kernel": (kernel, kernel, cin, cout),
                           "bias": (cout,)},
                "BatchNorm_0": {"scale": (cout,), "bias": (cout,)}}

    tree = {"ConvBlock_0": conv_block(3, 4, filters),
            "ConvBlock_1": conv_block(1, filters, m["policy_filters"]),
            "ConvBlock_2": conv_block(1, filters, m["value_filters"]),
            "Dense_0": {"kernel": (cells * m["policy_filters"], c["width"]),
                        "bias": (c["width"],)},
            "Dense_1": {"kernel": (cells * m["value_filters"],
                                   m["value_hidden"]),
                        "bias": (m["value_hidden"],)},
            "Dense_2": {"kernel": (m["value_hidden"], 1), "bias": (1,)}}
    for i in range(m["depth"]):
        tree[f"ResidualBlock_{i}"] = {
            "ConvBlock_0": conv_block(3, filters, filters),
            "ConvBlock_1": conv_block(3, filters, filters)}
    return tree


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def _draw(rng, kind: str, shape, a: float, b: float = 0.0) -> np.ndarray:
    if kind == "uniform":
        return rng.uniform(a, b, shape)
    if kind == "normal":
        return rng.normal(a, b, shape)
    if kind == "fan_in_truncated_normal":
        # variance a / fan_in; the fan in is every axis but the last.
        out = rng.standard_normal(shape)
        bad = np.abs(out) > 2.0
        while bad.any():
            out[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(out) > 2.0
        fan_in = int(np.prod(shape[:-1]))
        return out * np.sqrt(a / fan_in) / TRUNCATED_STD
    raise ValueError(f"unknown draw {kind!r}")


def seeded_tree(run, seed: int) -> dict:
    """The train state dict (Flax layout, numpy) of the recipe's weights
    for ``seed``, made from the configuration's shapes alone: from
    ``numpy.random.default_rng([seed, stream])`` every parameter in sorted
    path order, by the recipe's ``draws`` for its module kind and leaf
    (``Conv/kernel``, ``BatchNorm/scale``, ...); then the running
    statistics, calibrated (``calibrate``); zero momentum."""
    recipe = _recipe(run)
    config = run.config["config"]
    rng = np.random.default_rng([seed % 2**64, int(recipe["stream"])])
    params = param_shapes(config)
    for path, parent, key in _leaves(params):
        kind = path.split("/")[-2].rsplit("_", 1)[0] + "/" + key
        if kind not in recipe["draws"]:
            raise KeyError(f"the recipe draws no {kind} ({path})")
        name, *args = recipe["draws"][kind]
        parent[key] = _draw(rng, name, parent[key], *args).astype(np.float32)
    stats: dict = {}
    for path, parent, key in _leaves(params):
        if path.endswith("BatchNorm_0/scale"):
            node = stats
            for part in path.split("/")[:-1]:
                node = node.setdefault(part, {})
            node["mean"] = np.zeros_like(parent[key])
            node["var"] = np.ones_like(parent[key])
    tree = {"params": params, "batch_stats": stats}
    calibrate(tree, config, recipe["calibration"], rng, run.device)
    steps = np.array(int(recipe["steps"]), np.int32)
    sgd = {"0": {"trace": _zeros_like(params)}, "1": {"count": steps}}
    tree["opt_state"] = ({"0": {}, "1": sgd}
                         if config["model"]["grad_clip_norm"] > 0 else sgd)
    tree["steps"] = steps
    return tree


def calibrate(tree: dict, config: dict, calibration: dict, rng,
              device) -> None:
    """Set each BatchNorm's running statistics of ``tree`` from its batch
    statistics over ``positions`` random legal positions (the reference's
    float32 train-mode forward): the mean shifted by ``mean_shift`` x N(0, 1)
    standard deviations, the biased variance scaled by U(``var_scale``),
    drawn in sorted path order."""
    c = config["connect_n"]
    boards = ref_search.connect4.random_positions(
        rng, int(calibration["positions"]), c["height"], c["width"], c["n"],
        int(calibration["max_plies"]))
    obs = torch.from_numpy(ref_search.connect4.observe(boards)).to(device)
    params = ref_net.to_device(ref_net.flatten(tree["params"]), device)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    common.strict_float32()
    batch: dict = {}
    with torch.no_grad():
        ref_net.forward(params, ref_net.to_device(
            ref_net.flatten(tree["batch_stats"]), device), obs,
            config["model"]["depth"], train=True, batch=batch)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved
    lo, hi = calibration["var_scale"]
    for path, parent, key in _leaves(tree["batch_stats"]):
        bn = path.rsplit("/", 1)[0]
        mean = batch[f"{bn}/mean"].double().cpu().numpy()
        var = batch[f"{bn}/var"].double().cpu().numpy()
        if key == "mean":
            out = mean + calibration["mean_shift"] * np.sqrt(var) * (
                rng.standard_normal(mean.shape))
        else:
            out = var * rng.uniform(lo, hi, var.shape)
        parent[key] = out.astype(np.float32)


def load_weights(run, lrn, seed: int):
    """Load the recipe's weights for ``seed`` into the candidate and
    promote them; returns the reference's (params, stats) on the run's
    device: the same tensors."""
    tree = seeded_tree(run, seed)
    lrn.load_train_state(tree)
    lrn.promote()
    params = ref_net.to_device(ref_net.flatten(tree["params"]), run.device)
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]),
                              run.device)
    return params, stats


def learner(run):
    """The Learner of the cell's configuration with the recipe's weights
    for the run's seed, and the reference's (params, stats)."""
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    refuse_other_net(run)
    lrn = Learner(run.program_config(), device=run.device)
    refuse_other_net(run, lrn)
    return lrn, load_weights(run, lrn, run.seed)


def setup(run):
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    lrn, (params, stats) = learner(run)
    replay = lrn.init_replay()
    with run.span("warmup_generation"):
        batch, _ = lrn.generate()
        replay = lrn.replay_add(replay, batch)
    del batch
    return SimpleNamespace(learner=lrn, replay=replay, gens=[], elapsed=0.0,
                           params=params, stats=stats)


def window(run, st):
    """``selfplay.window``, its traced bracket keeping the conv events."""
    bracket = run.bracket
    run.bracket = lambda keep=(): bracket(keep=tuple(keep) + ("conv_kernel",))
    try:
        selfplay.window(run, st)
    finally:
        del run.bracket


def replay_search(lrn, obs: np.ndarray):
    """The program's self-play search from the roots whose observations are
    ``obs`` (the search's batch), played again at the root noise its last
    search drew: its tree reset to those roots, then each wave on the card
    one replay of the captured CUDA graph that self-play replays (the step
    kernel, then the net into the search's buffers), elsewhere the same
    step and evaluator launched from the host; then the drain step.

    Returns, numpy, what each wave's step wrote and its net returned into
    the search's buffers: observations (S, B, H, W, 4), priors (S, B, A)
    and values (S, B); and the root visits (B, A)."""
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectNState

    cfg = lrn.cfg
    search = common.fused_search(lrn.selfplay)
    if search is None:
        raise RuntimeError("the program's self-play has no fused search")
    sims = cfg.mcts.simulations
    static = search._static[(obs.shape[0], sims)]
    buffers, geom = static.buffers, search.geometry(sims)
    device = buffers.obs.device
    board = torch.from_numpy(obs[..., 1] - obs[..., 2]).to(device,
                                                           torch.int8)
    stones = board != 0
    false = torch.zeros(obs.shape[0], dtype=torch.bool, device=device)
    search.reset(static, ConnectNState(
        board=board, heights=stones.sum(1, dtype=torch.int32),
        fullmove=stones.sum((1, 2), dtype=torch.int32), terminal=false,
        won=false))
    graph = None
    if device.type == "cuda":
        graph = static.graphs.get(lrn.evaluate_best)
        if graph is None:
            raise RuntimeError("self-play captured no graph of the best "
                               "net's evaluator")
    leaves = torch.empty((sims,) + tuple(buffers.obs.shape), device=device)
    priors = torch.empty((sims,) + tuple(buffers.probs.shape), device=device)
    values = torch.empty((sims, obs.shape[0]), device=device)
    for wave in range(sims):
        if graph is not None:
            graph.replay()
        else:
            search._wave_step(buffers, static.carry, geom)
            search._evaluate(static, lrn.evaluate_best)
        leaves[wave].copy_(buffers.obs)
        priors[wave].copy_(buffers.probs)
        values[wave].copy_(buffers.value[:, 0])
    search._wave_step(buffers, static.carry, geom)
    visits = search._root_stats(static.carry)[0]
    return tuple(t.cpu().numpy() for t in (leaves, priors, values, visits))


def search_faults(cfg, obs, gamma, waves) -> int:
    """Roots at which the reference search (``reference/search.py``), fed
    wave by wave the program's own priors and values of ``replay_search``
    (``waves``) at the same root noise, reaches other root visits than the
    program's search, or reads a leaf whose observation differs from the
    one the program's step wrote."""
    leaves, priors, values, visits = waves
    calls = iter(range(len(leaves)))
    diverged = np.zeros(len(obs), bool)

    def evaluate(leaf_obs: np.ndarray):
        wave = next(calls)
        np.logical_or(diverged, (leaf_obs != leaves[wave]).any(
            axis=(1, 2, 3)), out=diverged)
        return priors[wave], values[wave]

    fraction = cfg.mcts.dirichlet_fraction if cfg.mcts.use_dirichlet else 0.0
    reference = ref_search.search(
        ref_search.connect4.boards_from_obs(obs), evaluate,
        cfg.mcts.simulations, cfg.mcts.c_puct, cfg.connect_n.n,
        gamma if cfg.mcts.use_dirichlet else None, fraction)
    return int(((reference != visits).any(-1) | diverged).sum())


def forward_gaps(priors, value, ref_logits, ref_value):
    """(logit_gap, value_gap) of priors and values against the reference's
    logits and values."""
    priors, value, ref_logits, ref_value = (
        t.detach().double().cpu() for t in (priors, value, ref_logits,
                                            ref_value))
    ref_log = torch.log_softmax(ref_logits, dim=-1)
    centred = ref_logits - ref_logits.mean(dim=-1, keepdim=True)
    rms = float(centred.square().mean().sqrt())
    logit_gap = float((priors.log() - ref_log).abs().max()) / max(rms, 1e-30)
    return logit_gap, float((value - ref_value).abs().max())


def reference_forward(params, stats, depth, obs, quantize=None):
    with torch.no_grad():
        logits, value, _ = ref_net.forward(params, stats, obs, depth,
                                           quantize=quantize)
    return logits, value


def last_ply(lrn, batch):
    """(observations (B, H, W, 4), policy targets (B, A)) of the batch's
    last ply, numpy."""
    cfg = lrn.cfg
    h, w = cfg.connect_n.height, cfg.connect_n.width
    bsz = cfg.self_play.games_per_generation
    t_len = batch.valid.shape[0] // bsz
    obs = batch.obs.reshape(t_len, bsz, h, w, 4)[-1].cpu().numpy()
    pi = batch.policy.reshape(t_len, bsz, -1)[-1].cpu().numpy()
    return obs, pi


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
        n, kinds = checks.selfplay_faults(
            batch.obs.reshape(t_len, bsz, h, w, 4).cpu().numpy(),
            batch.policy.reshape(t_len, bsz, -1).cpu().numpy(),
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
    slots = (int(head) + np.arange(int(valid.sum()))) % st.replay.capacity
    ring = st.replay
    run.compare("ring_faults", checks.ring_faults(
        ring.obs.words.cpu().numpy(), ring.obs.scalars.cpu().numpy(),
        ring.policy.cpu().numpy(), ring.value.cpu().numpy(), slots,
        batch.obs[batch.valid].cpu().numpy(),
        batch.policy[batch.valid].cpu().numpy(),
        batch.value[batch.valid].cpu().numpy(), (h, w, 4),
        lrn.codec.binary_channels, lrn.codec.scalar_channels))

    obs, _ = last_ply(lrn, batch)
    search = common.fused_search(lrn.selfplay)
    gamma = search._static[(bsz, sims)].buffers.gamma.cpu().numpy()
    # The root noise is the program's own draw, which the reference takes
    # as it is: its mean is held to Gamma(alpha)'s, in standard errors.
    alpha = cfg.mcts.dirichlet_alpha
    run.compare("noise_mean_z", abs(float(gamma.astype(np.float64).mean())
                                    - alpha) / np.sqrt(alpha / gamma.size))

    # The last ply's search again through the program's own graph: its
    # tree against the reference's fed the same evaluations, and its first
    # wave's evaluation (of the roots) against the reference net's.
    waves = replay_search(lrn, obs)
    del st.gens[:-1]
    st.learner = None
    lrn = None
    if run.cuda:
        torch.cuda.empty_cache()
    run.compare("search_faults", search_faults(cfg, obs, gamma, waves))
    common.strict_float32()
    roots, priors, values = (torch.from_numpy(t[0]).to(run.device)
                             for t in waves[:3])
    logit_gap, value_gap = forward_gaps(priors, values, *reference_forward(
        st.params, st.stats, cfg.model.depth, roots))
    run.compare("logit_gap", logit_gap)
    run.compare("value_gap", value_gap)


def search_again(run, cfg, obs, pi, gamma, params, stats, quantize=None):
    """(reference visits, program visits) at a seeded sample of the last
    ply's roots that are not yet played greedily, the reference searching
    with the identity-skip reference net on ``params`` and ``stats``."""
    boards = ref_search.connect4.boards_from_obs(obs)
    plies = (boards != 0).sum(axis=(-1, -2))
    candidates = np.nonzero(plies < cfg.mcts.greedy_from_move)[0]
    rng = np.random.default_rng(run.seed % 2**64)
    k = min(int(run.traffic["search_roots"]), len(candidates))
    pick = np.sort(rng.choice(candidates, size=k, replace=False))
    sims = cfg.mcts.simulations
    program = np.round(pi[pick] * (sims - 1)).astype(np.int64)
    common.strict_float32()
    device = run.device

    def evaluate(batch_obs: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(batch_obs, np.float32))
        probs, values = ref_net.evaluate(params, stats, x.to(device),
                                         cfg.model.depth, quantize=quantize)
        return probs.cpu().numpy(), values.cpu().numpy()

    fraction = cfg.mcts.dirichlet_fraction if cfg.mcts.use_dirichlet else 0.0
    reference = ref_search.search(
        boards[pick], evaluate, sims, cfg.mcts.c_puct, cfg.connect_n.n,
        gamma[:, pick, :] if cfg.mcts.use_dirichlet else None, fraction)
    return reference, program


def close(st):
    st.learner = None
    st.gens = []


# ---------------------------------------------------------------------------
# The readings the limits are set from
# ---------------------------------------------------------------------------


def readings(root, bench, workload, seeds, device):
    """Per seed: the recipe's weights loaded in place into one Learner (its
    search graph captured once), a generation played, and the compared
    numbers of the program and of the float8 control."""
    def new_run(seed):
        return harness.Run(root, bench, workload, seed, 0.0, False, device,
                           time.perf_counter())

    run = new_run(seeds[0])
    lrn, _ = learner(run)
    cfg = lrn.cfg
    bsz, sims = cfg.self_play.games_per_generation, cfg.mcts.simulations
    for seed in seeds:
        run = new_run(seed)
        params, stats = load_weights(run, lrn, seed)
        lrn.generator.manual_seed(seed)
        batch, _ = lrn.generate()
        obs, pi = last_ply(lrn, batch)
        gamma = common.fused_search(lrn.selfplay)._static[
            (bsz, sims)].buffers.gamma.cpu().numpy()
        waves = replay_search(lrn, obs)
        faults = search_faults(cfg, obs, gamma, waves)
        rows, priors, values = (torch.from_numpy(t[0]).to(device)
                                for t in waves[:3])
        common.strict_float32()
        depth = cfg.model.depth
        ref = reference_forward(params, stats, depth, rows)
        low_logits, low_values = reference_forward(
            params, stats, depth, rows, ref_net.float8_rounding)
        ref_visits, prog_visits = search_again(run, cfg, obs, pi, gamma,
                                               params, stats)
        low_visits, _ = search_again(run, cfg, obs, pi, gamma, params, stats,
                                     ref_net.float8_rounding)
        out = {}
        for name, fwd, visits in (
                ("program", (priors, values), prog_visits),
                ("float8", (torch.softmax(low_logits, -1), low_values),
                 low_visits)):
            logit_gap, value_gap = forward_gaps(*fwd, *ref)
            out[name] = {"search_tv_mean": checks.visit_distance(
                visits, ref_visits), "logit_gap": logit_gap,
                "value_gap": value_gap}
        out["program"]["search_faults"] = faults
        yield seed, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m azbench.drivers.selfplay_seeded")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("selfplay_seeded: needs a CUDA device", file=sys.stderr)
        return 3
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, out in readings(root, bench, args.workload, seeds,
                              args.device):
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
