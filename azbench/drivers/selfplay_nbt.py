"""Self-play traffic on a nested-bottleneck net with global pooling (KataGo's
b18c384nbt) whose weights are made from the seed: ``selfplay_seeded``'s
window and check, with the nested-bottleneck reference
(``reference/net_nbt.py``) in the identity reference's place.

Set-up refuses, before it plays anything, a configuration without nested
bottleneck blocks (``model.mid_filters`` > 0) and a program that cannot
build them: one whose ``ModelConfig`` lacks ``mid_filters``,
``gpool_filters`` or ``gpool_blocks`` (its ``from_json`` drops the keys,
so it would build a tower of classic blocks), or whose built net's blocks
are not nested bottlenecks pooled where the configuration pools. It then
builds the Learner from the configuration with ``--seed``, draws the
weights by the recipe (``seeded_tree``: ``selfplay_seeded``'s draws in the
Flax layout, by module kind and leaf), loads them through the program's
converter, promotes them and plays one generation (the search's CUDA graph
is captured there). ``--trace 1`` also keeps the traced generation's
``conv_kernel`` and ``gpool_kernel`` events.

The check: ``selfplay_faults``, ``ring_faults``, ``noise_mean_z``,
``search_faults`` and ``logit_gap`` as ``selfplay_seeded`` reads them, the
gap against the float32 nested-bottleneck reference. ``value_gap`` is
read but not compared: over the limits' seeds the reference itself,
rounded to bfloat16 where the fused forward rounds, reads value gaps up to
0.223 (a max over 256 roots), within a fifth of the float8 control's
smallest (0.265), so no limit has room on both sides; the logit gap alone
fails every control on every seed (PERF.md, section 2).

The readings that the limits are set from, on the card at the cell's size:

    python3 -m azbench.drivers.selfplay_nbt --workload <cell> --seeds 1,2,3

prints one JSON line a seed with the compared numbers of the program
(``program``), of the reference rounded to the configuration's bfloat16
wherever the fused forward rounds (``bfloat16``: where a sound run sits),
and of three controls in its place, each against the float32 reference:
``float8``, the reference one precision below the configuration's
bfloat16, its every conv and dense operand and every stored activation,
the skip streams included, rounded to float8 (``net.float8_rounding``);
``no_gpool``, the reference on the same weights with the pooled biases
left out; and ``no_inner_skip``, the same with the inner residual adds
left out; beside them ``search_tv_mean``, which the check leaves out
(``selfplay_seeded`` says why).
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
from azbench.drivers import selfplay_seeded as seeded
from azbench.reference import net_nbt as ref_net
from azbench.reference import search as ref_search

GPOOL = "GlobalPoolBias_0"
OPTIONS = ("mid_filters", "gpool_filters", "gpool_blocks")
# (name, quantize, gpool, inner_skip) of the readings' controls, each to
# fail a limit on every seed.
CONTROLS = (("float8", ref_net.float8_rounding, True, True),
            ("no_gpool", None, False, True),
            ("no_inner_skip", None, True, False))
# The same of the reading that places a sound run: the reference rounded
# to bfloat16 where the fused forward rounds.
BFLOAT16 = ("bfloat16", ref_net.bfloat16_rounding, True, True)


def refuse_other_net(run, lrn=None) -> None:
    """Raise unless the configuration has nested bottleneck blocks and the
    program builds them: its ``ModelConfig`` has ``mid_filters``,
    ``gpool_filters`` and ``gpool_blocks`` and (given a Learner) every
    block of its nets is a nested bottleneck, its first inner block pooled
    exactly where the configuration's ``gpool_blocks`` (numbered from 1)
    say."""
    from custom_alphazero_tpu_torch.config import ModelConfig

    model = run.config["config"]["model"]
    if not model.get("mid_filters", 0):
        raise ValueError(
            "selfplay_nbt compares nested-bottleneck nets: the configuration "
            f"asks for model.mid_filters={model.get('mid_filters', 0)}")
    missing = sorted(set(OPTIONS) - {f.name for f in
                                     dataclasses.fields(ModelConfig)})
    if missing:
        raise RuntimeError(
            f"the program's ModelConfig has no {', '.join(missing)} option: "
            "it cannot build this configuration's nested-bottleneck tower; "
            "refused before any generation")
    if lrn is None:
        return
    want = [i + 1 in model.get("gpool_blocks", ())
            for i in range(model["depth"])]
    for name, net in (("candidate", lrn.candidate), ("best", lrn.best)):
        have = [getattr(block.inner[0], "gpool", None) is not None
                if hasattr(block, "inner") and hasattr(block, "pre")
                else None for block in net.blocks]
        if have != want:
            raise RuntimeError(
                f"the program's {name} net has blocks pooled {have} (None: "
                "not a nested bottleneck); the configuration asks for nested "
                f"bottleneck blocks pooled {want}")


def param_shapes(config: dict) -> dict:
    """The Flax-layout parameter tree of a configuration's nested-bottleneck
    net, as shapes: ``selfplay_seeded.param_shapes``'s stem and heads, the
    trunk's final norm (BatchNorm_0) and each NestedBottleneckBlock_i (see
    custom_alphazero_tpu_torch/models/convert.py for the names)."""
    tree = {k: v for k, v in seeded.param_shapes(config).items()
            if not k.startswith("ResidualBlock_")}
    m = config["model"]
    filters, mid, pooled = m["filters"], m["mid_filters"], m["gpool_filters"]

    def norm_conv(kernel, cin, cout):
        return {"BatchNorm_0": {"scale": (cin,), "bias": (cin,)},
                "Conv_0": {"kernel": (kernel, kernel, cin, cout),
                           "bias": (cout,)}}

    tree["BatchNorm_0"] = {"scale": (filters,), "bias": (filters,)}
    for i in range(m["depth"]):
        regular = mid - pooled if i + 1 in m["gpool_blocks"] else mid
        first = {"NormConv_0": norm_conv(3, mid, regular),
                 "NormConv_1": norm_conv(3, regular, mid)}
        if regular != mid:
            first[GPOOL] = {
                "Conv_0": {"kernel": (3, 3, mid, pooled), "bias": (pooled,)},
                "BatchNorm_0": {"scale": (pooled,), "bias": (pooled,)},
                "Dense_0": {"kernel": (3 * pooled, regular)}}
        tree[f"NestedBottleneckBlock_{i}"] = {
            "NormConv_0": norm_conv(1, filters, mid),
            "InnerBlock_0": first,
            "InnerBlock_1": {"NormConv_0": norm_conv(3, mid, mid),
                             "NormConv_1": norm_conv(3, mid, mid)},
            "NormConv_1": norm_conv(1, mid, filters)}
    return tree


def seeded_tree(run, seed: int) -> dict:
    """The train state dict (Flax layout, numpy) of the recipe's weights
    for ``seed``, as ``selfplay_seeded.seeded_tree`` makes it from this
    configuration's shapes (``param_shapes``), the running statistics
    calibrated through the nested-bottleneck reference."""
    recipe = seeded._recipe(run)
    config = run.config["config"]
    rng = np.random.default_rng([seed % 2**64, int(recipe["stream"])])
    params = param_shapes(config)
    for path, parent, key in seeded._leaves(params):
        kind = path.split("/")[-2].rsplit("_", 1)[0] + "/" + key
        if kind not in recipe["draws"]:
            raise KeyError(f"the recipe draws no {kind} ({path})")
        name, *args = recipe["draws"][kind]
        parent[key] = seeded._draw(rng, name, parent[key],
                                   *args).astype(np.float32)
    stats: dict = {}
    for path, parent, key in seeded._leaves(params):
        if path.endswith("BatchNorm_0/scale"):
            node = stats
            for part in path.split("/")[:-1]:
                node = node.setdefault(part, {})
            node["mean"] = np.zeros_like(parent[key])
            node["var"] = np.ones_like(parent[key])
    tree = {"params": params, "batch_stats": stats}
    calibrate(tree, config, recipe["calibration"], rng, run.device)
    steps = np.array(int(recipe["steps"]), np.int32)
    sgd = {"0": {"trace": seeded._zeros_like(params)}, "1": {"count": steps}}
    tree["opt_state"] = ({"0": {}, "1": sgd}
                         if config["model"]["grad_clip_norm"] > 0 else sgd)
    tree["steps"] = steps
    return tree


def calibrate(tree: dict, config: dict, calibration: dict, rng,
              device) -> None:
    """``selfplay_seeded.calibrate`` through the nested-bottleneck
    reference's float32 train-mode forward."""
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
    for path, parent, key in seeded._leaves(tree["batch_stats"]):
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
    device."""
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
    """``selfplay.window``, its traced bracket keeping the conv and pooled
    bias events."""
    bracket = run.bracket
    run.bracket = lambda keep=(): bracket(
        keep=tuple(keep) + ("conv_kernel", "gpool_kernel"))
    try:
        selfplay.window(run, st)
    finally:
        del run.bracket


def reference_forward(params, stats, depth, obs, quantize=None, gpool=True,
                      inner_skip=True):
    with torch.no_grad():
        logits, value, _ = ref_net.forward(params, stats, obs, depth,
                                           quantize=quantize, gpool=gpool,
                                           inner_skip=inner_skip)
    return logits, value


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

    obs, _ = seeded.last_ply(lrn, batch)
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
    waves = seeded.replay_search(lrn, obs)
    del st.gens[:-1]
    st.learner = None
    lrn = None
    if run.cuda:
        torch.cuda.empty_cache()
    run.compare("search_faults", seeded.search_faults(cfg, obs, gamma, waves))
    common.strict_float32()
    roots, priors, values = (torch.from_numpy(t[0]).to(run.device)
                             for t in waves[:3])
    logit_gap, value_gap = seeded.forward_gaps(
        priors, values, *reference_forward(st.params, st.stats,
                                           cfg.model.depth, roots))
    run.compare("logit_gap", logit_gap)
    run.values["value_gap"] = value_gap


def search_again(run, cfg, obs, pi, gamma, params, stats, quantize=None,
                 gpool=True, inner_skip=True):
    """``selfplay_seeded.search_again`` with the nested-bottleneck reference
    net (``gpool`` or ``inner_skip`` False: those controls)."""
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
                                         cfg.model.depth, quantize=quantize,
                                         gpool=gpool, inner_skip=inner_skip)
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
    numbers of the program, of the bfloat16 reading (``BFLOAT16``) and of
    the three controls (``CONTROLS``)."""
    def new_run(seed):
        return harness.Run(root, bench, workload, seed, 0.0, False, device,
                           time.perf_counter())

    run = new_run(seeds[0])
    lrn, _ = learner(run)
    cfg = lrn.cfg
    bsz, sims = cfg.self_play.games_per_generation, cfg.mcts.simulations
    depth = cfg.model.depth
    for seed in seeds:
        run = new_run(seed)
        params, stats = load_weights(run, lrn, seed)
        lrn.generator.manual_seed(seed)
        batch, _ = lrn.generate()
        obs, pi = seeded.last_ply(lrn, batch)
        gamma = common.fused_search(lrn.selfplay)._static[
            (bsz, sims)].buffers.gamma.cpu().numpy()
        waves = seeded.replay_search(lrn, obs)
        faults = seeded.search_faults(cfg, obs, gamma, waves)
        rows, priors, values = (torch.from_numpy(t[0]).to(device)
                                for t in waves[:3])
        common.strict_float32()
        ref = reference_forward(params, stats, depth, rows)
        ref_visits, prog_visits = search_again(run, cfg, obs, pi, gamma,
                                               params, stats)
        out = {"program": {"search_tv_mean": checks.visit_distance(
            prog_visits, ref_visits)}}
        out["program"]["logit_gap"], out["program"]["value_gap"] = (
            seeded.forward_gaps(priors, values, *ref))
        for name, quantize, gpool, inner_skip in (BFLOAT16,) + CONTROLS:
            logits, low_values = reference_forward(
                params, stats, depth, rows, quantize, gpool, inner_skip)
            visits, _ = search_again(run, cfg, obs, pi, gamma, params, stats,
                                     quantize, gpool, inner_skip)
            logit_gap, value_gap = seeded.forward_gaps(
                torch.softmax(logits, -1), low_values, *ref)
            out[name] = {"search_tv_mean": checks.visit_distance(
                visits, ref_visits), "logit_gap": logit_gap,
                "value_gap": value_gap}
        out["program"]["search_faults"] = faults
        yield seed, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m azbench.drivers.selfplay_nbt")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("selfplay_nbt: needs a CUDA device", file=sys.stderr)
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
