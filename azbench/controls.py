"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size (not run by the benchmark's own runs):

    python3 -m azbench.controls --workload <cell> --seeds 1,2,3

For each seed it drives the cell's timed path as a run does and prints one
JSON line with the compared numbers of

- ``program``: the program against the float32 reference (the sound
  reading);
- ``float8``: the precision control, the reference computed one precision
  below the configuration's bfloat16 (``reference.net.float8_rounding``)
  put in the program's place, against the float32 reference;
- ``half_batch`` (train cells): the reference put in the program's place
  with half of each batch left out and the mean taken over the rest.

A train cell's 'state left unchanged' fault reads 1 by construction (no
change against the reference's) and is not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from azbench import checks, harness
from azbench.drivers import common, selfplay, train
from azbench.reference import net as ref_net


def _run(root, bench, workload, seed, device):
    return harness.Run(root, bench, workload, seed, 0.0, False, device,
                       time.perf_counter())


def selfplay_readings(root, bench, workload, seeds, device):
    run = _run(root, bench, workload, seeds[0], device)
    lrn = common.learner(run)
    lrn.generate()  # the capture
    cfg = lrn.cfg
    bsz, sims = cfg.self_play.games_per_generation, cfg.mcts.simulations
    h, w = cfg.connect_n.height, cfg.connect_n.width
    search = common.fused_search(lrn.selfplay)
    for seed in seeds:
        run = _run(root, bench, workload, seed, device)
        lrn.generator.manual_seed(seed)
        batch, _ = lrn.generate()
        t_len = batch.valid.shape[0] // bsz
        obs = batch.obs.reshape(t_len, bsz, h, w, 4)[-1].cpu().numpy()
        pi = batch.policy.reshape(t_len, bsz, -1)[-1].cpu().numpy()
        gamma = search._static[(bsz, sims)].buffers.gamma.cpu().numpy()
        ref, prog = selfplay.search_again(run, cfg, obs, pi, gamma)
        low, _ = selfplay.search_again(run, cfg, obs, pi, gamma,
                                       ref_net.float8_rounding)
        yield seed, {"program": {"search_tv_mean":
                                 checks.visit_distance(prog, ref)},
                     "float8": {"search_tv_mean":
                                checks.visit_distance(low, ref)}}


def train_readings(root, bench, workload, seeds, device):
    for seed in seeds:
        yield seed, _train_readings(root, bench, workload, seed, device)
        # A witness beside the sound reading: the same path with the
        # program's net in float32 (TF32 off) on the same seed.
        run = _run(root, bench, workload, seed, device)
        run.config["config"]["model"]["compute_dtype"] = "float32"
        common.strict_float32()
        yield seed, {"program_float32": _train_readings(
            root, bench, workload, seed, device, run)["program"]}


def _train_readings(root, bench, workload, seed, device, run=None):
    run = run or _run(root, bench, workload, seed, device)
    st = train.setup(run)
    cfg = st.learner.cfg
    ring = st.replay
    size = int(ring.size)
    codec = st.learner.codec
    decoded = train.ref_codec.decode(
        ring.obs.words[:size].cpu().numpy(),
        ring.obs.scalars[:size].cpu().numpy(),
        tuple(st.learner.env.obs_shape), codec.binary_channels,
        codec.scalar_channels)
    policy = ring.policy[:size].cpu().numpy()
    value = ring.value[:size].cpu().numpy()
    index = {train._row_key(decoded[i], policy[i], value[i]): i
             for i in range(size)}
    batches = []
    for rec in st.records:
        obs, pi, z = (t.cpu().numpy() for t in (rec.obs, rec.pi, rec.z))
        rows = np.array([index[train._row_key(obs[i], pi[i], z[i])]
                         for i in range(len(z))])
        batches.append((decoded[rows], policy[rows], value[rows]))
    states = [r.gen_state for r in st.records]
    losses = [float(r.loss) for r in st.records]
    momentum_1, params_after = st.momentum_1, st.params_after
    train.close(st)
    torch.cuda.empty_cache()
    common.strict_float32()
    ref = train.follow(run, cfg, batches, states, device)
    out = {"program": train.judge(losses, momentum_1, params_after, ref,
                                  cfg.model.momentum)}
    for name, kwargs in (("float8",
                          {"quantize": ref_net.float8_rounding}),
                         ("half_batch", {"half": True})):
        other = train.follow(run, cfg, batches, states, device, **kwargs)
        m1 = {k: other.grads_1[k] + cfg.model.momentum
              * other.momentum_0[k] for k in other.grads_1}
        out[name] = train.judge(other.losses, m1, other.end, ref,
                                cfg.model.momentum)
    return out


READERS = {"selfplay": selfplay_readings, "train": train_readings}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m azbench.controls")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("azbench.controls: needs a CUDA device", file=sys.stderr)
        return 3
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    seeds = [int(s) for s in args.seeds.split(",")]
    run = _run(root, bench, args.workload, seeds[0], "cuda")
    readings = READERS[run.traffic["driver"]]
    for seed, out in readings(root, bench, args.workload, seeds, "cuda"):
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
