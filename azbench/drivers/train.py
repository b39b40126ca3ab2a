"""Training traffic: ``Learner.replay_sample`` then ``Learner.train_step``,
back to back, as the training loop's inner loop runs them.

Set-up builds the Learner with the configuration's weights (parameters,
running statistics, momentum and step count), fills the ring with one
self-play generation of the configuration, and drives the train step from
there through its first ``recorded_steps`` steps by the window's own calls,
keeping what the check needs: each step's sampled rows and loss, the state
of the generator that draws the auxiliary rows, the momentum after the
first step and the parameters after the last. ``warmup_steps`` more steps
follow. The window then runs steps until ``--seconds`` have passed; the rate
counts ``model.batch_size`` replay rows a step (auxiliary rows not counted)
over the time to the last ``torch.cuda.synchronize()``. ``--trace 1``
profiles the window's first ``trace_steps`` steps and then times
``trace_steps`` samples on their own.

The check follows the recorded steps with the reference from the same
checkpoint file: the sampled rows must be rows of the ring as the reference
decodes it; then three reference SGD steps on those rows give each step's
loss, the first gradient and the parameters' change, held to the program's.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from azbench import checks
from azbench.drivers import common
from azbench.reference import codec as ref_codec
from azbench.reference import net as ref_net


def _flax_state(lrn):
    """(params, momentum) of the program's candidate in Flax's layout,
    flat: host copies made by the program's own converter."""
    from custom_alphazero_tpu_torch.models.convert import train_state_to_jax

    tree = train_state_to_jax(lrn.train_state, lrn.cfg.model)
    opt = tree["opt_state"]
    sgd = opt if "trace" in opt["0"] else opt["1"]
    return (ref_net.flatten(tree["params"]),
            ref_net.flatten(sgd["0"]["trace"]))


def setup(run):
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    lrn = common.learner(run)
    replay = lrn.init_replay()
    with run.span("fill_generation"):
        batch, _ = lrn.generate()
        replay = lrn.replay_add(replay, batch)
    del batch
    records = []
    momentum_1 = None
    for i in range(int(run.traffic["recorded_steps"])):
        obs, pi, z = lrn.replay_sample(replay)
        gen_state = lrn.aux_generator.get_state()
        metrics = lrn.train_step(obs, pi, z)
        records.append(SimpleNamespace(obs=obs, pi=pi, z=z,
                                       gen_state=gen_state,
                                       loss=metrics.loss))
        if i == 0:
            momentum_1 = _flax_state(lrn)[1]
    params_after = _flax_state(lrn)[0]
    for _ in range(int(run.traffic["warmup_steps"])):
        obs, pi, z = lrn.replay_sample(replay)
        lrn.train_step(obs, pi, z)
    return SimpleNamespace(learner=lrn, replay=replay, records=records,
                           momentum_1=momentum_1, params_after=params_after,
                           steps=0)


def window(run, st):
    lrn = st.learner
    trace_steps = int(run.traffic["trace_steps"])
    if run.trace:
        # A profiled bracket of whole steps, then the sample on its own.
        with run.bracket():
            for _ in range(trace_steps):
                obs, pi, z = lrn.replay_sample(st.replay)
                lrn.train_step(obs, pi, z)
        run.values["bracket_steps"] = trace_steps
        for _ in range(trace_steps):
            with run.span("replay_sample"):
                lrn.replay_sample(st.replay)
    t0 = time.perf_counter()
    steps = 0
    while True:
        obs, pi, z = lrn.replay_sample(st.replay)
        lrn.train_step(obs, pi, z)
        steps += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    elapsed = time.perf_counter() - t0
    st.steps = steps
    run.attempted = steps
    run.metrics["train_samples_per_s"] = (
        steps * lrn.cfg.model.batch_size / elapsed)


def check(run, st):
    cfg = st.learner.cfg
    device = run.device
    ring = st.replay
    size = int(ring.size)
    shape = tuple(st.learner.env.obs_shape)
    codec = st.learner.codec
    words = ring.obs.words[:size].cpu().numpy()
    scalars = ring.obs.scalars[:size].cpu().numpy()
    policy = ring.policy[:size].cpu().numpy()
    value = ring.value[:size].cpu().numpy()
    records = st.records
    st.learner = None
    st.replay = None
    if run.cuda:
        torch.cuda.empty_cache()
    decoded = ref_codec.decode(words, scalars, shape, codec.binary_channels,
                               codec.scalar_channels)
    index = {_row_key(decoded[i], policy[i], value[i]): i
             for i in range(size)}
    missing = 0
    batches = []
    for rec in records:
        obs, pi, z = (t.cpu().numpy() for t in (rec.obs, rec.pi, rec.z))
        rows = [index.get(_row_key(obs[i], pi[i], z[i]), -1)
                for i in range(len(z))]
        missing += sum(r < 0 for r in rows)
        rows = np.array([max(r, 0) for r in rows])
        batches.append((decoded[rows], policy[rows], value[rows]))
    run.compare("batch_faults", missing)

    common.strict_float32()
    ref = follow(run, cfg, batches, [r.gen_state for r in records], device)
    prog_loss = [float(r.loss) for r in records]
    numbers = judge(prog_loss, st.momentum_1, st.params_after, ref,
                    cfg.model.momentum)
    for name in COMPARED:
        run.compare(name, numbers[name])
    print(f"train check: {numbers}", flush=True)


# The worst leaf's gaps are printed, not compared: in sound bf16 runs they
# come from a few small leaves whose gradient through the training forward
# cancels under BatchNorm (PERF.md, the train cell's limits).
COMPARED = ("loss_gap", "grad_gap_median", "change_gap_median")


def _row_key(obs, pi, z) -> bytes:
    return (np.ascontiguousarray(obs, np.float32).tobytes()
            + np.ascontiguousarray(pi, np.float32).tobytes()
            + np.float32(z).tobytes())


def follow(run, cfg, batches, gen_states, device, quantize=None,
           half=False):
    """The reference's steps from the checkpoint file on ``batches`` (host
    arrays): losses per step, the first step's gradient, the initial
    momentum and parameters, and the parameters after the last step.
    ``quantize`` and ``half``: the precision control and the half-batch
    fault, put in the program's place."""
    params, stats, trace, steps = common.reference_weights(run, device)
    start = {k: v.cpu().numpy() for k, v in params.items()}
    momentum_0 = {k: v.cpu().numpy() for k, v in trace.items()}
    labels = np.load(run.path(cfg.loop.solver_labels_path)) if (
        cfg.loop.solver_labels_path) else None
    aux_obs = aux_z = None
    if labels is not None:
        aux_obs = torch.from_numpy(labels["obs"].astype(np.float32)).to(device)
        aux_z = torch.from_numpy(labels["z"].astype(np.float32)).to(device)
    m = cfg.model
    losses, grads_1 = [], None
    for i, (obs, pi, z) in enumerate(batches):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in (obs, pi, z)]
        if half:
            tensors = [ref_net.half_batch(t) for t in tensors]
        a_obs = a_z = None
        if aux_obs is not None:
            # The auxiliary rows: the draw the program makes, from the state
            # its generator had before the step.
            gen = torch.Generator(device=device)
            gen.set_state(gen_states[i])
            n = aux_obs.shape[0]
            rows = torch.randint(0, n, (min(n, cfg.loop.solver_value_batch),),
                                 generator=gen, device=device)
            a_obs, a_z = aux_obs[rows], aux_z[rows]
        lr = ref_net.learning_rate(m.lr_values, m.lr_boundaries, steps + i)
        params, new_stats, trace, loss, grads = ref_net.sgd_step(
            params, stats, trace, *tensors, a_obs, a_z, m.depth, m.l2,
            cfg.loop.solver_value_weight, lr, m.momentum, quantize)
        stats.update(new_stats)
        losses.append(loss["loss"])
        if i == 0:
            grads_1 = {k: v.cpu().numpy() for k, v in grads.items()}
    end = {k: v.cpu().numpy() for k, v in params.items()}
    return SimpleNamespace(losses=losses, grads_1=grads_1, start=start,
                           end=end, momentum_0=momentum_0)


def judge(losses, momentum_1, params_after, ref, momentum) -> dict:
    """The numbers of a run of recorded steps against the reference's: the
    worst step's relative loss gap; per leaf, the gap of the first
    gradient's norm (the program's from its momentum: m1 - momentum * m0)
    and of the parameters' change over the steps, leaving out of the change
    the leaves whose reference gradient is under a thousandth of the median
    leaf's; of each, the worst leaf's gap (and its name) and the median
    leaf's gap."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(losses, ref.losses))
    leaves = sorted(ref.grads_1)
    grad_prog = {k: momentum_1[k] - momentum * ref.momentum_0[k]
                 for k in leaves}
    grad = checks.norm_gaps(grad_prog, ref.grads_1, leaves)
    norms = {k: float(np.linalg.norm(ref.grads_1[k])) for k in leaves}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moved = [k for k in leaves if norms[k] >= floor]
    change = checks.norm_gaps({k: params_after[k] - ref.start[k]
                               for k in moved},
                              {k: ref.end[k] - ref.start[k] for k in moved},
                              moved)
    out = {"loss_gap": loss_gap, "left_out_leaves": len(leaves) - len(moved)}
    for name, gaps in (("grad_gap", grad), ("change_gap", change)):
        worst = max(gaps, key=gaps.get)
        out[name + "_worst"] = gaps[worst]
        out[name + "_worst_leaf"] = worst
        out[name + "_median"] = float(np.median(list(gaps.values())))
    return out


def close(st):
    st.learner = None
    st.replay = None
