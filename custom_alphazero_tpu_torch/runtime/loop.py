"""The actor-learner loop on one card (the port of runtime/loop.py).

  per generation:
    1. self-play a lockstep batch of games with the *best* net;
    2. push the samples into the device-resident replay ring;
    3. run K training iterations on the *candidate* net; every
       ``checkpoint_frequency`` iterations checkpoint, every
       ``evaluation_frequency`` iterations run the arena and promote the
       candidate to best on a score at or above the threshold; with
       ``arena.evaluate_with_solver`` the arena's candidate moves are then
       scored by the exact solver on the host, and
       ``arena.solver_score_veto`` blocks a promotion whose solver score
       falls below the reigning best's by more than the margin;
    4. every ``visualize_frequency`` generations, render one search tree.

Run:  python -m custom_alphazero_tpu_torch.runtime.loop --mcts.simulations=64 ...
      torchrun --nproc_per_node=N -m custom_alphazero_tpu_torch.runtime.loop ...

With N ranks (parallel/distributed.py) every rank runs this same loop over
a (data, model) mesh (parallel/mesh.py): each plays its share of the games
into a ring of its own, trains on its share of every batch (gradients and
BatchNorm statistics summed over the data group), and plays its share of
the arena (parallel/sharded.py). Host I/O (directories, ``config.json``,
metrics, sample archives, checkpoints, renders, solver scoring, printed
lines) happens on the coordinator only; every rank reads every scalar the
loop reads, and the STOP file and the solver veto are the coordinator's,
agreed through ``broadcast_flag``.

The overrides, printed lines, metric tags, directory layout, resume and STOP
file are the JAX loop's. What differs by design:

- the best net is a module of its own, always in eval mode; a promotion
  copies the candidate's weights and running statistics into it in place,
  so the CUDA graph that the self-play search captured over it stays valid;
- one ``torch.Generator`` on the device, seeded from ``run.seed``, feeds
  generation, replay sampling, auxiliary sampling and the arena, in the
  loop's order (the random streams are torch's, not JAX's); a tree render
  draws its root noise from a generator of its own, seeded from the
  generation's index;
- the device is read once per generation for the stats, once for the ring's
  size, and once per train step for the loss terms;
- with several ranks, the generator of the rank at data index d > 0 is
  re-seeded ``run.seed + RANK_SEED_STRIDE * d`` after the (common) weight
  initialisation, where JAX splits one key into a key per shard; the
  auxiliary rows come from a generator seeded alike on every rank, so every
  rank draws JAX's one subset; a rank outside a mesh clamped below the
  world raises ``ValueError`` (JAX leaves such devices idle in its one
  process).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import (
    Config,
    apply_overrides,
    parse_cli_overrides,
    resolve_device,
    to_json,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.io import trace
from custom_alphazero_tpu_torch.io.checkpoint import (
    checkpoint_exists,
    latest_evaluation_iteration,
    load_checkpoint,
    load_replay,
    save_checkpoint,
    save_checkpoint_async,
)
from custom_alphazero_tpu_torch.io.metrics import MetricsWriter
from custom_alphazero_tpu_torch.models.convert import (
    load_jax_variables,
    to_jax_variables,
    trace_from_jax,
    train_state_to_jax,
)
from custom_alphazero_tpu_torch.models.losses import learning_rate
from custom_alphazero_tpu_torch.models.policy_value import data_parallel
from custom_alphazero_tpu_torch.parallel import distributed, sharded
from custom_alphazero_tpu_torch.parallel.mesh import (
    Mesh,
    full_tensors,
    load_full,
    make_mesh,
    shard_params,
)
from custom_alphazero_tpu_torch.replay.buffer import (
    replay_add,
    replay_from_state_dict,
    replay_init,
    replay_sample,
    replay_state_dict,
)
from custom_alphazero_tpu_torch.replay.codec import (
    PackedObs,
    TopKPolicyCodec,
    codec_for_env,
)
from custom_alphazero_tpu_torch.runtime.arena import make_arena_fn
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn
from custom_alphazero_tpu_torch.runtime.train import (
    TrainState,
    init_train_state,
    make_train_step,
)
from custom_alphazero_tpu_torch.runtime.watchdog import (
    CompileGraceToucher,
    Heartbeat,
    start_watchdog,
    touch_liveness_file,
)
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools import strength
from custom_alphazero_tpu_torch.tools.visualize import save_tree


def max_game_plies(cfg: Config) -> int:
    if cfg.self_play.max_plies:
        return cfg.self_play.max_plies
    if cfg.game == "connect_n":
        return cfg.connect_n.width * cfg.connect_n.height
    return 512  # chess ply cap: truncated games score as draws


def make_env(cfg: Config):
    if cfg.game == "connect_n":
        return ConnectN(cfg.connect_n)
    if cfg.game == "chess":
        return Chess(cfg.chess)
    raise ValueError(f"Unknown game {cfg.game!r}")


# Seeds of the per-rank random streams: data index d > 0 is re-seeded
# run.seed + RANK_SEED_STRIDE * d; the auxiliary stream run.seed +
# AUX_SEED_OFFSET on every rank.
RANK_SEED_STRIDE = 0x9E3779B1
AUX_SEED_OFFSET = 0x5DEECE66D


def _auto_data_parallelism(cfg: Config, available: int) -> int:
    """Largest data-axis size <= ``available`` that divides the workload:
    games per generation, train batch and replay capacity. The arena does
    not constrain it (an indivisible ``arena.games`` rounds its per-shard
    count up instead). An explicit ``mesh.data_parallelism`` bypasses this
    and lets the sharded builders raise on indivisible sizes."""
    dp = math.gcd(max(available, 1), cfg.self_play.games_per_generation)
    dp = math.gcd(dp, cfg.model.batch_size)
    dp = math.gcd(dp, cfg.replay.capacity)
    return max(dp, 1)


def learner_mesh(cfg: Config) -> Mesh:
    """The run's mesh over the process group's ranks (one rank without a
    process group), ``mesh.data_parallelism = 0`` taking every rank that
    divides the workload. A rank outside the mesh raises."""
    world = distributed.world_size()
    mesh_cfg = cfg.mesh
    if not mesh_cfg.data_parallelism:  # 0 = auto (all ranks that fit)
        mp = max(mesh_cfg.model_parallelism, 1)
        auto_dp = _auto_data_parallelism(cfg, world // mp)
        mesh_cfg = dataclasses.replace(mesh_cfg, data_parallelism=auto_dp)
        if auto_dp * mp < world and distributed.is_coordinator():
            print(
                f"mesh: data axis clamped to {auto_dp} (of "
                f"{world} devices) to divide the workload; set "
                "mesh.data_parallelism or pick divisible sizes to use "
                "every device"
            )
    mesh = make_mesh(mesh_cfg, world)
    if not mesh.member:
        raise ValueError(
            f"rank {mesh.rank} is outside the {mesh.dp}x{mesh.mp} mesh of "
            f"{world} ranks (the data axis was clamped to {mesh.dp} to "
            "divide the workload, or set by mesh.data_parallelism): start "
            f"{mesh.size} ranks"
        )
    return mesh


class Learner:
    """The programs and the nets of one training run on one rank.

    ``train_state.net`` is the candidate: the module that trains (with its
    dense layers column-sharded at mp > 1). ``candidate`` is the net the
    arena plays as the candidate: the training net itself, or at mp > 1 a
    full-size copy refreshed from the shards before each use. ``best`` is
    the net that self-play searches with, always full-size. All keep their
    memory for the life of the learner: a checkpoint is loaded into them,
    and a promotion copied, in place."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.mesh = learner_mesh(cfg)
        self.dp, self.mp = self.mesh.dp, self.mesh.mp
        self.device = resolve_device(device)
        self.env = make_env(cfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.run.seed)
        max_plies = max_game_plies(cfg)

        self.codec = (
            codec_for_env(self.env) if cfg.replay.compress_obs else None
        )
        self.policy_codec = (
            TopKPolicyCodec(self.env.num_actions, cfg.replay.policy_topk)
            if cfg.replay.policy_topk else None
        )
        # Large observations are bit-packed ply by ply inside the
        # generation, so the raw T*B sample buffer never exists; small ones
        # (Connect-4: 672 B) keep the raw path.
        obs_codec = (
            self.codec
            if self.codec is not None
            and int(np.prod(self.env.obs_shape)) >= 2048
            else None
        )
        self.selfplay = make_selfplay_fn(
            self.env, cfg.mcts, cfg.self_play, max_plies, device=self.device,
            obs_codec=obs_codec,
        )
        self.arena = make_arena_fn(self.env, cfg.arena, cfg.mcts, max_plies,
                                   device=self.device)
        if self.dp > 1:
            # JAX's checks: each rank holds capacity // dp rows of the ring
            # and serves batch_size // dp rows of every batch.
            if cfg.replay.capacity % self.dp:
                raise ValueError(f"replay capacity {cfg.replay.capacity} "
                                 f"not divisible by {self.dp}")
            if cfg.model.batch_size % self.dp:
                raise ValueError(f"batch_size={cfg.model.batch_size} not "
                                 f"divisible by data axis {self.dp}")
            self.sharded_generate = sharded.make_sharded_generate(
                self.selfplay, self.mesh,
                cfg.self_play.games_per_generation)
            self.sharded_arena = sharded.make_sharded_arena(
                self.arena, self.mesh, cfg.arena.games,
                cfg.arena.promote_threshold)

        # Auxiliary targets: exact-value-labelled positions kept on the
        # device; every train step adds its terms on a random subset.
        self.solver_labels = None
        self.solver_labels_pi = None
        if cfg.loop.solver_labels_path:
            with np.load(cfg.loop.solver_labels_path) as npz:
                labels = {name: npz[name].astype(np.float32)
                          for name in ("obs", "z", "pi") if name in npz}
            self.solver_labels = tuple(
                torch.from_numpy(labels[name]).to(self.device)
                for name in ("obs", "z"))
            _say(
                f"solver aux value target: {len(labels['z'])} labeled "
                f"positions from {cfg.loop.solver_labels_path} "
                f"(weight={cfg.loop.solver_value_weight}, "
                f"batch={cfg.loop.solver_value_batch})"
            )
            if cfg.loop.solver_policy_weight > 0.0:
                if "pi" not in labels:
                    raise ValueError(
                        "loop.solver_policy_weight > 0 needs a 'pi' array "
                        f"in {cfg.loop.solver_labels_path}"
                    )
                self.solver_labels_pi = torch.from_numpy(
                    labels["pi"]).to(self.device)
                _say("solver aux policy target: weight="
                     f"{cfg.loop.solver_policy_weight}")
        self._train_step = make_train_step(
            cfg.model,
            aux_value_weight=(
                cfg.loop.solver_value_weight if self.solver_labels else 0.0
            ),
            aux_value_batch=cfg.loop.solver_value_batch,
            aux_policy_weight=(
                cfg.loop.solver_policy_weight
                if self.solver_labels_pi is not None else 0.0
            ),
            mesh=self.mesh if self.mesh.size > 1 else None,
        )

        # The same weights on every rank: one seed.
        self.train_state = init_train_state(
            self.env.num_actions, cfg.model, self.generator,
            self.env.obs_shape, device=self.device,
        )
        # The best net starts as the candidate's weights.
        self.best = copy.deepcopy(self.train_state.net).eval()
        self.candidate = self.train_state.net
        if self.mp > 1:
            self.candidate = copy.deepcopy(self.train_state.net).eval()
            shard_params(self.train_state.net, self.mesh,
                         self.train_state.trace)
        data_parallel(self.train_state.net, self.mesh.data_group, self.dp)
        self.evaluate_candidate = make_evaluate_fn(self.candidate)
        self.evaluate_best = make_evaluate_fn(self.best)
        # Per-shard streams for games, samples and arena moves; one stream
        # of auxiliary rows on every rank.
        self.aux_generator = self.generator
        if self.dp > 1:
            if self.mesh.data_index > 0:
                self.generator.manual_seed(
                    cfg.run.seed + RANK_SEED_STRIDE * self.mesh.data_index)
            self.aux_generator = torch.Generator(device=self.device)
            self.aux_generator.manual_seed(cfg.run.seed + AUX_SEED_OFFSET)

    # -- state -------------------------------------------------------------

    def init_replay(self):
        """This rank's ring: ``capacity // dp`` rows (the whole ring at
        dp=1)."""
        return replay_init(
            self.cfg.replay.capacity // self.dp, self.env.obs_shape,
            self.env.num_actions, self.codec, self.policy_codec,
            device=self.device,
        )

    def load_train_state(self, tree: dict) -> None:
        """Fill the candidate (weights, running statistics, momentum, step
        count) from a checkpoint's train state dict, in place; each shard
        takes its rows."""
        state = self.train_state
        load_jax_variables(self.candidate, tree["params"],
                           tree["batch_stats"])
        trace = trace_from_jax(tree["opt_state"], self.candidate)
        if self.mp > 1:
            net = state.net
            load_full(net, list(self.candidate.parameters()),
                      list(net.parameters()))
            for mine, full in zip(net.buffers(), self.candidate.buffers()):
                mine.copy_(full)
            load_full(net, trace, state.trace)
        else:
            for mine, saved in zip(state.trace, trace):
                mine.copy_(saved)
        state.steps = int(tree["steps"])

    def refresh_candidate(self) -> None:
        """At mp > 1, gather the training net's shards into ``candidate``
        (every rank of the model group calls it); else nothing."""
        if self.mp == 1:
            return
        net = self.train_state.net
        with torch.no_grad():
            for mine, full in zip(self.candidate.parameters(),
                                  full_tensors(net, list(net.parameters()))):
                mine.copy_(full)
            for mine, stat in zip(self.candidate.buffers(), net.buffers()):
                mine.copy_(stat)

    def full_train_state(self) -> TrainState:
        """The train state at full size: the training state itself, or at
        mp > 1 the refreshed candidate with the momentum's shards gathered
        (every rank calls it)."""
        if self.mp == 1:
            return self.train_state
        self.refresh_candidate()
        state = self.train_state
        return TrainState(self.candidate, full_tensors(state.net, state.trace),
                          state.steps)

    def promote(self) -> None:
        """Copy the candidate's weights and running statistics into the
        best net, in place."""
        self.refresh_candidate()
        self.best.load_state_dict(self.candidate.state_dict())

    def winner_state_dict(self) -> dict:
        """The train state dict with the best net's variables: what an
        arena's ``evaluation/iteration_N`` checkpoint holds."""
        tree = train_state_to_jax(self.full_train_state(), self.cfg.model)
        tree["params"], tree["batch_stats"] = to_jax_variables(self.best)
        return tree

    # -- programs ----------------------------------------------------------

    def generate(self):
        if self.dp > 1:
            return self.sharded_generate(self.evaluate_best, self.generator)
        return self.selfplay(self.evaluate_best, self.generator,
                             self.cfg.self_play.games_per_generation)

    def replay_add(self, replay, batch):
        return replay_add(replay, batch, self.codec, self.policy_codec)

    def replay_sample(self, replay):
        """This rank's ``batch_size // dp`` rows of the global batch, drawn
        from its own ring (sampling stratified by shard, as in JAX)."""
        return replay_sample(replay, self.generator,
                             self.cfg.model.batch_size // self.dp,
                             self.codec, self.policy_codec)

    def train_step(self, obs, target_pi, target_z):
        if self.solver_labels is None:
            return self._train_step(self.train_state, obs, target_pi,
                                    target_z)[1]
        return self._train_step(
            self.train_state, obs, target_pi, target_z, self.aux_generator,
            *self.solver_labels, self.solver_labels_pi,
        )[1]

    def run_arena(self):
        self.refresh_candidate()
        if self.dp > 1:
            return self.sharded_arena(self.evaluate_candidate,
                                      self.evaluate_best, self.generator)
        return self.arena(self.evaluate_candidate, self.evaluate_best,
                          self.generator, self.cfg.arena.games)

    def learning_rate(self) -> float:
        return learning_rate(self.cfg.model, self.train_state.steps)


def _say(*args, **kwargs) -> None:
    """``print`` on the coordinator only."""
    if distributed.is_coordinator():
        print(*args, **kwargs)


class _NoMetrics:
    """The metrics writer of a rank that writes none."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    scalars = scalar

    def close(self) -> None:
        pass


def _save_samples(learner: Learner, batch, path: str) -> None:
    """The generation's valid (states, policies, values) as an .npz."""
    valid = batch.valid
    if isinstance(batch.obs, PackedObs):
        # Decode only the valid rows, in chunks, so the archive never
        # re-creates the raw buffer that packing avoided.
        words, scalars = batch.obs.words[valid], batch.obs.scalars[valid]
        chunks = [
            learner.codec.decode(PackedObs(words[i:i + 8192],
                                           scalars[i:i + 8192])).cpu()
            for i in range(0, len(words), 8192)
        ]
        states = (torch.cat(chunks) if chunks
                  else torch.zeros((0,) + tuple(learner.env.obs_shape)))
    else:
        states = batch.obs[valid].cpu()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, states=states.numpy(),
             policies=batch.policy[valid].cpu().numpy(),
             values=batch.value[valid].cpu().numpy())


def _visualize_tree(learner: Learner, generation: int, results_dir: str,
                    game: str, run_id: str, updated: bool = False) -> None:
    """Render one search tree from the opening position with the best net:
    a 'light' (visited edges) render per call under
    self_play/iteration_{generation}; when the best net changed since the
    last render (``updated``), light and full renders under
    self_play/updated_mcts as well. The search is the general one at B=1,
    launched from the host (no CUDA graph), with ``cfg.mcts`` and its root
    noise drawn from a generator seeded with ``generation``."""
    cfg = learner.cfg
    generator = torch.Generator(device=learner.device)
    generator.manual_seed(generation)
    tree = MCTS(learner.env, cfg.mcts).search(
        learner.env.init(1, learner.device), learner.evaluate_best,
        generator, cfg.mcts.simulations)
    name = f"mcts_iteration_{generation}"
    save_tree(tree, learner.env, os.path.join(
        paths.self_play_iteration_path(results_dir, game, run_id, generation),
        f"{name}_light"), c_puct=cfg.mcts.c_puct)
    if updated:
        updated_dir = paths.updated_mcts_path(results_dir, game, run_id)
        save_tree(tree, learner.env, os.path.join(updated_dir, f"{name}_light"),
                  c_puct=cfg.mcts.c_puct)
        save_tree(tree, learner.env, os.path.join(updated_dir, f"{name}_full"),
                  c_puct=cfg.mcts.c_puct, min_visits=0)


def run(cfg: Config, generations: Optional[int] = None, device=None) -> dict:
    """Train; returns a summary dict (for tests and tools). ``device=None``
    is the CUDA card (this rank's, after ``distributed.initialize``).

    With several ranks every rank calls this with the same ``cfg``; the
    results directory is read by every rank (resume) and written by the
    coordinator only. The summary is the same on every rank but for the
    seconds in ``timings``: per generation, the sums of its ``loop.*``
    spans (io/trace.py)."""
    learner = Learner(cfg, device)
    mesh = learner.mesh
    coordinator = distributed.is_coordinator()
    run_id = cfg.run.run_id or paths.new_run_id()
    if distributed.is_initialized():
        run_id = distributed.broadcast_object(run_id, mesh.group_host)
    results_dir, game = cfg.run.results_dir, cfg.game
    run_dir = paths.run_path(results_dir, game, run_id)
    if coordinator:
        paths.create_all_directories(results_dir, game, run_id)
        with open(os.path.join(run_dir, paths.CONFIG_FILE), "w") as fp:
            fp.write(to_json(cfg))

    train_state = learner.train_state
    replay = learner.init_replay()
    training_dir = paths.training_path(results_dir, game, run_id)

    def ring_counts(samples: int):
        """(samples, filled rows, the smallest shard's rows) over every
        shard, from this rank's sample count and ring (one collective at
        dp > 1)."""
        if learner.dp == 1:
            size = int(replay.size)
            return samples, size, size
        rows = sharded.shard_counts(mesh, replay.size.new_tensor(samples),
                                    replay.size)
        return (int(rows[:, 0].sum()), int(rows[:, 1].sum()),
                int(rows[:, 1].min()))

    # Every rank resumes, or none: the coordinator's view decides.
    if distributed.broadcast_flag(checkpoint_exists(training_dir),
                                  mesh.group):
        tree, meta = load_checkpoint(training_dir)
        saved_replay = load_replay(training_dir)
        learner.load_train_state(tree)
        if saved_replay is not None:
            replay = replay_from_state_dict(
                saved_replay, learner.device,
                (mesh.data_index, mesh.dp))
        _say(f"Resumed training state at step {meta['steps']} "
             f"(replay={ring_counts(0)[1]})")

    # The best net starts as the candidate's; on resume, reload the newest
    # promoted lineage checkpoint.
    learner.promote()
    latest_best = latest_evaluation_iteration(
        paths.evaluation_path(results_dir, game, run_id)
    )
    if distributed.is_initialized():
        # The coordinator's newest iteration, loaded by every rank.
        number = distributed.broadcast_object(
            latest_best and latest_best[0], mesh.group_host)
        latest_best = None if number is None else (
            number, paths.evaluation_iteration_path(results_dir, game,
                                                    run_id, number))
    if latest_best is not None:
        best_tree, _ = load_checkpoint(latest_best[1])
        load_jax_variables(learner.best, best_tree["params"],
                           best_tree["batch_stats"])
        _say(f"Restored best model from iteration {latest_best[0]}")

    metrics = (MetricsWriter(paths.tensorboard_path(results_dir, game,
                                                    run_id))
               if coordinator else _NoMetrics())
    iteration = train_state.steps
    total = generations if generations is not None else cfg.loop.generations
    generation = 0
    summary = {"run_id": run_id, "iterations": 0, "promotions": 0,
               "last_arena_score": None, "timings": []}
    pending_save = None
    best_updated = False  # the best net changed since the last render
    # The oracle score of the reigning best, set at its promotion arena
    # (arena.solver_score_veto; None until the first promotion after the
    # start: the veto never fires before that).
    best_solver_score = None
    # Solver scoring runs on the default 7x6 n=4 board only (the native
    # solver's); elsewhere the setting scores nothing.
    solver_eval_ran = (cfg.arena.evaluate_with_solver
                       and cfg.game == "connect_n"
                       and cfg.connect_n == type(cfg.connect_n)())

    touch_liveness_file()
    # Keep the liveness file fresh through generation 0 (kernel build,
    # graph capture); bounded by run.compile_grace_minutes and stopped the
    # moment the first generation completes.
    grace = None
    if cfg.run.compile_grace_minutes > 0:
        grace = CompileGraceToucher(cfg.run.compile_grace_minutes * 60.0)
    arena_grace = None
    first_arena = True

    # Armed only after the first generation completes: generation 0
    # includes set-up that must not count against a steady-state timeout.
    heartbeat = None
    watchdog = None
    if cfg.run.watchdog_minutes > 0:
        heartbeat = Heartbeat(cfg.run.watchdog_minutes * 60.0)

    def _beat():
        touch_liveness_file()
        if heartbeat is not None:
            heartbeat.beat()

    def _steady_state():
        # First generation complete: the grace ends, liveness now tracks
        # real progress only.
        nonlocal grace, watchdog
        if grace is not None:
            grace.stop()
            grace = None
        if heartbeat is not None and watchdog is None:
            watchdog = start_watchdog(heartbeat)
            _say(f"Stall watchdog armed: {cfg.run.watchdog_minutes:g} min")

    def host_state():
        """(train state dict, ring state dict or None) for a checkpoint, on
        the coordinator (None, None elsewhere). Every rank calls it: the
        shards' gathers are collectives."""
        state = learner.full_train_state()
        ring = None
        if cfg.loop.checkpoint_replay:
            if learner.dp > 1:
                ring = sharded.fetch(replay, mesh)
            elif coordinator:
                ring = replay_state_dict(replay)
        if not coordinator:
            return None, None
        return train_state_to_jax(state, cfg.model), ring

    # Graceful operator stop: `touch <run_dir>/STOP` finishes the current
    # generation, writes a final checkpoint, and exits 0. Only the
    # coordinator reads the file; every rank stops at the same generation.
    stop_file = os.path.join(run_dir, "STOP")
    if coordinator and os.path.exists(stop_file):
        os.unlink(stop_file)  # already-honored request: resume runs

    where = (f" ({mesh.dp}x{mesh.mp} mesh of data x model ranks)"
             if mesh.size > 1 else "")
    _say(f"Starting run {run_id} on {learner.device}{where}")
    try:
        while total == 0 or generation < total:
            if distributed.broadcast_flag(
                    coordinator and os.path.exists(stop_file), mesh.group):
                _say(f"STOP requested via {stop_file}; exiting after "
                     f"{generation} generations (final checkpoint saved)")
                break
            with trace.span("loop.generate") as generate_span:
                batch, stats = learner.generate()
                # One read for the generation's stats.
                (samples, games, draws, plies,
                 mean_game_length) = torch.stack([
                     batch.valid.sum().float(), stats.games.float(),
                     stats.draws.float(), stats.plies.float(),
                     stats.mean_game_length.float(),
                 ]).tolist()
            samples, games, draws, plies = (
                int(samples), int(games), int(draws), int(plies))
            with trace.span("loop.replay") as replay_span:
                replay = learner.replay_add(replay, batch)
                # Global counts (the shards' samples and rows at dp > 1).
                samples, replay_total, min_shard = ring_counts(samples)
            gen_time = generate_span.seconds + replay_span.seconds
            timing = {"generation": generation, "samples": samples,
                      "generate_s": generate_span.seconds,
                      "replay_s": replay_span.seconds, "train_s": 0.0,
                      "arena_s": 0.0, "solver_score_s": 0.0,
                      "checkpoint_s": 0.0, "render_s": 0.0,
                      "train_iterations": 0}
            summary["timings"].append(timing)
            _beat()
            _steady_state()

            freq = cfg.loop.samples_checkpoint_frequency
            if freq and (generation + 1) % freq == 0:
                host_batch = (sharded.fetch_batch(batch, mesh)
                              if learner.dp > 1 else batch)
                if coordinator:
                    _save_samples(learner, host_batch, paths.samples_path(
                        results_dir, game, run_id, generation))
            vfreq = cfg.loop.visualize_frequency
            if coordinator and vfreq and (generation + 1) % vfreq == 0:
                with trace.span("loop.render") as render_span:
                    _visualize_tree(learner, generation, results_dir, game,
                                    run_id, updated=best_updated)
                best_updated = False
                timing["render_s"] = render_span.seconds
                _beat()
            sims = plies * cfg.mcts.simulations
            timing["sims_per_second"] = sims / max(gen_time, 1e-9)
            _say(
                f"[gen {generation}] {samples} samples from "
                f"{games} games in {gen_time:.2f}s "
                f"({sims / max(gen_time, 1e-9):,.0f} sims/s), "
                f"replay={replay_total}"
            )
            metrics.scalars(
                {
                    "self_play/samples": samples,
                    "self_play/games": games,
                    "self_play/mean_game_length": mean_game_length,
                    "self_play/draws": draws,
                    "self_play/sims_per_second": sims / max(gen_time, 1e-9),
                },
                iteration,
            )

            # Warm-up gate: the ring must hold min_size rows and a batch,
            # and every shard its share of one.
            if (replay_total >= max(cfg.replay.min_size,
                                    cfg.model.batch_size)
                    and min_shard >= cfg.model.batch_size // learner.dp):
                # Sample-reuse guardrail (LoopConfig.max_sample_reuse): reuse =
                # trained samples / fresh samples this generation. Above 1 the
                # ring turns over slower than the trainer consumes it.
                train_iters = cfg.loop.train_iterations_per_generation
                reuse_planned = (
                    train_iters * cfg.model.batch_size / max(samples, 1)
                )
                if cfg.loop.max_sample_reuse > 0 and (
                    reuse_planned > cfg.loop.max_sample_reuse
                ):
                    train_iters = max(
                        int(
                            cfg.loop.max_sample_reuse * samples
                            // cfg.model.batch_size
                        ),
                        1,
                    )
                    _say(
                        f"[gen {generation}] sample reuse "
                        f"{reuse_planned:.2f} > max_sample_reuse="
                        f"{cfg.loop.max_sample_reuse:g}; clamping to "
                        f"{train_iters} train iterations"
                    )
                reuse = train_iters * cfg.model.batch_size / max(samples, 1)
                if reuse > 1.0 and not cfg.loop.max_sample_reuse > 0:
                    _say(
                        f"[gen {generation}] WARNING: sample reuse "
                        f"{reuse:.2f} > 1 (replay turnover below 1; set "
                        "loop.max_sample_reuse or lower "
                        "loop.train_iterations_per_generation)"
                    )
                metrics.scalar("train/sample_reuse", reuse, iteration)
                timing["train_iterations"] = train_iters
                for _ in range(train_iters):
                    with trace.span("loop.train") as train_span:
                        m = learner.train_step(*learner.replay_sample(replay))
                        iteration = m.steps
                        # One read for the step's loss terms.
                        loss, lp, lv, laux, laux_pi = torch.stack([
                            m.loss, m.policy_loss, m.value_loss,
                            m.solver_value_loss, m.solver_policy_loss,
                        ]).tolist()
                    timing["train_s"] += train_span.seconds
                    if not math.isfinite(loss):
                        # SGD momentum never recovers from a non-finite update;
                        # every later step (and any self-play from these
                        # weights) would be garbage. Fail loud instead.
                        raise RuntimeError(
                            f"train/loss is non-finite at step {iteration} "
                            f"(policy={lp}, value={lv}): training diverged. "
                            "Lower model.lr_values or set "
                            "model.grad_clip_norm."
                        )
                    train_scalars = {
                        "train/loss": loss,
                        "train/policy_loss": lp,
                        "train/value_loss": lv,
                        "train/learning_rate": m.learning_rate,
                        "train/steps": iteration,
                    }
                    if learner.solver_labels is not None:
                        train_scalars["train/solver_value_loss"] = laux
                    if learner.solver_labels_pi is not None:
                        train_scalars["train/solver_policy_loss"] = laux_pi
                    _beat()
                    summary["iterations"] = iteration
                    metrics.scalars(train_scalars, iteration)

                    cfreq = cfg.arena.checkpoint_frequency
                    if cfreq and iteration % cfreq == 0:
                        # The host copy is made here; the disk IO runs on a
                        # worker thread, joined before run() returns.
                        with trace.span("loop.checkpoint") as save_span:
                            state_tree, ring_tree = host_state()
                            if coordinator:
                                if pending_save is not None:
                                    pending_save.join()  # one at a time
                                pending_save = save_checkpoint_async(
                                    training_dir, state_tree,
                                    learner.learning_rate(), ring_tree,
                                )
                        timing["checkpoint_s"] += save_span.seconds
                    efreq = cfg.arena.evaluation_frequency
                    if efreq and iteration % efreq == 0:
                        with trace.span("loop.arena") as arena_span:
                            if (first_arena
                                    and cfg.run.compile_grace_minutes > 0):
                                # The first arena sets up too (its search's
                                # graph captures): its own bounded liveness
                                # grace.
                                arena_grace = CompileGraceToucher(
                                    cfg.run.compile_grace_minutes * 60.0
                                )
                            result = learner.run_arena()
                            (score, promoted, wins, losses,
                             arena_draws) = torch.stack([
                                result.score, result.promote.float(),
                                result.wins.float(), result.losses.float(),
                                result.draws.float(),
                            ]).tolist()
                            promoted = bool(promoted)
                            summary["last_arena_score"] = score
                            _say(
                                f"[iter {iteration}] arena score={score:.3f} "
                                f"(+{int(wins)}/-{int(losses)}/="
                                f"{int(arena_draws)}) promoted={promoted}"
                            )
                            metrics.scalar("evaluation/winning_score", score,
                                           iteration)
                        timing["arena_s"] += arena_span.seconds
                        solver_score = None
                        if solver_eval_ran and coordinator:
                            # Exact solves on the host can take minutes:
                            # live compute, so the liveness file is kept
                            # fresh for a bounded window.
                            with trace.span(
                                    "loop.solver_score") as score_span:
                                score_grace = (
                                    CompileGraceToucher(15 * 60.0)
                                    if cfg.run.compile_grace_minutes > 0
                                    else None
                                )
                                try:
                                    solver_score = strength.score_arena_log(
                                        result.log)
                                finally:
                                    if score_grace is not None:
                                        score_grace.stop()
                            timing["solver_score_s"] += score_span.seconds
                            print(f"[iter {iteration}] solver score="
                                  f"{solver_score:.3f}")
                            metrics.scalar("evaluation/solver_score",
                                           solver_score, iteration)
                        # The veto is decided before the promotion, which
                        # copies in place and cannot be undone; the
                        # coordinator holds the scores and decides for all.
                        margin = cfg.arena.solver_score_veto_margin
                        if (promoted and cfg.arena.solver_score_veto
                                and solver_eval_ran
                                and distributed.broadcast_flag(
                                    solver_score is not None
                                    and best_solver_score is not None
                                    and solver_score
                                    < best_solver_score - margin,
                                    mesh.group)):
                            promoted = False
                            _say(
                                f"[iter {iteration}] solver-score veto: "
                                f"candidate {solver_score:.3f} < best "
                                f"{best_solver_score:.3f} - {margin}"
                                " — promotion blocked"
                            )
                        if promoted:
                            learner.promote()
                            summary["promotions"] += 1
                            best_updated = True
                            if solver_score is not None:
                                best_solver_score = solver_score
                        # The *winner*'s weights land in
                        # evaluation/iteration_N: the candidate when
                        # promoted, the incumbent otherwise.
                        with trace.span("loop.checkpoint") as save_span:
                            winner = learner.winner_state_dict()
                            if coordinator:
                                save_checkpoint(
                                    paths.evaluation_iteration_path(
                                        results_dir, game, run_id, iteration
                                    ),
                                    winner,
                                    learner.learning_rate(),
                                )
                        timing["checkpoint_s"] += save_span.seconds
                        _beat()
                        if arena_grace is not None:
                            arena_grace.stop()
                            arena_grace = None
                        first_arena = False
            generation += 1
        if pending_save is not None:
            pending_save.join()
        # Final checkpoint: the loop's exit state is always resumable, even
        # when the stop did not land on a checkpoint_frequency boundary.
        if summary["iterations"] > 0:
            state_tree, ring_tree = host_state()
            if coordinator:
                save_checkpoint(training_dir, state_tree,
                                learner.learning_rate(), ring_tree)
    finally:
        # Also on an abort (a non-finite loss): nothing outlives the run.
        if watchdog is not None:
            watchdog.disarm()
        if grace is not None:
            grace.stop()
        if arena_grace is not None:
            arena_grace.stop()
        if pending_save is not None:
            pending_save.join()
        metrics.close()
    return summary


def main(argv=None):
    # One process: nothing to join. Under torchrun every rank joins the
    # process group and takes its card first.
    distributed.initialize()
    overrides = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    run(apply_overrides(Config(), overrides))


if __name__ == "__main__":
    main()
