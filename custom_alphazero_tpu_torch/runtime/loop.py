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
  size, and once per train step for the loss terms.
"""

from __future__ import annotations

import copy
import math
import os
import sys
import time
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
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
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
        raise NotImplementedError(
            "game='chess' is not ported yet (ROADMAP.md queue 1, "
            "'Chess engine')"
        )
    raise ValueError(f"Unknown game {cfg.game!r}")


def _check_ported(cfg: Config) -> None:
    """Raise for every setting whose code is not ported, before anything
    runs."""
    not_ported = (
        (cfg.mesh.data_parallelism > 1, "mesh.data_parallelism > 1",
         "Multi-GPU"),
        (cfg.mesh.model_parallelism > 1, "mesh.model_parallelism > 1",
         "Multi-GPU"),
        (cfg.mcts.use_gumbel, "mcts.use_gumbel", "Gumbel search"),
        (cfg.mcts.reuse_tree, "mcts.reuse_tree", "Subtree reuse"),
    )
    for is_set, setting, item in not_ported:
        if is_set:
            raise NotImplementedError(
                f"{setting} is not ported yet (ROADMAP.md queue 1, "
                f"'{item}')"
            )


class Learner:
    """The programs and the nets of one training run on one device.

    ``train_state.net`` is the candidate: the module that trains. ``best``
    is the net that self-play searches with. Both keep their memory for the
    life of the learner: a checkpoint is loaded into them, and a promotion
    copied, in place."""

    def __init__(self, cfg: Config, device=None):
        _check_ported(cfg)
        self.cfg = cfg
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
            print(
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
                print("solver aux policy target: weight="
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
        )

        self.train_state = init_train_state(
            self.env.num_actions, cfg.model, self.generator,
            self.env.obs_shape, device=self.device,
        )
        # The best net starts as the candidate's weights.
        self.best = copy.deepcopy(self.train_state.net).eval()
        self.evaluate_candidate = make_evaluate_fn(self.train_state.net)
        self.evaluate_best = make_evaluate_fn(self.best)

    # -- state -------------------------------------------------------------

    def init_replay(self):
        cfg = self.cfg
        return replay_init(
            cfg.replay.capacity, self.env.obs_shape, self.env.num_actions,
            self.codec, self.policy_codec, device=self.device,
        )

    def load_train_state(self, tree: dict) -> None:
        """Fill the candidate (weights, running statistics, momentum, step
        count) from a checkpoint's train state dict, in place."""
        state = self.train_state
        load_jax_variables(state.net, tree["params"], tree["batch_stats"])
        for mine, saved in zip(state.trace,
                               trace_from_jax(tree["opt_state"], state.net)):
            mine.copy_(saved)
        state.steps = int(tree["steps"])

    def promote(self) -> None:
        """Copy the candidate's weights and running statistics into the
        best net, in place."""
        self.best.load_state_dict(self.train_state.net.state_dict())

    def winner_state_dict(self) -> dict:
        """The train state dict with the best net's variables: what an
        arena's ``evaluation/iteration_N`` checkpoint holds."""
        tree = train_state_to_jax(self.train_state, self.cfg.model)
        tree["params"], tree["batch_stats"] = to_jax_variables(self.best)
        return tree

    # -- programs ----------------------------------------------------------

    def generate(self):
        return self.selfplay(self.evaluate_best, self.generator,
                             self.cfg.self_play.games_per_generation)

    def replay_add(self, replay, batch):
        return replay_add(replay, batch, self.codec, self.policy_codec)

    def replay_sample(self, replay):
        return replay_sample(replay, self.generator,
                             self.cfg.model.batch_size, self.codec,
                             self.policy_codec)

    def train_step(self, obs, target_pi, target_z):
        if self.solver_labels is None:
            return self._train_step(self.train_state, obs, target_pi,
                                    target_z)[1]
        return self._train_step(
            self.train_state, obs, target_pi, target_z, self.generator,
            *self.solver_labels, self.solver_labels_pi,
        )[1]

    def run_arena(self):
        return self.arena(self.evaluate_candidate, self.evaluate_best,
                          self.generator, self.cfg.arena.games)

    def learning_rate(self) -> float:
        return learning_rate(self.cfg.model, self.train_state.steps)


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
    is the CUDA card."""
    run_id = cfg.run.run_id or paths.new_run_id()
    results_dir, game = cfg.run.results_dir, cfg.game
    learner = Learner(cfg, device)
    paths.create_all_directories(results_dir, game, run_id)
    run_dir = paths.run_path(results_dir, game, run_id)
    with open(os.path.join(run_dir, paths.CONFIG_FILE), "w") as fp:
        fp.write(to_json(cfg))

    train_state = learner.train_state
    replay = learner.init_replay()
    training_dir = paths.training_path(results_dir, game, run_id)
    if checkpoint_exists(training_dir):
        tree, meta = load_checkpoint(training_dir)
        saved_replay = load_replay(training_dir)
        learner.load_train_state(tree)
        if saved_replay is not None:
            replay = replay_from_state_dict(saved_replay, learner.device)
        print(f"Resumed training state at step {meta['steps']} "
              f"(replay={int(replay.size)})")

    # The best net starts as the candidate's; on resume, reload the newest
    # promoted lineage checkpoint.
    learner.promote()
    latest_best = latest_evaluation_iteration(
        paths.evaluation_path(results_dir, game, run_id)
    )
    if latest_best is not None:
        best_tree, _ = load_checkpoint(latest_best[1])
        load_jax_variables(learner.best, best_tree["params"],
                           best_tree["batch_stats"])
        print(f"Restored best model from iteration {latest_best[0]}")

    metrics = MetricsWriter(paths.tensorboard_path(results_dir, game, run_id))
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
            print(f"Stall watchdog armed: {cfg.run.watchdog_minutes:g} min")

    # Graceful operator stop: `touch <run_dir>/STOP` finishes the current
    # generation, writes a final checkpoint, and exits 0.
    stop_file = os.path.join(run_dir, "STOP")
    if os.path.exists(stop_file):
        os.unlink(stop_file)  # already-honored request: resume runs

    print(f"Starting run {run_id} on {learner.device}")
    try:
        while total == 0 or generation < total:
            if os.path.exists(stop_file):
                print(f"STOP requested via {stop_file}; exiting after "
                      f"{generation} generations (final checkpoint saved)")
                break
            gen_start = time.time()
            batch, stats = learner.generate()
            # One read for the generation's stats.
            samples, games, draws, plies, mean_game_length = torch.stack([
                batch.valid.sum().float(), stats.games.float(),
                stats.draws.float(), stats.plies.float(),
                stats.mean_game_length.float(),
            ]).tolist()
            samples, games, draws, plies = (
                int(samples), int(games), int(draws), int(plies))
            generate_time = time.time() - gen_start
            replay = learner.replay_add(replay, batch)
            replay_total = int(replay.size)
            gen_time = time.time() - gen_start
            timing = {"generation": generation, "samples": samples,
                      "generate_s": generate_time,
                      "replay_s": gen_time - generate_time, "train_s": 0.0,
                      "arena_s": 0.0, "solver_score_s": 0.0,
                      "checkpoint_s": 0.0, "render_s": 0.0,
                      "train_iterations": 0}
            summary["timings"].append(timing)
            _beat()
            _steady_state()

            freq = cfg.loop.samples_checkpoint_frequency
            if freq and (generation + 1) % freq == 0:
                _save_samples(learner, batch, paths.samples_path(
                    results_dir, game, run_id, generation))
            vfreq = cfg.loop.visualize_frequency
            if vfreq and (generation + 1) % vfreq == 0:
                render_start = time.time()
                _visualize_tree(learner, generation, results_dir, game,
                                run_id, updated=best_updated)
                best_updated = False
                timing["render_s"] = time.time() - render_start
                _beat()
            sims = plies * cfg.mcts.simulations
            timing["sims_per_second"] = sims / max(gen_time, 1e-9)
            print(
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

            # Warm-up gate: the ring must hold min_size rows and a batch.
            if replay_total >= max(cfg.replay.min_size, cfg.model.batch_size):
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
                    print(
                        f"[gen {generation}] sample reuse "
                        f"{reuse_planned:.2f} > max_sample_reuse="
                        f"{cfg.loop.max_sample_reuse:g}; clamping to "
                        f"{train_iters} train iterations"
                    )
                reuse = train_iters * cfg.model.batch_size / max(samples, 1)
                if reuse > 1.0 and not cfg.loop.max_sample_reuse > 0:
                    print(
                        f"[gen {generation}] WARNING: sample reuse "
                        f"{reuse:.2f} > 1 (replay turnover below 1; set "
                        "loop.max_sample_reuse or lower "
                        "loop.train_iterations_per_generation)"
                    )
                metrics.scalar("train/sample_reuse", reuse, iteration)
                timing["train_iterations"] = train_iters
                for _ in range(train_iters):
                    step_start = time.time()
                    m = learner.train_step(*learner.replay_sample(replay))
                    iteration = m.steps
                    # One read for the step's loss terms.
                    loss, lp, lv, laux, laux_pi = torch.stack([
                        m.loss, m.policy_loss, m.value_loss,
                        m.solver_value_loss, m.solver_policy_loss,
                    ]).tolist()
                    timing["train_s"] += time.time() - step_start
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
                        save_start = time.time()
                        if pending_save is not None:
                            pending_save.join()  # one save at a time
                        pending_save = save_checkpoint_async(
                            training_dir,
                            train_state_to_jax(train_state, cfg.model),
                            learner.learning_rate(),
                            (replay_state_dict(replay)
                             if cfg.loop.checkpoint_replay else None),
                        )
                        timing["checkpoint_s"] += time.time() - save_start
                    efreq = cfg.arena.evaluation_frequency
                    if efreq and iteration % efreq == 0:
                        arena_start = time.time()
                        if first_arena and cfg.run.compile_grace_minutes > 0:
                            # The first arena sets up too (its search's graph
                            # captures): its own bounded liveness grace.
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
                        print(
                            f"[iter {iteration}] arena score={score:.3f} "
                            f"(+{int(wins)}/-{int(losses)}/="
                            f"{int(arena_draws)}) promoted={promoted}"
                        )
                        metrics.scalar("evaluation/winning_score", score,
                                       iteration)
                        timing["arena_s"] += time.time() - arena_start
                        solver_score = None
                        if solver_eval_ran:
                            # Exact solves on the host can take minutes:
                            # live compute, so the liveness file is kept
                            # fresh for a bounded window.
                            score_start = time.time()
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
                            timing["solver_score_s"] += (time.time()
                                                         - score_start)
                            print(f"[iter {iteration}] solver score="
                                  f"{solver_score:.3f}")
                            metrics.scalar("evaluation/solver_score",
                                           solver_score, iteration)
                        # The veto is decided before the promotion, which
                        # copies in place and cannot be undone.
                        margin = cfg.arena.solver_score_veto_margin
                        if (promoted and cfg.arena.solver_score_veto
                                and solver_score is not None
                                and best_solver_score is not None
                                and solver_score < best_solver_score - margin):
                            promoted = False
                            print(
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
                        save_start = time.time()
                        save_checkpoint(
                            paths.evaluation_iteration_path(
                                results_dir, game, run_id, iteration
                            ),
                            learner.winner_state_dict(),
                            learner.learning_rate(),
                        )
                        timing["checkpoint_s"] += time.time() - save_start
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
            save_checkpoint(
                training_dir,
                train_state_to_jax(train_state, cfg.model),
                learner.learning_rate(),
                (replay_state_dict(replay) if cfg.loop.checkpoint_replay
                 else None),
            )
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
    overrides = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    run(apply_overrides(Config(), overrides))


if __name__ == "__main__":
    main()
