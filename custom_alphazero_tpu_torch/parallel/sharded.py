"""The loop's phases split over the data axis (the port of
parallel/sharded.py).

JAX runs each phase as one ``shard_map`` program over the mesh's ``data``
axis; here every rank runs the single-device function on its own share,
and the few cross-shard results go through parallel/distributed.py:

- self-play: each rank plays ``games // dp`` games; the stats are summed
  over the data group (the mean game length re-weighted by each shard's
  games). The samples stay on their rank.
- replay: each rank owns a ring of ``capacity // dp`` rows (plus the port's
  spare row), appends its own samples and serves ``batch // dp`` rows of
  every training batch: sampling is stratified by shard, as in JAX. The
  ring functions are the single ring's (runtime/loop.py's ``Learner``
  sizes them); the shards' counts and the checkpoint's gather are here.
- arena: each rank plays its share of the games, rounded up as JAX does;
  the tallies are summed, and score and promotion computed from the sums;
  per-game results and the game log are gathered in rank order along the
  games axis (JAX's ``P(None, data)`` layout), on the coordinator's host.

What only the coordinator writes (checkpoints, sample archives, the arena
log it scores) is gathered to the data group's first rank alone.

Every rank calls every function here that reduces or gathers, in the same
order: a collective that only some ranks reach never returns.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from custom_alphazero_tpu_torch.parallel import distributed
from custom_alphazero_tpu_torch.parallel.mesh import Mesh
from custom_alphazero_tpu_torch.replay.buffer import (
    ReplayState,
    replay_state_dict,
)
from custom_alphazero_tpu_torch.runtime.arena import ArenaGameLog, ArenaResult
from custom_alphazero_tpu_torch.replay.codec import PackedObs
from custom_alphazero_tpu_torch.runtime.selfplay import (
    SelfPlayBatch,
    SelfPlayStats,
)


def reduce_stats(stats: SelfPlayStats, mesh: Mesh) -> SelfPlayStats:
    """Per-shard self-play stats summed over the data group in one
    all-reduce (float32, exact for counts below 2^24), with JAX's float32
    re-weighting of the mean game length."""
    games = stats.games.float()
    sums = distributed.all_reduce(torch.stack([
        games, stats.plies.float(), stats.wins_first_mover.float(),
        stats.wins_second_mover.float(), stats.draws.float(),
        stats.mean_game_length.float() * games,
    ]), mesh.data_group)
    count = stats.games.dtype
    return SelfPlayStats(
        games=sums[0].to(count),
        plies=sums[1].to(stats.plies.dtype),
        wins_first_mover=sums[2].to(count),
        wins_second_mover=sums[3].to(count),
        draws=sums[4].to(count),
        mean_game_length=sums[5] / sums[0].clamp_min(1.0),
    )


def make_sharded_generate(selfplay: Callable, mesh: Mesh,
                          games_per_generation: int) -> Callable:
    """``generate(evaluate, generator) -> (batch, stats)``: this rank's
    ``games_per_generation // dp`` games (its samples, in its rows) and the
    stats of all of them."""
    if games_per_generation % mesh.dp:
        raise ValueError(
            f"games_per_generation={games_per_generation} not divisible by "
            f"data axis size {mesh.dp}"
        )
    local_games = games_per_generation // mesh.dp

    def generate(evaluate, generator):
        batch, stats = selfplay(evaluate, generator, local_games)
        return batch, reduce_stats(stats, mesh)

    return generate


def _gather_rows(tensor: torch.Tensor, mesh: Mesh, dim: int = 0):
    """The data shards' ``tensor`` concatenated along ``dim`` in rank
    order, on the data group's first rank's host (None elsewhere)."""
    parts = distributed.gather_host(tensor, mesh.data_group_host)
    return None if parts is None else torch.cat(parts, dim=dim)


def fetch_batch(batch: SelfPlayBatch, mesh: Mesh) -> Optional[SelfPlayBatch]:
    """The shards' generation batches as one host batch in JAX's global
    layout: each shard's rows contiguous, in rank order; on the data
    group's first rank (None elsewhere). Every rank of the group calls
    it."""
    obs = (PackedObs(*(_gather_rows(t, mesh) for t in batch.obs))
           if isinstance(batch.obs, PackedObs)
           else _gather_rows(batch.obs, mesh))
    rest = [_gather_rows(t, mesh)
            for t in (batch.policy, batch.value, batch.valid)]
    return SelfPlayBatch(obs, *rest) if mesh.data_index == 0 else None


def shard_counts(mesh: Mesh, *counts: torch.Tensor) -> np.ndarray:
    """(dp, len(counts)) int64: every data shard's counts (scalar tensors,
    below 2^24), gathered in one all-reduce."""
    mine = torch.stack([c.float() for c in counts])[None]
    return distributed.all_gather_sum(
        mine, mesh.data_index, mesh.dp, mesh.data_group).cpu().numpy(
        ).astype(np.int64)


def replay_total_size(state: ReplayState, mesh: Mesh) -> int:
    """Filled rows over all shards."""
    return int(shard_counts(mesh, state.size).sum())


def replay_min_shard_size(state: ReplayState, mesh: Mesh) -> int:
    return int(shard_counts(mesh, state.size).min())


def arena_games_per_shard(num_games: int, dp: int) -> int:
    """JAX's rounding: ceil(num_games / dp), then up to even, so starters
    split evenly in every shard; prints JAX's lines when it changes the
    count."""
    local_games = -(-num_games // dp)  # ceil
    local_games += local_games % 2     # even per-shard starter split
    if local_games * dp != num_games and distributed.is_coordinator():
        total = local_games * dp
        print(
            f"arena: {num_games} games round up to {total} "
            f"({local_games}/shard, even) to shard over dp={dp}"
        )
        if total > 2 * num_games:
            print(
                f"arena: WARNING inflated game count {total} > 2x the "
                f"requested {num_games}; raise arena.games to a multiple "
                f"of 2*dp to avoid the distortion"
            )
    return local_games


def make_sharded_arena(arena: Callable, mesh: Mesh, num_games: int,
                       promote_threshold: float) -> Callable:
    """``run(evaluate_candidate, evaluate_incumbent, generator) ->
    ArenaResult`` over every shard's games: tallies summed, score =
    wins / decisive games (0.5 without one), promotion at the threshold (as
    JAX's sharded arena: the single arena's ``min_decisives`` rule is not
    in it), equal on every rank; ``per_game`` and the log gathered along
    the games axis on the data group's first rank's host (None
    elsewhere)."""
    local_games = arena_games_per_shard(num_games, mesh.dp)

    def run(evaluate_candidate, evaluate_incumbent, generator):
        res = arena(evaluate_candidate, evaluate_incumbent, generator,
                    local_games)
        tallies = distributed.all_reduce(
            torch.stack([res.wins, res.losses, res.draws]).float(),
            mesh.data_group)
        wins, losses, draws = tallies.to(res.wins.dtype).unbind()
        decisive = wins + losses
        score = torch.where(
            decisive > 0, wins.float() / decisive.clamp_min(1).float(), 0.5
        ).float()
        log = [_gather_rows(t, mesh, 1) for t in res.log]
        return ArenaResult(
            score=score,
            promote=score >= promote_threshold,
            wins=wins, losses=losses, draws=draws,
            per_game=_gather_rows(res.per_game, mesh),
            log=ArenaGameLog(*log) if mesh.data_index == 0 else None,
        )

    return run


def fetch(state: ReplayState, mesh: Mesh) -> Optional[dict]:
    """The per-shard rings as one host state dict in JAX's global layout
    (``fetch`` of a ring sharded over ``data``): each shard's rows
    contiguous, in rank order, without the spare rows; ``head`` and
    ``size`` int32 arrays of shape (dp,). On the data group's first rank
    (None elsewhere); every rank of the group calls it."""
    local = replay_state_dict(state)

    def gather(array: np.ndarray):
        unsigned = array.dtype == np.uint32
        tensor = torch.from_numpy(array.view(np.int32) if unsigned
                                  else array)
        out = _gather_rows(tensor.reshape(
            (1,) if tensor.dim() == 0 else tensor.shape), mesh)
        if out is None:
            return None
        out = out.numpy()
        return out.view(np.uint32) if unsigned else out

    def walk(tree):
        if isinstance(tree, dict):
            return {key: walk(value) for key, value in tree.items()}
        return gather(tree)

    tree = walk(local)
    return tree if mesh.data_index == 0 else None
