"""Lockstep self-play generation on the card.

The port of runtime/selfplay.py::make_selfplay_fn, plain and continuous
modes. A Python loop steps a batch of games in lockstep: per ply one search
(the fused v2 search, ops/fused_mcts_v2.py, or the general
``MCTS.search``), a move sampled per game, and the samples recorded under a
liveness mask. Both searches give the same root visits, so the two paths
give the same samples. With ``mcts.use_gumbel`` the search is
``GumbelMCTS.search_select``: its action is played and its improved policy
is the target, with no sampling. Sample semantics are the JAX ones:

- pi = root child visits normalised; from ``fullmove >= greedy_from_move``
  the played distribution and the stored target are a one-hot argmax.
- The recorded observation is the one before the move.
- z: with result r for the last mover and distance d from the end,
  z_t = r * (-1)^d * discount^d; continuous mode builds it per completed
  segment, back to front, and drops each slot's trailing unfinished game.
- Draw games can be excluded from the samples.

Moves are sampled from pi with the caller's ``torch.Generator`` (greedy rows
are one-hot, so sampling them is the argmax).

With ``mcts.reuse_tree`` each game's tree is carried across moves, as the
reference does: ``MCTS.search_tree`` continues on it, ``MCTS.advance_root``
re-roots it at the played child (kept subtrees truncated to capacity minus
simulations), and in continuous mode a finished game's tree starts afresh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from custom_alphazero_tpu_torch.config import (
    MCTSConfig,
    SelfPlayConfig,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.core import Env
from custom_alphazero_tpu_torch.io import trace
from custom_alphazero_tpu_torch.ops import fused_mcts_v2
from custom_alphazero_tpu_torch.replay.codec import PackedObs
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn
from custom_alphazero_tpu_torch.search.gumbel import GumbelMCTS
from custom_alphazero_tpu_torch.search.mcts import MCTS, Tree


class SelfPlayBatch(NamedTuple):
    """Flattened (T*B) sample arrays, time-major, + validity mask.

    ``obs`` is the raw observation tensor or, from a generation built with
    an ``obs_codec``, the codec's ``PackedObs`` (bit-packed per ply, so the
    raw T*B buffer of a large observation never exists)."""

    obs: Any              # (T*B, H, W, C) tensor, or PackedObs
    policy: torch.Tensor  # (T*B, A)
    value: torch.Tensor   # (T*B,)
    valid: torch.Tensor   # (T*B,) bool: live ply of a non-excluded game


class SelfPlayStats(NamedTuple):
    games: torch.Tensor
    plies: torch.Tensor
    wins_first_mover: torch.Tensor
    wins_second_mover: torch.Tensor
    draws: torch.Tensor
    mean_game_length: torch.Tensor


GenerateFn = Callable[[EvaluateFn, torch.Generator, int],
                      Tuple[SelfPlayBatch, SelfPlayStats]]


def make_selfplay_fn(env: Env, mcts_cfg: MCTSConfig,
                     sp_cfg: SelfPlayConfig, max_plies: int,
                     device=None, fused: bool = None,
                     graph: bool = None, obs_codec=None) -> GenerateFn:
    """Build ``generate(evaluate_fn, generator, batch_size)``.

    fused: search with the fused v2 kernel; None (the default) does so
    whenever ``fused_mcts_v2.supports`` the env and config and neither
    Gumbel search nor subtree reuse is on, and otherwise runs the general
    ``MCTS.search`` (or the Gumbel search, or ``MCTS.search_tree``).
    Gumbel search and subtree reuse are never fused, and never go together
    (ValueError).
    graph: the fused search's ``graph`` argument: None (the default)
    replays one captured CUDA graph per wave on the card; False launches
    every wave from the host, for an evaluator that cannot be captured.
    obs_codec: a replay/codec.py ``BitplaneCodec``; when given, each ply's
    observations are bit-packed as they are recorded and ``SelfPlayBatch.obs``
    is the ``PackedObs``."""
    reuse = mcts_cfg.reuse_tree
    gumbel = mcts_cfg.use_gumbel
    if fused is None:
        fused = (not gumbel and not reuse
                 and fused_mcts_v2.supports(env, mcts_cfg))
    if gumbel and fused:
        raise ValueError("Gumbel search uses fresh general-search trees: "
                         "it has no fused kernel")
    if reuse and fused:
        raise ValueError("the fused search builds a fresh tree per move: "
                         "it cannot carry subtrees (mcts.reuse_tree)")
    if reuse and gumbel:
        raise ValueError("Gumbel search uses fresh trees: it has no subtree "
                         "reuse")
    device = resolve_device(device)
    sims = mcts_cfg.simulations
    mcts = MCTS(env, mcts_cfg)
    if reuse and mcts_cfg.topk_actions != -1 and (
            mcts.prior_width(sims) < env.num_actions):
        # Reuse trees are full width; a config that would compress its
        # priors must acknowledge the memory with topk_actions=-1.
        raise ValueError(
            "mcts.reuse_tree uses full-width priors but this config "
            "would compress (topk/auto on a large action space); set "
            "mcts.topk_actions=-1 to acknowledge the memory cost"
        )
    # Capacity for the carried and the new nodes; a kept subtree is cut to
    # keep_cap nodes so that a search's new nodes always fit.
    tree_capacity = max(mcts_cfg.max_nodes, 2 * sims)
    keep_cap = tree_capacity - sims
    if gumbel:
        gumbel_search = GumbelMCTS(env, mcts_cfg)
    elif fused:
        fused_search = fused_mcts_v2.FusedConnectNSearchV2(env, mcts_cfg,
                                                           device)

        def search_visits(states, evaluate_fn, generator):
            return fused_search.search_root_stats(
                states, evaluate_fn, generator, sims, graph=graph)[0]
    else:
        def search_visits(states, evaluate_fn, generator):
            tree = mcts.search(states, evaluate_fn, generator, sims)
            return mcts.root_child_visits(tree)

    num_actions = env.num_actions

    def generate(evaluate_fn: EvaluateFn, generator: torch.Generator,
                 batch_size: int):
        with trace.span("selfplay.generate"):
            return play(evaluate_fn, generator, batch_size)

    def play(evaluate_fn, generator, batch_size):
        fresh = env.init(batch_size, device)
        states = fresh
        if reuse:
            # Two copies: search_tree updates its tree in place.
            fresh_tree = mcts.init_tree(fresh, tree_capacity)
            tree = mcts.init_tree(fresh, tree_capacity)
            free = torch.ones(batch_size, dtype=torch.int32, device=device)
        obs_seq, pi_seq, active_seq, reward_seq, done_seq, mv_seq = (
            [], [], [], [], [], []
        )
        for _ in range(max_plies):
            active = ~env.is_terminal(states)
            obs = env.observe(states)
            mv = states.fullmove
            if gumbel:
                # Play the sequential-halving winner, train on the improved
                # policy (the Gumbel draw is the exploration).
                _, actions, pi = gumbel_search.search_select(
                    states, evaluate_fn, generator, sims)
            else:
                if reuse:
                    tree, free = mcts.search_tree(tree, free, evaluate_fn,
                                                  generator, sims)
                    visits = mcts.root_child_visits(tree)
                else:
                    visits = search_visits(states, evaluate_fn, generator)
                actions, pi = _sample_move(
                    visits.float(), mv >= mcts_cfg.greedy_from_move,
                    num_actions, generator)

            next_states, rewards = env.step(states, actions)
            if reuse:
                tree, free = mcts.advance_root(tree, actions, keep_cap,
                                               next_states)
            done = active & env.is_terminal(next_states)
            if sp_cfg.continuous:
                next_states = fresh.where(done, next_states)
                if reuse:
                    # A finished game's tree starts afresh.
                    tree = _reset_trees(fresh_tree, tree, done)
                    free = torch.where(done, 1, free).to(torch.int32)
            states = next_states
            obs_seq.append(obs_codec.encode(obs) if obs_codec is not None
                           else obs)
            pi_seq.append(pi)
            active_seq.append(active)
            reward_seq.append(rewards)
            done_seq.append(done)
            mv_seq.append(mv)

        active_t = torch.stack(active_seq)  # (T, B)
        reward_t = torch.stack(reward_seq)
        done_t = torch.stack(done_seq)
        mv_t = torch.stack(mv_seq)
        if sp_cfg.continuous:
            z, valid, stats = _continuous_targets(
                sp_cfg, active_t, reward_t, done_t, mv_t
            )
        else:
            z, valid, stats = _plain_targets(
                sp_cfg, batch_size, max_plies, active_t, reward_t
            )
        batch = SelfPlayBatch(
            obs=(PackedObs(*(torch.cat(parts) for parts in zip(*obs_seq)))
                 if obs_codec is not None else torch.cat(obs_seq)),
            policy=torch.cat(pi_seq),
            value=z.reshape(-1).float(),
            valid=valid.reshape(-1),
        )
        return batch, stats

    return generate


def _reset_trees(fresh: Tree, tree: Tree, done: torch.Tensor) -> Tree:
    """``fresh``'s trees where ``done`` (B,), else ``tree``'s."""

    def pick(a, b):
        return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return Tree(root_state=fresh.root_state.where(done, tree.root_state),
                **{f.name: pick(getattr(fresh, f.name), getattr(tree, f.name))
                   for f in dataclasses.fields(Tree)
                   if f.name != "root_state"
                   and getattr(tree, f.name) is not None})


def _sample_move(visits, greedy, num_actions, generator):
    """(actions, pi): pi = visits normalised, one-hot argmax on greedy rows;
    the move is sampled from pi (a row with no visits plays action 0)."""
    probs = visits / visits.sum(dim=-1, keepdim=True).clamp_min(1.0)
    one_hot = torch.nn.functional.one_hot(visits.argmax(dim=-1),
                                          num_actions).float()
    pi = torch.where(greedy[:, None], one_hot, probs)
    first = torch.zeros_like(pi)
    first[:, 0] = 1.0
    safe_pi = torch.where(pi.sum(dim=-1, keepdim=True) > 0, pi, first)
    return torch.multinomial(safe_pi, 1, generator=generator)[:, 0], pi


def _continuous_targets(sp_cfg, active, reward, done, mv):
    """Per-segment z (back to front) and stats of auto-reset generation."""
    t_len, bsz = reward.shape
    z = torch.zeros_like(reward)
    valid = torch.zeros_like(done)
    res = torch.zeros_like(reward)
    z_next = torch.zeros(bsz, device=reward.device)
    valid_next = torch.zeros(bsz, dtype=torch.bool, device=reward.device)
    res_next = torch.zeros(bsz, device=reward.device)
    for t in range(t_len - 1, -1, -1):
        z_next = torch.where(done[t], reward[t], -sp_cfg.discount * z_next)
        res_next = torch.where(done[t], reward[t], res_next)
        valid_next = done[t] | valid_next
        z[t], valid[t], res[t] = z_next, valid_next, res_next
    if sp_cfg.exclude_draws:
        valid = valid & (res != 0)
    games = done.sum()
    won_seg = done & (reward > 0)
    seg_len = torch.where(done, mv + 1, 0)
    odd_len = done & (seg_len % 2 == 1)
    stats = SelfPlayStats(
        games=games.to(torch.int32),
        plies=active.sum(),
        wins_first_mover=(won_seg & odd_len).sum(),
        wins_second_mover=(won_seg & ~odd_len).sum(),
        draws=(done & ~won_seg).sum(),
        mean_game_length=seg_len.sum() / games.clamp_min(1).float(),
    )
    return z, valid, stats


def _plain_targets(sp_cfg, batch_size, max_plies, active, reward):
    """z with sign flips and discount, and stats of one batch of games."""
    lengths = active.sum(dim=0)  # (B,); games absorb: a prefix mask
    # Only a winning final move has a nonzero reward; draws sum to 0.
    results = reward.sum(dim=0)  # (B,) in {0, 1}
    t_idx = torch.arange(max_plies, device=reward.device)[:, None]
    dist = (lengths[None, :] - 1 - t_idx).float()
    sign = torch.where(dist % 2.0 == 0.0, 1.0, -1.0)
    z = results[None, :] * sign * torch.pow(
        torch.tensor(sp_cfg.discount, dtype=torch.float32,
                     device=reward.device),
        dist.clamp_min(0.0),
    )
    valid = active
    if sp_cfg.exclude_draws:
        valid = valid & (results[None, :] != 0)
    won = results != 0
    odd_len = lengths % 2 == 1
    stats = SelfPlayStats(
        games=torch.tensor(batch_size, dtype=torch.int32,
                           device=reward.device),
        plies=active.sum(),
        wins_first_mover=(won & odd_len).sum(),
        wins_second_mover=(won & ~odd_len).sum(),
        draws=(~won).sum(),
        mean_game_length=lengths.float().mean(),
    )
    return z, valid, stats
