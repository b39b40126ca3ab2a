"""Lockstep arena evaluation, candidate vs incumbent (the port of
runtime/arena.py).

Semantics of the JAX arena:

- half the games are candidate-first, half incumbent-first, and the models
  alternate every ply. With an even game count the starters are contiguous
  halves, so at any ply each model acts on one half of the batch and
  forwards only that half; an odd count alternates starters by game index
  and both models forward the whole batch;
- raw-policy mode: each move is sampled (or the argmax when deterministic)
  from the acting model's legal-masked renormalised policy;
- MCTS mode: a fresh search per move with the acting model, greedy argmax at
  ``fullmove > greedy_from_move`` (strict, unlike self-play's ``>=``);
- score = wins / decisive games; an all-draw series scores 0.5; promotion at
  ``score >= promote_threshold``, or by ``promote_when_inconclusive`` when
  fewer than ``min_decisives`` games were decisive.

The played actions are returned so the host can score them afterwards.

The search is the fused one (ops/fused_mcts_v2.py) whenever it supports the
config, else the general ``MCTS.search``: both give the same root visits.
The fused search caches one CUDA graph per evaluator object, and the mixed
evaluator depends on the ply's parity only, so the arena keeps one mixed
evaluator per parity for each pair of models it has seen: at most two
captures for a pair, however many arenas it plays. Moves are drawn from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from custom_alphazero_tpu_torch.config import (
    ArenaConfig,
    MCTSConfig,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.core import Env
from custom_alphazero_tpu_torch.models.policy_value import masked_policy
from custom_alphazero_tpu_torch.ops import fused_mcts_v2
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn
from custom_alphazero_tpu_torch.search.mcts import MCTS

CANDIDATE, INCUMBENT = 0, 1


class ArenaGameLog(NamedTuple):
    actions: torch.Tensor  # (T, B) played action per ply
    movers: torch.Tensor   # (T, B) 0 = candidate moved, 1 = incumbent
    active: torch.Tensor   # (T, B) game still live at this ply


class ArenaResult(NamedTuple):
    score: torch.Tensor     # scalar in [0, 1]
    promote: torch.Tensor   # bool
    wins: torch.Tensor      # candidate wins
    losses: torch.Tensor    # incumbent wins
    draws: torch.Tensor
    per_game: torch.Tensor  # (B,) +1 candidate win / -1 loss / 0 draw
    log: ArenaGameLog


def _mixed_evaluators(evaluate_candidate: EvaluateFn,
                      evaluate_incumbent: EvaluateFn,
                      starters: torch.Tensor) -> Tuple[EvaluateFn, EvaluateFn]:
    """The evaluators of even and of odd plies: each row of the batch goes
    to the model that moves in that game at such a ply."""
    num_games = starters.shape[0]
    half = num_games // 2

    def half_evaluate(swap: bool) -> EvaluateFn:
        # swap: the candidate acts on the second half at this parity.
        def evaluate(obs):
            a, b = obs[:half], obs[half:]
            pc, vc = evaluate_candidate(b if swap else a)
            pi, vi = evaluate_incumbent(a if swap else b)
            if swap:
                return torch.cat([pi, pc]), torch.cat([vi, vc])
            return torch.cat([pc, pi]), torch.cat([vc, vi])

        return evaluate

    def full_mixed_evaluate(parity: int) -> EvaluateFn:
        # Odd game counts only: both models forward the full batch.
        candidate_moves = (starters + parity) % 2 == CANDIDATE

        def evaluate(obs):
            pc, vc = evaluate_candidate(obs)
            pi, vi = evaluate_incumbent(obs)
            return (torch.where(candidate_moves[:, None], pc, pi),
                    torch.where(candidate_moves, vc, vi))

        return evaluate

    if num_games % 2 == 0:
        return half_evaluate(False), half_evaluate(True)
    return full_mixed_evaluate(0), full_mixed_evaluate(1)


def make_arena_fn(
    env: Env, arena_cfg: ArenaConfig, mcts_cfg: MCTSConfig, max_plies: int,
    device=None,
) -> Callable[[EvaluateFn, EvaluateFn, torch.Generator, int], ArenaResult]:
    """Build ``arena(evaluate_candidate, evaluate_incumbent, generator,
    num_games)``; the evaluators are batched (obs) -> (probs, value)."""
    device = resolve_device(device)
    num_actions = env.num_actions
    sims = mcts_cfg.simulations
    if arena_cfg.evaluate_with_mcts:
        if fused_mcts_v2.supports(env, mcts_cfg):
            fused_search = fused_mcts_v2.FusedConnectNSearchV2(
                env, mcts_cfg, device)

            def search_visits(states, evaluate_fn, generator):
                return fused_search.search_root_stats(
                    states, evaluate_fn, generator, sims)[0]
        else:
            mcts = MCTS(env, mcts_cfg)

            def search_visits(states, evaluate_fn, generator):
                tree = mcts.search(states, evaluate_fn, generator, sims)
                return mcts.root_child_visits(tree)

    # (candidate, incumbent, games) -> (starters, even-ply and odd-ply
    # evaluators): the same objects on every arena of the same pair.
    pairs: Dict[tuple, tuple] = {}

    def arena(evaluate_candidate: EvaluateFn, evaluate_incumbent: EvaluateFn,
              generator: torch.Generator, num_games: int) -> ArenaResult:
        key = (evaluate_candidate, evaluate_incumbent, num_games)
        if key not in pairs:
            index = torch.arange(num_games, device=device)
            # Even count: the candidate starts the first half of the games.
            # Odd count: starters alternate by game (0: candidate first).
            starters = ((index >= num_games // 2) if num_games % 2 == 0
                        else index % 2).to(torch.int32)
            pairs[key] = (starters, _mixed_evaluators(
                evaluate_candidate, evaluate_incumbent, starters))
        starters, mixed = pairs[key]

        states = env.init(num_games, device)
        actions_seq, movers_seq, active_seq = [], [], []
        for t in range(max_plies):
            active = ~env.is_terminal(states)
            movers = (starters + t) % 2
            mixed_evaluate = mixed[t % 2]
            if arena_cfg.evaluate_with_mcts:
                visits = search_visits(states, mixed_evaluate,
                                       generator).float()
                probs = visits / visits.sum(-1, keepdim=True).clamp_min(1.0)
                greedy = states.fullmove > mcts_cfg.greedy_from_move  # strict
                one_hot = torch.nn.functional.one_hot(
                    visits.argmax(dim=-1), num_actions).float()
                pi = torch.where(greedy[:, None], one_hot, probs)
            else:
                probs, _ = mixed_evaluate(env.observe(states))
                pi = masked_policy(torch.log(probs + 1e-30),
                                   env.legal_mask(states))
            if arena_cfg.deterministic:
                actions = pi.argmax(dim=-1)
            else:
                first = torch.zeros_like(pi)
                first[:, 0] = 1.0
                safe_pi = torch.where(pi.sum(-1, keepdim=True) > 0, pi, first)
                actions = torch.multinomial(safe_pi, 1,
                                            generator=generator)[:, 0]
            actions = actions.to(torch.int32)
            states, _ = env.step(states, actions)
            actions_seq.append(actions)
            movers_seq.append(movers)
            active_seq.append(active)

        log = ArenaGameLog(actions=torch.stack(actions_seq),
                           movers=torch.stack(movers_seq),
                           active=torch.stack(active_seq))
        lengths = log.active.sum(dim=0)  # (B,)
        # terminal_value < 0 <=> the last mover won; a game that max_plies
        # cut short counts as a draw.
        won = env.terminal_value(states) < 0
        last_mover = (starters + lengths - 1) % 2
        per_game = torch.where(
            won, torch.where(last_mover == CANDIDATE, 1, -1), 0
        ).to(torch.int32)
        wins = (per_game == 1).sum()
        losses = (per_game == -1).sum()
        draws = (per_game == 0).sum()
        decisive = wins + losses
        score = torch.where(
            decisive > 0, wins.float() / decisive.clamp_min(1).float(), 0.5
        ).float()
        # A series with fewer than min_decisives decisive games is
        # inconclusive: promote_when_inconclusive decides it, not the
        # threshold. min_decisives = 0 is the plain gate.
        promote = torch.where(
            decisive >= arena_cfg.min_decisives,
            score >= arena_cfg.promote_threshold,
            bool(arena_cfg.promote_when_inconclusive),
        )
        return ArenaResult(score=score, promote=promote, wins=wins,
                           losses=losses, draws=draws, per_game=per_game,
                           log=log)

    return arena
