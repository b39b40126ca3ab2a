"""Gumbel root search: sequential halving + completed-Q selection (the port
of search/gumbel.py, held to it by tests/test_torch_port_gumbel.py).

- Root: one Gumbel draw g(a) per action; the top ``m`` legal actions by
  g + log prior are the candidates. Simulations follow a static
  sequential-halving schedule (``halving_schedule``): phases of
  round-robin visits, after each the worse half of the candidates by
  g + log prior + sigma(q) is dropped.
- Below the root: the deterministic choice
  argmax_a pi'(a) - N(a) / (1 + sum N), pi' = softmax(log prior +
  sigma(completedQ)), where completedQ fills unvisited actions with the
  mixed value estimate; sigma(q) = (c_visit + max N) * c_scale * q.
- Output: the last surviving candidate is played, and the improved policy
  pi' at the root over the full action space is the training target.

Trees are fresh (no root noise, no reuse) and laid out as ``MCTS.search``
lays them out, at full width or with top-K priors (``prior_width``); in the
top-K layout the root keeps full-width statistics, which candidate scoring
and the improved policy read. Wave 0 evaluates and expands the root and
backs nothing up; wave i >= 1 creates its node in slot i.

Where JAX reconstructs every node's edge statistics with one-hot einsums,
the port reads them through a per-game child table, as ``MCTS.search``
does (each edge has one child at most, so the values are the same). The
improved policy's softmax keeps JAX's order of operations (floor, log,
sigma, max-subtracted exponent, sum, divide); row sums are ``rowsum``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from custom_alphazero_tpu_torch.ops.rng import gumbel
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn
from custom_alphazero_tpu_torch.search.mcts import (
    MCTS,
    UNVISITED,
    _NEW,
    _write,
    renormalize,
    rowsum,
)

NEG_INF = torch.finfo(torch.float32).min


def halving_schedule(m: int, sims: int) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Static sequential-halving plan for ``sims`` root visits over ``m``
    candidates: per-wave (candidate_slot, halve_after, alive_count).

    Phases r = 0..R-1 (R = ceil(log2 m)) visit the alive candidates
    round-robin; non-final phases give each candidate
    max(floor(sims / (R * alive)), 1) visits, the final phase (alive == 2,
    or the budget's tail) spreads everything remaining.
    """
    if m < 1:
        raise ValueError(f"m={m} must be >= 1")
    slots, halves, alives = [], [], []
    alive = m
    r_total = max(math.ceil(math.log2(m)), 1)
    r = 0
    while len(slots) < sims:
        last = alive <= 2 or r >= r_total - 1
        remaining = sims - len(slots)
        per = remaining // alive if last else max(
            sims // (r_total * alive), 1
        )
        per = max(min(per, remaining // alive), 1) if remaining >= alive else 1
        for _ in range(per):
            for slot in range(alive):
                if len(slots) >= sims:
                    break
                slots.append(slot)
                halves.append(False)
                alives.append(alive)
        if len(slots) >= sims:
            break
        if alive > 1:
            halves[-1] = True
            alive = max(alive // 2, 1)
        r += 1
    return (
        np.asarray(slots, np.int32),
        np.asarray(halves, np.bool_),
        np.asarray(alives, np.int32),
    )


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's order: exp(x - max) / sum."""
    unnormalized = torch.exp(logits - logits.max(-1, keepdim=True).values)
    return unnormalized / rowsum(unnormalized)


def _adjacent_gap(ordered: torch.Tensor) -> torch.Tensor:
    """(B,) smallest relative gap between neighbours of descending score
    rows (B, L), ignoring masked (float32-minimum) entries."""
    if ordered.shape[1] < 2:
        return torch.full(ordered.shape[:1], math.inf, device=ordered.device)
    hi, lo = ordered[:, :-1], ordered[:, 1:]
    rel = (hi - lo) / torch.maximum(hi.abs(), lo.abs()).clamp_min(1e-30)
    live = lo > NEG_INF / 2
    return torch.where(live, rel, math.inf).amin(-1)


class GumbelMCTS(MCTS):
    """Batched Gumbel sequential-halving search over an :class:`Env`.

    Config knobs come from MCTSConfig: ``simulations``,
    ``gumbel_max_considered`` (m), ``gumbel_c_visit``, ``gumbel_c_scale``.

    With ``track_gaps`` set, ``search_select`` leaves in ``decision_gap``
    (B,) the smallest relative gap between the two best scores of every
    decision that shaped a game's search: the candidate cut, each halving,
    the final pick, and each expanded node's choice in each wave. Two
    runs whose inputs differ in the last bits can disagree only where it is
    small.
    """

    track_gaps = False
    decision_gap: Optional[torch.Tensor] = None

    # -- pieces --------------------------------------------------------------

    def _sigma(self, q, max_visits):
        cfg = self.cfg
        return (cfg.gumbel_c_visit + max_visits) * cfg.gumbel_c_scale * q

    def _completed_q(self, prior, nv, w, v_node):
        """completedQ (..., A): q(a) = W/N where visited, else the mixed
        value (v + sum(N) * weighted-visited-q) / (1 + sum(N))."""
        visited = nv > 0
        q = torch.where(visited, w / nv.clamp_min(1.0), 0.0)
        n_total = rowsum(nv)[..., 0]
        pi_vis = torch.where(visited, prior, 0.0)
        pi_vis_sum = rowsum(pi_vis)[..., 0]
        q_weighted = rowsum(pi_vis * q)[..., 0] / pi_vis_sum.clamp_min(1e-30)
        v_mix = (v_node + n_total * q_weighted) / (1.0 + n_total)
        v_mix = torch.where(pi_vis_sum > 0, v_mix, v_node)
        return torch.where(visited, q, v_mix[..., None])

    def _improved_policy(self, prior, nv, w, v_node):
        """pi' = softmax over legal of (log prior + sigma(completedQ))."""
        completed = self._completed_q(prior, nv, w, v_node)
        max_n = nv.max(-1, keepdim=True).values
        logits = torch.where(
            prior > 0,
            torch.log(prior.clamp_min(1e-35)) + self._sigma(completed, max_n),
            NEG_INF)
        return _softmax(logits)

    def _nonroot_scores(self, prior, nv, w, v_node):
        """Deterministic-selection scores pi'(a) - N(a)/(1 + sum N); empty
        or illegal slots (prior 0) score the float32 minimum. Full-width
        (..., A) rows and top-K (..., K) slot rows alike."""
        pi = self._improved_policy(prior, nv, w, v_node)
        score = pi - nv / (1.0 + rowsum(nv))
        return torch.where(prior > 0, score, NEG_INF)

    def _nonroot_action(self, prior, nv, w, v_node):
        """Deterministic selection: the first argmax of the scores."""
        return self._nonroot_scores(prior, nv, w, v_node).argmax(-1)

    def _track(self, gap: torch.Tensor) -> None:
        self.decision_gap = torch.minimum(self.decision_gap, gap)

    # -- search --------------------------------------------------------------

    def search_select(self, root_states, evaluate_fn: EvaluateFn,
                      generator: Optional[torch.Generator], simulations: int,
                      gumbels: Optional[torch.Tensor] = None):
        """Run the Gumbel sequential-halving search; returns
        (tree, action (B,), improved_policy (B, A)).

        generator: draws the (B, A) Gumbel noise, once, before the waves.
        gumbels: (B, A) draws used instead (tests feed JAX's through it).
        Simulation 0 evaluates and expands the root; the other
        ``simulations - 1`` are root visits on the halving schedule.
        """
        env, cfg = self.env, self.cfg
        a = env.num_actions
        n = max(cfg.max_nodes, simulations)
        m = max(min(cfg.gumbel_max_considered, a, simulations - 1), 1)
        k = self.prior_width(simulations)
        compressed = k < a
        tree = self.init_tree(root_states, n, k)
        bsz = tree.parent.shape[0]
        dev = tree.parent.device
        batch = torch.arange(bsz, device=dev)
        if gumbels is None:
            gumbels = gumbel(generator, (bsz, a), dev)
        if self.track_gaps:
            self.decision_gap = torch.full((bsz,), math.inf, device=dev)

        # ---- wave 0: evaluate and expand the root --------------------------
        probs0, values0 = evaluate_fn(env.observe(root_states))
        values0 = values0.float().reshape(bsz)
        prior0 = renormalize(probs0.float(), env.legal_mask(root_states))
        root_live = ~env.is_terminal(root_states)
        if compressed:
            # Selection never reads the root's top-K row (the scheduled
            # candidate overrides it), but the layout keeps it: the top-K
            # priors and the full-width root row.
            r_vals, r_acts = torch.sort(prior0, dim=-1, descending=True,
                                        stable=True)
            _write(tree.prior, 0, r_vals[:, :k], root_live)
            _write(tree.prior_acts, 0, r_acts[:, :k], root_live)
            tree.root_prior = torch.where(root_live[:, None], prior0,
                                          tree.root_prior)
        else:
            _write(tree.prior, 0, prior0, root_live)
        tree.expanded[:, 0] = root_live
        tree.value_evaluated[:, 0] = torch.where(root_live, values0, 0.0)

        # Candidates: the top-m legal actions by g + log prior, best first
        # (log prior differs from the net's logits by a per-row constant).
        root_logits = torch.where(
            prior0 > 0, torch.log(prior0.clamp_min(1e-35)), NEG_INF)
        base_score = torch.where(prior0 > 0, gumbels + root_logits, NEG_INF)
        ordered, order = torch.sort(base_score, dim=-1, descending=True,
                                    stable=True)
        cand_actions = order[:, :m]
        if self.track_gaps:
            self._track(_adjacent_gap(ordered[:, :m + 1]))

        sims_left = max(simulations - 1, 0)
        if sims_left == 0:
            return tree, base_score.argmax(-1), prior0

        slots, halves, alives = halving_schedule(m, sims_left)
        children = torch.full((bsz, n, k), UNVISITED, dtype=torch.int32,
                              device=dev)
        if compressed:
            root_children = torch.full((bsz, a), UNVISITED,
                                       dtype=torch.int32, device=dev)
        slot_range = torch.arange(m, device=dev)

        def root_stats():
            if compressed:
                return tree.root_visits, tree.root_value_sum
            return (self.root_child_visits(tree).float(),
                    self.root_child_value_sums(tree))

        def cand_scores(cand_actions):
            """(B, m) g + log prior + sigma(q) of each candidate's root
            edge (q = 0 unvisited)."""
            nv, w = root_stats()
            q = torch.where(nv > 0, w / nv.clamp_min(1.0), 0.0)
            max_n = nv.max(-1, keepdim=True).values
            score_a = gumbels + root_logits + self._sigma(q, max_n)
            return score_a.gather(1, cand_actions)

        for i in range(sims_left):
            # Per-wave precompute: every node's deterministic choice (the
            # statistics are frozen within a wave).
            has = children >= 0
            flat = children.clamp_min(0).long().view(bsz, n * k)
            nv = torch.where(has, tree.visits.gather(1, flat).view(bsz, n, k),
                             0.0)
            w = torch.where(has,
                            tree.value_sum.gather(1, flat).view(bsz, n, k),
                            0.0)
            scores = self._nonroot_scores(tree.prior, nv, w,
                                          tree.value_evaluated)
            if compressed:
                # Ties go to the lowest ACTION, as at full width: take the
                # smallest tied action, then find its slot.
                tied = scores == scores.max(-1, keepdim=True).values
                best_a = torch.where(tied, tree.prior_acts, a).min(-1).values
                best_k = (tied & (tree.prior_acts == best_a[..., None])) \
                    .to(torch.uint8).argmax(-1)
                best_a = best_a.long()
            else:
                best_a = scores.argmax(-1)
                best_k = best_a
            if self.track_gaps:
                top2 = scores.topk(min(2, k), dim=-1).values
                chooses = tree.expanded & ~tree.is_terminal
                chooses[:, 0] = False
                node_gap = torch.where(chooses, _adjacent_gap(
                    top2.view(bsz * n, -1)).view(bsz, n), math.inf)
                self._track(node_gap.amin(-1))

            # The root's action is the scheduled candidate (a slot past a
            # game's legal count falls back to candidate 0).
            root_action = cand_actions[:, int(slots[i])]
            root_prior = tree.root_prior if compressed else tree.prior[:, 0]
            root_legal = root_prior.gather(1, root_action[:, None])[:, 0] > 0
            root_action = torch.where(root_legal, root_action,
                                      cand_actions[:, 0])
            best_a[:, 0] = root_action
            best_child = children.gather(2, best_k[..., None])[..., 0].long()
            if compressed:
                best_child[:, 0] = root_children.gather(
                    1, root_action[:, None])[:, 0]

            node, action, code, state = self._descend(tree, best_a,
                                                      best_child)

            # CREATE in slot i + 1 and EVALUATE the leaves.
            slot_i = i + 1
            new = code == _NEW
            child_state, reward = env.step(state, action)
            leaf = torch.where(new, slot_i, node)
            leaf_state = child_state.where(new, state)
            child_terminal = env.is_terminal(child_state)
            leaf_terminal = torch.where(new, child_terminal,
                                        tree.is_terminal[batch, node])
            leaf_reward = torch.where(new, reward, tree.reward[batch, node])
            probs, values = evaluate_fn(env.observe(leaf_state))
            probs = probs.float()
            values = values.float().reshape(bsz)

            _write(tree.parent, slot_i, node, new)
            _write(tree.parent_action, slot_i, action, new)
            _write(tree.is_terminal, slot_i, child_terminal, new)
            _write(tree.reward, slot_i, reward, new)
            tree.node_count += new.to(torch.int32)
            if compressed:
                # The new child's slot in its parent's top-K row; root
                # children are found by action.
                sel_slot = torch.where(node == 0, UNVISITED,
                                       best_k[batch, node])
                _write(tree.parent_slot, slot_i, sel_slot, new)
                slot = sel_slot.clamp_min(0)
                children[batch, node, slot] = torch.where(
                    new & (node > 0), slot_i, children[batch, node, slot])
                root_children[batch, action] = torch.where(
                    new & (node == 0), slot_i, root_children[batch, action])
            else:
                children[batch, node, action] = torch.where(
                    new, slot_i, children[batch, node, action])

            # EXPAND the new leaf unless terminal.
            do = ~tree.expanded[batch, leaf] & ~leaf_terminal
            legal = env.legal_mask(leaf_state)
            renormed = renormalize(probs, legal)
            if compressed:
                # The search's top-K row: slot 0 the lowest legal action,
                # slots 1.. the top K-1 others, ties to the lower action.
                a0 = legal.to(torch.uint8).argmax(-1)
                a0_oh = torch.arange(a, device=dev)[None, :] == a0[:, None]
                boosted = renormed + a0_oh.float() * 2.0
                top_vals, top_acts = torch.sort(boosted, dim=-1,
                                                descending=True, stable=True)
                top_vals = top_vals[:, :k].clone()
                top_vals[:, 0] = renormed[batch, a0]
                _write(tree.prior, slot_i, top_vals, do)
                _write(tree.prior_acts, slot_i, top_acts[:, :k], do)
            else:
                _write(tree.prior, slot_i, renormed, do)
            _write(tree.value_evaluated, slot_i, values, do & new)
            _write(tree.expanded, slot_i, True, do & new)

            leaf_value = torch.where(leaf_terminal, leaf_reward, -values)
            root_val, root_hit = self._backup(tree, leaf, leaf_value)
            if compressed:
                tree.root_visits[batch, root_action] += root_hit.float()
                tree.root_value_sum[batch, root_action] += torch.where(
                    root_hit, root_val, 0.0)

            # Sequential halving: keep the best half of the alive prefix,
            # sorted best first (stable), so the alive set stays a prefix.
            if halves[i]:
                scores = torch.where(slot_range < int(alives[i]),
                                     cand_scores(cand_actions), NEG_INF)
                ordered, order = torch.sort(scores, dim=-1, descending=True,
                                            stable=True)
                cand_actions = cand_actions.gather(1, order)
                if self.track_gaps:
                    self._track(_adjacent_gap(ordered))

        # The final pick among the last phase's survivors.
        scores = torch.where(slot_range < int(alives[-1]),
                             cand_scores(cand_actions), NEG_INF)
        best = scores.argmax(-1)
        action = cand_actions.gather(1, best[:, None])[:, 0]
        # Terminal roots play action 0 (masked upstream, as PUCT play is).
        action = torch.where(root_live, action, 0)
        if self.track_gaps:
            self._track(_adjacent_gap(scores.topk(min(2, m), -1).values))

        # The improved-policy target at the root, over the full action
        # space (the top-K layout keeps full-width root statistics).
        nv_root, w_root = root_stats()
        root_prior = tree.root_prior if compressed else tree.prior[:, 0]
        return tree, action, self._improved_policy(root_prior, nv_root,
                                                   w_root, values0)
