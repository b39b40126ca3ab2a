"""Batched array-tree PUCT search (the port of search/mcts.py).

``MCTS.search`` runs a fresh-tree search for a batch of games, one
simulation wave at a time, with the JAX package's tree and semantics, held
to it field by field (tests/test_torch_port_mcts.py):

- Static node slots: the node that wave ``i`` creates goes in slot ``i``;
  slots of waves that create nothing stay unlinked (parent -1). Wave 0 only
  expands the root and backs nothing up.
- Edge statistics live on the child node (``visits`` / ``value_sum`` of the
  edge into it). Every edge has at most one child.
- PUCT: Q = W / N (0 unvisited), U = c_puct * P * sqrt(sum N) / (1 + N),
  illegal actions score the float32 minimum, ties go to the lowest action.
  Statistics are frozen within a wave, so every node's choice is computed
  once per wave and the descent reads it.
- The env state is carried through the descent with ``env.step_lite``.
- Top-K priors when ``prior_width`` < A: slot 0 holds the lowest legal
  action, slots 1.. the top K-1 of the rest (ties to the lower action). The
  root keeps its full prior row and full-width edge stats, maintained by the
  backup.

``MCTS.search_tree`` and ``MCTS.advance_root`` carry the trees across
moves (subtree reuse, full width only): each game's new nodes go to its own
``free`` cursor, and a re-rooted tree keeps its most visited nodes.

Where JAX contracts one-hot einsums to avoid gathers and scatters on the
TPU, the port indexes: each game's children are kept in a (B, N, K) table
of child slots, written when a node is created, so an edge's statistics
are a gather of its child's. Each edge has one child at most, so the values
are the einsums' exactly. In the ``fast_edge_stats`` layout that table is
JAX's ``child_index`` field.

Row sums over a short action axis are taken left to right (``rowsum``),
the order XLA's CPU reduction uses for these rows, so that non-dyadic sums
(the Dirichlet normaliser) round as in JAX. Chess rows (A = 1968) are
summed in torch's order: their sums, and the priors divided by them, may
differ from JAX's in the last bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from custom_alphazero_tpu_torch.config import MCTSConfig
from custom_alphazero_tpu_torch.envs.core import Env
from custom_alphazero_tpu_torch.ops.rng import safe_gamma
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn

# Descent stop codes.
_CONTINUE = 0  # keep descending
_NEW = 1       # expanded node whose best action has no child yet
_UNEXPANDED = 2  # an unexpanded node (only the root, at wave 0)
_TERMINAL = 3  # a terminal node

NO_PARENT = -1
UNVISITED = -1

_NEG_INF = torch.finfo(torch.float32).min
# Rows up to this width (every Connect-N board) are summed one column at a
# time (``rowsum``).
SEQUENTIAL_SUM_MAX = 64


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """(..., A) -> (..., 1) sum over the last axis: left to right for short
    rows, as XLA's CPU reduction sums them; wider rows (chess, A = 1968),
    which XLA sums in an order of its own, in torch's order."""
    if x.shape[-1] > SEQUENTIAL_SUM_MAX:
        return x.sum(-1, keepdim=True)
    total = x[..., 0:1]
    for a in range(1, x.shape[-1]):
        total = total + x[..., a:a + 1]
    return total


def renormalize(probs: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Legal-masked renormalized priors, uniform over legal moves when the
    mass is zero, with a 1e-35 floor so that ``prior > 0`` is exactly the
    legal mask."""
    masked = torch.where(legal, probs, 0.0)
    total = rowsum(masked)
    num_legal = legal.sum(dim=-1, keepdim=True).clamp_min(1)
    renormed = torch.where(
        total > 0.0,
        masked / total.clamp_min(1e-30),
        legal.float() / num_legal,
    )
    return torch.where(legal, renormed.clamp_min(1e-35), 0.0)


def root_noisy_prior(root_prior: torch.Tensor, gamma: torch.Tensor,
                     fraction: float) -> torch.Tensor:
    """(1 - fraction) * P + fraction * Dir(alpha) over the legal root
    actions, the Dirichlet sample built from (B, A) Gamma draws."""
    legal = root_prior > 0
    gamma = torch.where(legal, gamma, 0.0)
    noise = gamma / rowsum(gamma).clamp_min(1e-30)
    mixed = (1.0 - fraction) * root_prior + fraction * noise
    # Keep the legal floor: noise can underflow to zero.
    return torch.where(legal, mixed.clamp_min(1e-35), 0.0)


@dataclass
class Tree:
    """Search trees of capacity N nodes for a batch of B games.

    root_state: the batch's root positions (node 0).
    parent, parent_action: (B, N) int32; parent -1 for the root and for
        unlinked slots.
    visits, value_sum: (B, N) float32 statistics of the edge into the node,
        from the point of view of the player taking that edge.
    prior: (B, N, K) legal-masked renormalised priors (0 = illegal).
    expanded, is_terminal: (B, N) bool.
    reward: (B, N) float32 reward of the mover who created the node.
    value_evaluated: (B, N) float32 network value at expansion.
    node_count: (B,) int32 linked nodes.

    Top-K layout only (None at full width): prior_acts (B, N, K) int32
    action of each prior slot; parent_slot (B, N) int32 slot of the node in
    its parent's row (-1 for root children); root_prior, root_visits,
    root_value_sum (B, A) float32 full-width root row and edge stats;
    child_index (B, N, K) int32 child slot per (node, slot) edge, -1 where
    none (``fast_edge_stats`` only).
    """

    root_state: Any
    parent: torch.Tensor
    parent_action: torch.Tensor
    visits: torch.Tensor
    value_sum: torch.Tensor
    prior: torch.Tensor
    expanded: torch.Tensor
    is_terminal: torch.Tensor
    reward: torch.Tensor
    value_evaluated: torch.Tensor
    node_count: torch.Tensor
    prior_acts: Optional[torch.Tensor] = None
    parent_slot: Optional[torch.Tensor] = None
    root_prior: Optional[torch.Tensor] = None
    root_visits: Optional[torch.Tensor] = None
    root_value_sum: Optional[torch.Tensor] = None
    child_index: Optional[torch.Tensor] = None


def _write(arr: torch.Tensor, col: int, value, mask: torch.Tensor) -> None:
    """arr[:, col] = value where mask (B,), in place."""
    arr[:, col] = torch.where(
        mask.view((-1,) + (1,) * (arr.dim() - 2)),
        torch.as_tensor(value, dtype=arr.dtype, device=arr.device),
        arr[:, col],
    )


class MCTS:
    """Batched array-tree PUCT search over an :class:`Env`."""

    # Auto top-K clamp for large action spaces (the JAX package's
    # MCTS.AUTO_TOPK_CLAMP): K = simulations stays exact up to 256.
    AUTO_TOPK_CLAMP = 256

    def __init__(self, env: Env, cfg: MCTSConfig = MCTSConfig()):
        self.env = env
        self.cfg = cfg

    # -- tree construction -------------------------------------------------

    def prior_width(self, simulations: int) -> int:
        """K of the stored prior rows. cfg.topk_actions: 0 = auto
        (min(simulations, A), clamped to AUTO_TOPK_CLAMP when A > 2 *
        AUTO_TOPK_CLAMP), -1 = full width, > 0 = explicit."""
        a = self.env.num_actions
        if self.cfg.topk_actions < 0:
            return a
        if self.cfg.topk_actions > 0:
            return min(self.cfg.topk_actions, a)
        k = min(simulations, a)
        if a > 2 * self.AUTO_TOPK_CLAMP:
            k = min(k, self.AUTO_TOPK_CLAMP)
        return k

    def init_tree(self, root_states, num_nodes: int,
                  prior_width: Optional[int] = None) -> Tree:
        """Fresh trees with the root in slot 0."""
        env, n, a = self.env, num_nodes, self.env.num_actions
        k = a if prior_width is None else prior_width
        compressed = k < a
        root_terminal = env.is_terminal(root_states)
        bsz = root_terminal.shape[0]
        dev = root_terminal.device

        def full(shape, value, dtype):
            return torch.full((bsz,) + shape, value, dtype=dtype, device=dev)

        f32, i32 = torch.float32, torch.int32
        is_terminal = full((n,), False, torch.bool)
        is_terminal[:, 0] = root_terminal
        reward = full((n,), 0.0, f32)
        # Value for the player who moved into the root; read only when the
        # root itself is terminal.
        reward[:, 0] = -env.terminal_value(root_states)
        return Tree(
            root_state=root_states,
            parent=full((n,), NO_PARENT, i32),
            parent_action=full((n,), 0, i32),
            visits=full((n,), 0.0, f32),
            value_sum=full((n,), 0.0, f32),
            prior=full((n, k), 0.0, f32),
            expanded=full((n,), False, torch.bool),
            is_terminal=is_terminal,
            reward=reward,
            value_evaluated=full((n,), 0.0, f32),
            node_count=full((), 1, i32),
            prior_acts=full((n, k), 0, i32) if compressed else None,
            parent_slot=full((n,), UNVISITED, i32) if compressed else None,
            root_prior=full((a,), 0.0, f32) if compressed else None,
            root_visits=full((a,), 0.0, f32) if compressed else None,
            root_value_sum=full((a,), 0.0, f32) if compressed else None,
            child_index=(full((n, k), UNVISITED, i32)
                         if compressed and self.cfg.fast_edge_stats
                         else None),
        )

    # -- scores, priors and noise ---------------------------------------------

    def _ucb_scores(self, prior, nv, w):
        """(..., A) PUCT scores; illegal (prior 0) slots score the float32
        minimum. With zero sibling visits every legal action scores 0 and
        the lowest one wins (the reference's quirk)."""
        q = torch.where(nv > 0, w / nv.clamp_min(1.0), 0.0)
        u = (self.cfg.c_puct * prior * torch.sqrt(nv.sum(-1, keepdim=True))
             / (1.0 + nv))
        return torch.where(prior > 0, q + u, _NEG_INF)

    def _ucb_action(self, prior, nv, w):
        """(...,) PUCT argmax, the first maximum (lowest action)."""
        return self._ucb_scores(prior, nv, w).argmax(-1)

    def noise_plan(self, generator: Optional[torch.Generator],
                   simulations: int, batch: int, device,
                   out: Optional[torch.Tensor] = None
                   ) -> Optional[torch.Tensor]:
        """The search's root noise: every wave's (B, A) Gamma draw as one
        (S, B, A) float32 block, one ``safe_gamma`` call on ``generator``
        (written into ``out`` when given); None when noise is off."""
        if not self.cfg.use_dirichlet:
            return None
        if generator is None:
            raise ValueError("use_dirichlet needs a torch.Generator")
        return safe_gamma(generator, self.cfg.dirichlet_alpha,
                          (simulations, batch, self.env.num_actions), device,
                          out=out)

    def root_gamma(self, plan: Optional[torch.Tensor],
                   gamma: Optional[torch.Tensor],
                   wave: int) -> Optional[torch.Tensor]:
        """Wave ``wave``'s (B, A) root-noise draw: ``gamma[wave]`` when the
        caller gives (S, B, A) draws, else ``plan[wave]``; None when noise
        is off."""
        if not self.cfg.use_dirichlet:
            return None
        return (gamma if gamma is not None else plan)[wave]

    def _root_noisy_prior(self, root_prior: torch.Tensor,
                          gamma: Optional[torch.Tensor]) -> torch.Tensor:
        """The root prior mixed with this wave's noise (``root_noisy_prior``),
        or as it is when noise is off."""
        if not self.cfg.use_dirichlet:
            return root_prior
        return root_noisy_prior(root_prior, gamma,
                                self.cfg.dirichlet_fraction)

    # -- select and backup ---------------------------------------------------

    def _descend(self, tree: Tree, best_a, best_child):
        """SELECT: walk each game from the root along the per-wave
        (best_a, best_child) tables (B, N), carrying the env state with
        ``step_lite``, until a terminal node, an unexpanded node or an edge
        without a child. Returns (node, action, code, state)."""
        bsz, n = tree.parent.shape
        dev = tree.parent.device
        batch = torch.arange(bsz, device=dev)
        node = torch.zeros(bsz, dtype=torch.long, device=dev)
        action = torch.zeros(bsz, dtype=torch.long, device=dev)
        code = torch.full((bsz,), _CONTINUE, dtype=torch.long, device=dev)
        state = tree.root_state
        # A path has at most N nodes: children are newer than parents.
        for _ in range(n):
            cont = code == _CONTINUE
            if not bool(cont.any()):
                break
            child = best_child[batch, node]
            new_code = torch.where(
                ~cont, code,
                torch.where(
                    tree.is_terminal[batch, node], _TERMINAL,
                    torch.where(~tree.expanded[batch, node], _UNEXPANDED,
                                torch.where(child == UNVISITED, _NEW,
                                            _CONTINUE)),
                ),
            )
            action = torch.where(cont, best_a[batch, node], action)
            descend = new_code == _CONTINUE
            state = self.env.step_lite(state, action).where(descend, state)
            node = torch.where(descend, child, node)
            code = new_code
        return node, action, code, state

    def _backup(self, tree: Tree, leaf, leaf_value):
        """BACKUP: add the leaf value along the parent chain, the sign
        alternating per ply; a root leaf backs nothing up. Returns the
        value backed into each game's root edge and whether there was one
        (the top-K layout's root statistics)."""
        bsz, n = tree.parent.shape
        batch = torch.arange(bsz, device=leaf.device)
        root_val = torch.zeros(bsz, device=leaf.device)
        root_hit = torch.zeros(bsz, dtype=torch.bool, device=leaf.device)
        bnode, bvalue = leaf, leaf_value
        for _ in range(n):
            active = bnode > 0
            if not bool(active.any()):
                break
            tree.visits[batch, bnode] += active.float()
            tree.value_sum[batch, bnode] += torch.where(active, bvalue, 0.0)
            parent = tree.parent[batch, bnode].long()
            is_root_edge = active & (parent == 0)
            root_val = torch.where(is_root_edge, bvalue, root_val)
            root_hit = root_hit | is_root_edge
            bnode = torch.where(active, parent, bnode)
            bvalue = -bvalue
        return root_val, root_hit

    # -- batched search ------------------------------------------------------

    def search(self, root_states, evaluate_fn: EvaluateFn,
               generator: Optional[torch.Generator], simulations: int,
               gamma: Optional[torch.Tensor] = None) -> Tree:
        """Run ``simulations`` PUCT simulations from a batch of roots.

        evaluate_fn: (B, H, W, C) observations -> (probs (B, A), value
            (B,)), the batched network forward.
        generator: draws the root noise when ``cfg.use_dirichlet``: one
            (S, B, A) Gamma block (``noise_plan``) before the simulations.
        gamma: optional (S, B, A) draws used instead of the generator
            (tests feed JAX's draws through it).
        """
        env, cfg = self.env, self.cfg
        n = max(cfg.max_nodes, simulations)
        a = env.num_actions
        k = self.prior_width(simulations)
        compressed = k < a
        tree = self.init_tree(root_states, n, k)
        bsz = tree.parent.shape[0]
        dev = tree.parent.device
        batch = torch.arange(bsz, device=dev)
        plan = None if gamma is not None else self.noise_plan(
            generator, simulations, bsz, dev)
        # Child slot of each (node, prior slot) edge. In the top-K layout
        # the root's row stays empty: its children are in root_children,
        # by action.
        children = (tree.child_index if tree.child_index is not None
                    else torch.full((bsz, n, k), UNVISITED, dtype=torch.int32,
                                    device=dev))
        if compressed:
            root_children = torch.full((bsz, a), UNVISITED,
                                       dtype=torch.int32, device=dev)

        for i in range(simulations):
            root_prior = self._root_noisy_prior(
                tree.root_prior if compressed else tree.prior[:, 0],
                self.root_gamma(plan, gamma, i),
            )

            # Per-wave PUCT choice of every node (stats frozen in a wave).
            has = children >= 0
            flat = children.clamp_min(0).long().view(bsz, n * k)
            nv = torch.where(has, tree.visits.gather(1, flat).view(bsz, n, k),
                             0.0)
            w = torch.where(has,
                            tree.value_sum.gather(1, flat).view(bsz, n, k),
                            0.0)
            if compressed:
                # Ties go to the lowest ACTION, as at full width: take the
                # smallest tied action, then find its slot.
                score = self._ucb_scores(tree.prior, nv, w)
                tied = score == score.max(-1, keepdim=True).values
                best_a = torch.where(tied, tree.prior_acts, a).min(-1).values
                best_k = (tied & (tree.prior_acts == best_a[..., None])) \
                    .to(torch.uint8).argmax(-1)
                root_best = self._ucb_action(root_prior, tree.root_visits,
                                             tree.root_value_sum)
                best_a = best_a.long()
                best_a[:, 0] = root_best
                best_child = children.gather(2, best_k[..., None])[..., 0]
                best_child[:, 0] = root_children.gather(
                    1, root_best[:, None])[:, 0]
            else:
                prior_eff = tree.prior.clone()
                prior_eff[:, 0] = root_prior
                best_a = self._ucb_action(prior_eff, nv, w)  # (B, N)
                best_child = children.gather(2, best_a[..., None])[..., 0]
            best_child = best_child.long()

            node, action, code, state = self._descend(tree, best_a,
                                                      best_child)

            # CREATE the selected child in slot i and EVALUATE the leaves.
            new = code == _NEW
            child_state, reward = env.step(state, action)
            leaf = torch.where(new, i, node)
            leaf_state = child_state.where(new, state)
            child_terminal = env.is_terminal(child_state)
            leaf_terminal = torch.where(new, child_terminal,
                                        tree.is_terminal[batch, node])
            leaf_reward = torch.where(new, reward, tree.reward[batch, node])
            probs, values = evaluate_fn(env.observe(leaf_state))
            probs = probs.float()
            values = values.float().reshape(bsz)

            _write(tree.parent, i, node, new)
            _write(tree.parent_action, i, action, new)
            _write(tree.is_terminal, i, child_terminal, new)
            _write(tree.reward, i, reward, new)
            tree.node_count += new.to(torch.int32)
            if compressed:
                sel_slot = torch.where(node == 0, UNVISITED,
                                       best_k[batch, node])
                _write(tree.parent_slot, i, sel_slot, new)
                slot = sel_slot.clamp_min(0)
                children[batch, node, slot] = torch.where(
                    new & (node > 0), i, children[batch, node, slot])
                root_children[batch, action] = torch.where(
                    new & (node == 0), i, root_children[batch, action])
            else:
                children[batch, node, action] = torch.where(
                    new, i, children[batch, node, action])

            # EXPAND the leaf unless terminal or already expanded. A leaf to
            # expand is always in slot i (a new child, or the root at
            # wave 0).
            do = ~tree.expanded[batch, leaf] & ~leaf_terminal
            legal = env.legal_mask(leaf_state)
            renormed = renormalize(probs, legal)
            if compressed:
                # Slot 0: the lowest legal action (a node's first child),
                # boosted above every prior and then given back its own;
                # slots 1..: the top K-1 others, ties to the lower action.
                a0 = legal.to(torch.uint8).argmax(-1)
                a0_oh = torch.arange(a, device=dev)[None, :] == a0[:, None]
                boosted = renormed + a0_oh.float() * 2.0
                top_vals, top_acts = torch.sort(boosted, dim=-1,
                                                descending=True, stable=True)
                top_vals = top_vals[:, :k].clone()
                top_vals[:, 0] = renormed[batch, a0]
                _write(tree.prior, i, top_vals, do)
                _write(tree.prior_acts, i, top_acts[:, :k], do)
                expand_root = (do & (leaf == 0))[:, None]
                tree.root_prior = torch.where(expand_root, renormed,
                                              tree.root_prior)
            else:
                _write(tree.prior, i, renormed, do)
            _write(tree.value_evaluated, i, values, do)
            _write(tree.expanded, i, True, do)

            leaf_value = torch.where(leaf_terminal, leaf_reward, -values)
            root_val, root_hit = self._backup(tree, leaf, leaf_value)
            if compressed:
                # The root edge of the wave's path is the root's choice.
                root_a = best_a[:, 0]
                tree.root_visits[batch, root_a] += root_hit.float()
                tree.root_value_sum[batch, root_a] += torch.where(
                    root_hit, root_val, 0.0)
        return tree

    # -- subtree reuse across moves ------------------------------------------
    #
    # ``advance_root`` re-roots each game's searched tree at its played
    # child, compacting the kept subtree into the low slots (ranked by edge
    # visits, truncated to ``keep_cap``), and ``search_tree`` runs more
    # simulations on a carried tree, each game's next node going to its own
    # ``free`` cursor. The kept root arrives expanded, so every simulation
    # backs up. The visit ranking is parent-closed (an edge has at least the
    # visits of any edge below it, and stable sorting keeps the older slot,
    # the parent, first on a tie), so truncation leaves no dangling node.
    # Full-width priors only, as in JAX.

    @staticmethod
    def _check_full_width(tree: Tree) -> None:
        if tree.prior_acts is not None:
            raise ValueError("subtree reuse requires full-width priors "
                             "(topk_actions=-1)")

    def advance_root(self, tree: Tree, actions: torch.Tensor, keep_cap: int,
                     new_root_states):
        """Re-root each game's tree at the child reached by ``actions``.

        new_root_states: the stepped root states.
        Returns (tree, free): a new tree, and (B,) int32 occupied low slots.
        A game whose played child has no node (a zero-visit action) gets a
        fresh, unexpanded root, as the reference's never-evaluated child."""
        self._check_full_width(tree)
        env = self.env
        bsz, n = tree.parent.shape
        dev = tree.parent.device
        idx = torch.arange(n, device=dev)[None, :]

        # The played child c* of the root (-1 where none exists).
        match = (tree.parent == 0) & (tree.parent_action == actions[:, None])
        cstar = torch.where(match, idx, UNVISITED).max(1).values

        # Descendants of c*, c* included, by ancestor pointer doubling.
        anc = torch.where(tree.parent < 0, idx, tree.parent.long())
        desc = idx == cstar[:, None]
        hops = 1
        while hops < n:
            desc = desc | desc.gather(1, anc)
            anc = anc.gather(1, anc)
            hops *= 2

        # Rank the descendants by edge visits, most first; the stable sort
        # keeps slot order on ties. The rest sorts to the back.
        key = torch.where(desc, -tree.visits.to(torch.int32),
                          torch.iinfo(torch.int32).max)
        order = torch.argsort(key, dim=1, stable=True)  # rank -> old slot
        rank = torch.empty_like(order).scatter_(1, order,
                                                idx.expand(bsz, n))
        keep = torch.clamp(desc.sum(1), max=keep_cap).to(torch.int32)
        kept = idx < keep[:, None]  # (B, N) in the rank frame

        def permute(arr, fill):
            ix = order if arr.dim() == 2 else order[:, :, None].expand(
                -1, -1, arr.shape[2])
            cond = kept if arr.dim() == 2 else kept[:, :, None]
            return torch.where(cond, arr.gather(1, ix),
                               torch.tensor(fill, dtype=arr.dtype,
                                            device=dev))

        # Parent pointers in the rank frame; the new root has none.
        parent_old = permute(tree.parent, 0).long()
        parent = torch.where(kept, rank.gather(1, parent_old), NO_PARENT)
        parent = parent.to(torch.int32)
        parent[:, 0] = NO_PARENT

        empty = keep == 0  # nothing carried: a fresh root in slot 0
        visits = permute(tree.visits, 0.0)
        value_sum = permute(tree.value_sum, 0.0)
        # The edge into the new root went with its parent.
        visits[:, 0] = 0.0
        value_sum[:, 0] = 0.0
        is_terminal = permute(tree.is_terminal, False)
        is_terminal[:, 0] = torch.where(
            empty, env.is_terminal(new_root_states), is_terminal[:, 0])
        reward = permute(tree.reward, 0.0)
        reward[:, 0] = torch.where(
            empty, -env.terminal_value(new_root_states), reward[:, 0])
        free = keep.clamp_min(1)
        new_tree = Tree(
            root_state=new_root_states,
            parent=parent,
            parent_action=permute(tree.parent_action, 0),
            visits=visits,
            value_sum=value_sum,
            prior=permute(tree.prior, 0.0),
            expanded=permute(tree.expanded, False),
            is_terminal=is_terminal,
            reward=reward,
            value_evaluated=permute(tree.value_evaluated, 0.0),
            node_count=free.clone(),
        )
        return new_tree, free

    def _child_table(self, tree: Tree) -> torch.Tensor:
        """(B, N, A) int32 child slot of each (node, action) edge, -1 where
        none, rebuilt from ``parent`` / ``parent_action``."""
        bsz, n = tree.parent.shape
        dev = tree.parent.device
        table = torch.full((bsz, n + 1, self.env.num_actions), UNVISITED,
                           dtype=torch.int32, device=dev)
        # Unlinked slots write to a spare row.
        rows = torch.where(tree.parent >= 0, tree.parent.long(), n)
        table[torch.arange(bsz, device=dev)[:, None], rows,
              tree.parent_action.long()] = torch.arange(
                  n, dtype=torch.int32, device=dev).expand(bsz, n)
        return table[:, :n]

    def search_tree(self, tree: Tree, free: torch.Tensor,
                    evaluate_fn: EvaluateFn,
                    generator: Optional[torch.Generator], simulations: int,
                    gamma: Optional[torch.Tensor] = None):
        """Run ``simulations`` more PUCT simulations on a carried tree.

        free: (B,) int32 occupied slots per game, the next node's slot. The
        tree needs room for ``simulations`` more nodes in every game
        (``advance_root(keep_cap=capacity - simulations)`` leaves it).
        generator, gamma: the root noise, one (B, A) Gamma draw per
        simulation, drawn as one block as in ``search``.
        Updates ``tree`` in place; returns (tree, free)."""
        self._check_full_width(tree)
        env = self.env
        bsz, n = tree.parent.shape
        if int(free.max()) + simulations > n:
            raise ValueError(
                f"search_tree: {simulations} simulations need "
                f"{int(free.max()) + simulations} slots, the tree has {n}")
        dev = tree.parent.device
        batch = torch.arange(bsz, device=dev)
        plan = None if gamma is not None else self.noise_plan(
            generator, simulations, bsz, dev)
        children = self._child_table(tree)
        free = free.clone()

        def write(arr, slot, value, mask):
            """arr[b, slot[b]] = value[b] where mask[b], in place."""
            cur = arr[batch, slot]
            m = mask.view((-1,) + (1,) * (cur.dim() - 1))
            arr[batch, slot] = torch.where(
                m, torch.as_tensor(value, dtype=arr.dtype, device=dev), cur)

        for i in range(simulations):
            root_prior = self._root_noisy_prior(
                tree.prior[:, 0], self.root_gamma(plan, gamma, i))
            has = children >= 0
            flat = children.clamp_min(0).long().view(bsz, -1)
            nv = torch.where(has, tree.visits.gather(1, flat).view_as(has),
                             0.0)
            w = torch.where(has, tree.value_sum.gather(1, flat).view_as(has),
                            0.0)
            prior_eff = tree.prior.clone()
            prior_eff[:, 0] = root_prior
            best_a = self._ucb_action(prior_eff, nv, w)  # (B, N)
            best_child = children.gather(2, best_a[..., None])[..., 0].long()

            node, action, code, state = self._descend(tree, best_a,
                                                      best_child)

            # CREATE the selected child at each game's cursor.
            new = code == _NEW
            slot = free.long()
            child_state, reward = env.step(state, action)
            leaf = torch.where(new, slot, node)
            leaf_state = child_state.where(new, state)
            child_terminal = env.is_terminal(child_state)
            leaf_terminal = torch.where(new, child_terminal,
                                        tree.is_terminal[batch, node])
            leaf_reward = torch.where(new, reward, tree.reward[batch, node])
            probs, values = evaluate_fn(env.observe(leaf_state))
            probs = probs.float()
            values = values.float().reshape(bsz)

            write(tree.parent, slot, node, new)
            write(tree.parent_action, slot, action, new)
            write(tree.is_terminal, slot, child_terminal, new)
            write(tree.reward, slot, reward, new)
            tree.node_count += new.to(torch.int32)
            children[batch, node, action] = torch.where(
                new, slot.to(torch.int32), children[batch, node, action])
            free += new.to(torch.int32)

            # EXPAND the leaf: a new child, or a fresh root.
            do = ~tree.expanded[batch, leaf] & ~leaf_terminal
            renormed = renormalize(probs, env.legal_mask(leaf_state))
            write(tree.prior, leaf, renormed, do)
            write(tree.value_evaluated, leaf, values, do)
            write(tree.expanded, leaf, True, do)

            leaf_value = torch.where(leaf_terminal, leaf_reward, -values)
            self._backup(tree, leaf, leaf_value)
        return tree, free

    # -- outputs -------------------------------------------------------------

    def _root_edges(self, tree: Tree, stat: torch.Tensor) -> torch.Tensor:
        """(B, A) per-node ``stat`` of each root child, 0 where none."""
        a = self.env.num_actions
        is_child = tree.parent == 0
        # Non-children go to a spare column; each root action has one child
        # at most.
        col = torch.where(is_child, tree.parent_action.long(), a)
        out = torch.zeros((stat.shape[0], a + 1), dtype=stat.dtype,
                          device=stat.device)
        out.scatter_(1, col, torch.where(is_child, stat, 0.0))
        return out[:, :a]

    def root_child_visits(self, tree: Tree) -> torch.Tensor:
        """(B, A) int32 edge visit counts at the root (the pi numerator)."""
        return self._root_edges(tree, tree.visits).to(torch.int32)

    def root_child_value_sums(self, tree: Tree) -> torch.Tensor:
        """(B, A) float32 summed backed-up edge values at the root."""
        return self._root_edges(tree, tree.value_sum)

    def root_q_values(self, tree: Tree) -> torch.Tensor:
        """(B, A) mean action values at the root."""
        nv = self.root_child_visits(tree).float()
        w = self.root_child_value_sums(tree)
        return torch.where(nv > 0, w / nv.clamp_min(1.0), 0.0)
