"""Fresh-tree PUCT search from Connect-4 roots, with per-simulation root
noise, written from the AlphaZero search as this system specifies it.

One simulation per root per wave, every root of a batch in lockstep:

- wave 0 evaluates the root; the simulation that evaluates the root backs
  nothing up, so ``sims`` waves give ``sims - 1`` root visits;
- at wave w >= 1 the previous wave's leaf is expanded (unless terminal or
  already expanded) with the net's probabilities masked to its legal moves
  and renormalised (uniform over legal moves if the mass is zero, a floor
  of 1e-35 on legal moves), and its value is backed up: a terminal leaf
  gives the reward of the move into it (1 for a win, 0 for a draw), a net
  leaf minus the net's value, and the sign flips at every edge towards the
  root;
- the root's priors, captured when it is expanded, are mixed at every wave
  w < sims with that wave's Dirichlet draw over the legal root moves:
  ``(1 - f) * P + f * g / sum(g)`` for the wave's Gamma draws g;
- selection descends by the first maximum of ``Q + c * P * sqrt(sum N) /
  (1 + N)`` over legal moves (Q = W / max(N, 1), so unvisited edges read 0)
  until it meets a terminal node, an unexpanded node, or an edge with no
  child, whose child it creates;
- after the last wave (the drain) only the backup runs.

The net is a callable (K, H, W, 4) float32 observations -> (probabilities
(K, A), values (K,)), called once per wave for all roots.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from azbench.reference import connect4

Evaluate = Callable[[np.ndarray], tuple]


def renormalize(probs: np.ndarray, legal: np.ndarray) -> np.ndarray:
    masked = np.where(legal, probs, 0).astype(np.float32)
    total = masked.sum(-1, keepdims=True, dtype=np.float32)
    count = np.maximum(legal.sum(-1, keepdims=True), 1).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(total > 0, masked / np.maximum(total, 1e-30),
                       legal / count).astype(np.float32)
    return np.where(legal, np.maximum(out, np.float32(1e-35)),
                    0).astype(np.float32)


def mix_noise(prior: np.ndarray, gamma: np.ndarray,
              fraction: float) -> np.ndarray:
    legal = prior > 0
    g = np.where(legal, gamma, 0).astype(np.float32)
    noise = g / np.maximum(g.sum(-1, keepdims=True, dtype=np.float32),
                           np.float32(1e-30))
    mixed = (np.float32(1 - fraction) * prior
             + np.float32(fraction) * noise).astype(np.float32)
    return np.where(legal, np.maximum(mixed, np.float32(1e-35)),
                    0).astype(np.float32)


def search(roots: np.ndarray, evaluate: Evaluate, sims: int, c_puct: float,
           n_in_row: int, gamma: Optional[np.ndarray] = None,
           fraction: float = 0.25) -> np.ndarray:
    """Root visit counts (K, A) of ``sims``-wave searches from ``roots``
    (K, H, W) int8. ``gamma``: (sims, K, A) Gamma draws, or None (no
    noise)."""
    k, h, w = roots.shape
    a = w
    n = sims + 1
    rows = np.arange(k)
    board = np.zeros((k, n, h, w), np.int8)
    board[:, 0] = roots
    parent = np.full((k, n), -1, np.int64)
    parent_action = np.full((k, n), -1, np.int64)
    expanded = np.zeros((k, n), bool)
    terminal = np.zeros((k, n), bool)
    won = np.zeros((k, n), bool)
    prior = np.zeros((k, n, a), np.float32)
    child = np.full((k, n, a), -1, np.int64)
    visits = np.zeros((k, n, a), np.float32)
    value_sum = np.zeros((k, n, a), np.float32)
    count = np.ones(k, np.int64)
    root_prior = np.zeros((k, a), np.float32)
    c = np.float32(c_puct)

    leaf = np.zeros(k, np.int64)
    probs, value = evaluate(connect4.observe(board[rows, leaf]))
    for wave in range(1, sims + 1):
        # Expand and back up the previous wave's leaf.
        leaf_term = terminal[rows, leaf]
        legal = connect4.legal(board[rows, leaf]) & ~leaf_term[:, None]
        renormed = renormalize(np.asarray(probs, np.float32), legal)
        grow = ~expanded[rows, leaf] & ~leaf_term
        prior[rows[grow], leaf[grow]] = renormed[grow]
        expanded[rows[grow], leaf[grow]] = True
        if wave == 1:
            root_prior = np.where(~terminal[:, 0, None], renormed, root_prior)
        backed = np.where(leaf_term, won[rows, leaf].astype(np.float32),
                          -np.asarray(value, np.float32)).astype(np.float32)
        node = leaf.copy()
        while True:
            up = node > 0
            if not up.any():
                break
            r = rows[up]
            p, act = parent[r, node[up]], parent_action[r, node[up]]
            visits[r, p, act] += 1
            value_sum[r, p, act] += backed[up]
            node = np.where(up, parent[rows, node], node)
            backed = -backed
        if wave == sims:
            break

        mixed = (root_prior if gamma is None
                 else mix_noise(root_prior, gamma[wave], fraction))
        # Select, then create.
        node = np.zeros(k, np.int64)
        going = np.ones(k, bool)
        leaf = np.zeros(k, np.int64)
        while going.any():
            stop = going & (terminal[rows, node] | ~expanded[rows, node])
            leaf[stop] = node[stop]
            going &= ~stop
            if not going.any():
                break
            p = np.where((node == 0)[:, None], mixed, prior[rows, node])
            nv = visits[rows, node]
            q = value_sum[rows, node] / np.maximum(nv, np.float32(1))
            u = c * p * np.sqrt(nv.sum(-1, keepdims=True,
                                       dtype=np.float32)) / (1 + nv)
            score = np.where(p > 0, q + u, -np.inf)
            best = score.argmax(-1)
            nxt = child[rows, node, best]
            for r in np.nonzero(going & (nxt < 0))[0]:
                slot = count[r]
                count[r] += 1
                after, win, draw = connect4.play(board[r, node[r]],
                                                 int(best[r]), n_in_row)
                board[r, slot] = after
                parent[r, slot] = node[r]
                parent_action[r, slot] = best[r]
                child[r, node[r], best[r]] = slot
                terminal[r, slot] = win or draw
                won[r, slot] = win
                leaf[r] = slot
                going[r] = False
            node = np.where(going, nxt, node)
        probs, value = evaluate(connect4.observe(board[rows, leaf]))
    return visits[:, 0, :].astype(np.int64)
