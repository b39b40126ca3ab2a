"""The comparisons that decide ``correct``: what the timed path produced,
judged by the plain reference (azbench/reference/).

Each function returns a number that a cell's limits file bounds: a count
of faults (limit 0) or a distance to the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from azbench.reference import codec as ref_codec
from azbench.reference import connect4


def selfplay_faults(obs: np.ndarray, pi: np.ndarray, z: np.ndarray,
                    valid: np.ndarray, n_in_row: int, sims: int,
                    greedy_from: int) -> Tuple[int, Dict[str, int]]:
    """Faults in one continuous Connect-4 generation of T plies x B games
    (obs (T, B, H, W, 4), pi (T, B, A), z and valid (T, B)), held to the
    rules: every observation well formed and the first empty; each next
    observation either the position after one legal move of the mover to
    a column the policy target gives weight (the game going on), or the
    empty board after a move that ended the game as z says; every policy
    target a distribution over legal moves, one-hot from ``greedy_from``
    plies on and else visit counts over ``sims - 1`` root visits; z the
    result of each finished game signed for the mover, and valid exactly
    the plies of finished games. Returns (rows at fault, faults by kind)."""
    t_len, bsz = valid.shape
    boards = connect4.boards_from_obs(obs)
    stones = (boards != 0).sum(axis=(-1, -2))
    bad = np.zeros((t_len, bsz), bool)
    kinds: Dict[str, int] = {}

    def flag(mask, kind):
        mask = np.asarray(mask, bool)
        if mask.any():
            kinds[kind] = kinds.get(kind, 0) + int(mask.sum())
        return mask

    bad |= flag(~connect4.well_formed(obs), "observation")
    bad[0] |= flag(stones[0] != 0, "first observation")

    # Policy targets.
    legal = connect4.legal(boards)
    bad |= flag((pi < 0).any(-1) | (np.abs(pi.sum(-1) - 1) > 1e-5),
                "policy not a distribution")
    bad |= flag(((pi > 0) & ~legal).any(-1), "policy on an illegal move")
    greedy = stones >= greedy_from
    one_hot = (pi == 1).sum(-1) == 1
    bad |= flag(greedy & ~one_hot, "greedy policy not one-hot")
    counts = pi * (sims - 1)
    integral = (np.abs(counts - np.round(counts)) < 1e-3).all(-1)
    bad |= flag(~greedy & ~integral, "policy not visit counts")

    # Transitions.
    ended = np.zeros((t_len, bsz), bool)
    result = np.zeros((t_len, bsz), np.float32)
    for t in range(t_len - 1):
        nxt = stones[t + 1]
        going = nxt == stones[t] + 1
        reset = nxt == 0
        bad[t] |= flag(~going & ~reset, "next observation")
        # The mover's one new stone: the lowest empty cell of a column the
        # target gives weight, after which the game goes on.
        placed = -boards[t + 1]
        delta = placed.astype(np.int16) - boards[t]
        single = ((delta != 0).sum(axis=(-1, -2)) == 1) & (
            delta.max(axis=(-1, -2)) == 1)
        flat = delta.reshape(bsz, -1).argmax(-1)
        row, col = flat // boards.shape[-1], flat % boards.shape[-1]
        below = np.where(row + 1 < boards.shape[-2],
                         boards[t, np.arange(bsz),
                                np.minimum(row + 1, boards.shape[-2] - 1),
                                col] != 0, True)
        weighted = pi[t, np.arange(bsz), col] > 0
        ends = (connect4.has_line(placed == 1, n_in_row)
                | (placed != 0).all(axis=(-1, -2)))
        bad[t] |= flag(going & ~(single & below & weighted), "move")
        bad[t] |= flag(going & single & ends, "game not ended")
        for b in np.nonzero(reset)[0]:
            ended[t, b] = True
            result[t, b] = z[t, b]
            bad[t, b] |= flag(not _can_end(boards[t, b], pi[t, b], z[t, b],
                                           n_in_row), "game end")
    last = t_len - 1
    for b in np.nonzero(valid[last])[0]:
        ended[last, b] = True
        result[last, b] = z[last, b]
        bad[last, b] |= flag(not _can_end(boards[last, b], pi[last, b],
                                          z[last, b], n_in_row), "game end")

    # Targets: z back from each game's end, valid on finished games only.
    for b in range(bsz):
        value, done = 0.0, False
        for t in range(last, -1, -1):
            if ended[t, b]:
                value, done = result[t, b], True
            elif done:
                value = -value
            if valid[t, b] != done or (done and z[t, b] != value):
                bad[t, b] |= flag(True, "value target")
    return int(bad.sum()), kinds


def _can_end(board, policy, z, n_in_row) -> bool:
    """Whether a move the policy gives weight ends the game from ``board``
    with the mover's result ``z`` (1 a win, 0 a draw)."""
    for col in np.nonzero(connect4.legal(board) & (policy > 0))[0]:
        _, won, drawn = connect4.play(board, int(col), n_in_row)
        if (z == 1 and won) or (z == 0 and drawn):
            return True
    return False


def ring_faults(words, scalars, policy, value, slots, obs, pi, z,
                shape, binary, constant=()) -> int:
    """Rows of the ring at ``slots`` whose decoding differs from the
    batch rows (obs, pi, z) that were added there."""
    decoded = ref_codec.decode(words[slots], scalars[slots], shape, binary,
                               constant)
    same = ((decoded == obs).all(axis=(1, 2, 3))
            & (policy[slots] == pi).all(-1) & (value[slots] == z))
    return int((~same).sum())


def visit_distance(program: np.ndarray, reference: np.ndarray) -> float:
    """Mean over roots of the total-variation distance between two root
    visit distributions (K, A)."""
    p = program / np.maximum(program.sum(-1, keepdims=True), 1)
    r = reference / np.maximum(reference.sum(-1, keepdims=True), 1)
    return float(0.5 * np.abs(p - r).sum(-1).mean())


def norm_gaps(program: Dict[str, np.ndarray],
              reference: Dict[str, np.ndarray], leaves) -> Dict[str, float]:
    """Per leaf, the gap between the program's and the reference's norm of
    a quantity, over the larger of the reference's norm of that leaf and
    the median leaf's."""
    ref = {k: float(np.linalg.norm(reference[k])) for k in leaves}
    median = float(np.median(list(ref.values())))
    return {k: abs(float(np.linalg.norm(program[k])) - ref[k])
            / max(ref[k], median, 1e-30) for k in leaves}
