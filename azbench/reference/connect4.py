"""Connect-4 rules on NumPy arrays, written from the game's rules.

A board is an int8 (H, W) array from the side to move's view: +1 its own
stones, -1 the opponent's, row 0 the top. After a move the board is negated
so that the next side to move is +1 again. A stone dropped in a column lands
on the lowest empty cell. A game ends when the mover makes n in a row
(horizontally, vertically or diagonally), a win for the mover, or when the
board fills, a draw.

The observation of a board is (H, W, 4) float32: planes [empty, own,
opponent, ones].
"""

from __future__ import annotations

import numpy as np

DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


def observe(boards: np.ndarray) -> np.ndarray:
    """(..., H, W) boards -> (..., H, W, 4) float32 observations."""
    b = np.asarray(boards)
    return np.stack([b == 0, b == 1, b == -1, np.ones_like(b, bool)],
                    axis=-1).astype(np.float32)


def boards_from_obs(obs: np.ndarray) -> np.ndarray:
    """(..., H, W, 4) observations -> (..., H, W) int8 boards."""
    o = np.asarray(obs)
    own = (o[..., 1] > 0.5).astype(np.int8)
    return own - (o[..., 2] > 0.5).astype(np.int8)


def well_formed(obs: np.ndarray) -> np.ndarray:
    """(..., H, W, 4) -> (...) bool: every value 0 or 1, exactly one of the
    first three planes set per cell, the last plane all ones, and stones
    stacked from the bottom of each column."""
    o = np.asarray(obs)
    binary = ((o == 0) | (o == 1)).all(axis=(-1, -2, -3))
    one_hot = (o[..., :3].sum(-1) == 1).all(axis=(-1, -2))
    ones = (o[..., 3] == 1).all(axis=(-1, -2))
    filled = o[..., 0] < 0.5
    # A filled cell never sits above an empty one.
    stacked = ~(filled[..., :-1, :] & ~filled[..., 1:, :]).any(axis=(-1, -2))
    return binary & one_hot & ones & stacked


def legal(boards: np.ndarray) -> np.ndarray:
    """(..., H, W) -> (..., W) bool: columns with an empty top cell."""
    return np.asarray(boards)[..., 0, :] == 0


def drop_row(board: np.ndarray, col: int) -> int:
    """The row a stone dropped in ``col`` lands on (-1 if full)."""
    empty = np.nonzero(board[:, col] == 0)[0]
    return int(empty[-1]) if len(empty) else -1


def makes_line(board: np.ndarray, row: int, col: int, n: int) -> bool:
    """Whether the +1 stone at (row, col) is part of n in a row."""
    h, w = board.shape
    for dr, dc in DIRECTIONS:
        count = 1
        for sign in (1, -1):
            r, c = row + sign * dr, col + sign * dc
            while 0 <= r < h and 0 <= c < w and board[r, c] == 1:
                count += 1
                r, c = r + sign * dr, c + sign * dc
        if count >= n:
            return True
    return False


def has_line(planes: np.ndarray, n: int) -> np.ndarray:
    """(..., H, W) bool planes -> (...) bool: n set cells in a row along a
    row, a column or a diagonal."""
    p = np.asarray(planes, bool)
    h, w = p.shape[-2:]
    found = np.zeros(p.shape[:-2], bool)
    for dr, dc in DIRECTIONS:
        rows = range(0, h - (n - 1) * dr)
        cols = range(max(0, -(n - 1) * dc), w - max(0, (n - 1) * dc))
        run = np.ones(p.shape[:-2] + (len(rows), len(cols)), bool)
        for i in range(n):
            r0, c0 = rows.start + i * dr, cols.start + i * dc
            run &= p[..., r0:r0 + len(rows), c0:c0 + len(cols)]
        found |= run.any(axis=(-1, -2))
    return found


def play(board: np.ndarray, col: int, n: int):
    """Drop the mover's stone in ``col``: (next board from the next mover's
    view, won, drawn). Raises on a full column."""
    row = drop_row(board, col)
    if row < 0:
        raise ValueError(f"column {col} is full")
    placed = board.copy()
    placed[row, col] = 1
    won = makes_line(placed, row, col, n)
    drawn = not won and bool((placed != 0).all())
    return -placed, won, drawn


def random_positions(rng: np.random.Generator, count: int, height: int,
                     width: int, n: int, max_plies: int) -> np.ndarray:
    """``count`` boards reached by 0..max_plies uniformly random legal moves
    from the empty board, none of them finished: (count, H, W) int8."""
    out = np.zeros((count, height, width), np.int8)
    for i in range(count):
        target = int(rng.integers(0, max_plies + 1))
        board = np.zeros((height, width), np.int8)
        for _ in range(target):
            cols = np.nonzero(legal(board))[0]
            col = int(rng.choice(cols))
            nxt, won, drawn = play(board, col, n)
            if won or drawn:
                break  # keep the last unfinished position
            board = nxt
        out[i] = board
    return out
