"""Precomputed chess tables (host-side numpy; the engine moves them to the
device once per device).

An own copy of the JAX package's custom_alphazero_tpu/envs/chess/tables.py,
value for value: the fixed 1968-action space and the geometric lookup
tables that make legal-move generation a gather/compare computation, and
the Zobrist tables from the same seeded generator, so the repetition hashes
of both packages are equal bit for bit.

Action space: every queen-ray and knight from->to pair (1792 plain UCI
moves; castling is e1g1/e1c1) plus promotion moves with explicit n/b/r/q
suffixes for every promotion-capable pair, straight pushes and capture
diagonals, both colours (176). Total 1968, sorted by UCI string.

Geometry: squares are in the canonical side-to-move perspective,
sq = rank * 8 + file, a1 = 0, h8 = 63, rank 0 = the mover's back rank.
Mirroring flips ranks only.
"""

from __future__ import annotations

import numpy as np

# Piece codes (canonical: positive = side to move).
EMPTY, PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING = 0, 1, 2, 3, 4, 5, 6

# Ray directions (drank, dfile): N, NE, E, SE, S, SW, W, NW.
DIRECTIONS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))
DIAGONAL_DIRS = (1, 3, 5, 7)
ORTHOGONAL_DIRS = (0, 2, 4, 6)

KNIGHT_OFFSETS = ((2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2), (1, -2), (2, -1))

PROMO_SUFFIX = {"n": KNIGHT, "b": BISHOP, "r": ROOK, "q": QUEEN}


def sq_name(sq: int) -> str:
    return chr(ord("a") + sq % 8) + str(sq // 8 + 1)


def name_sq(name: str) -> int:
    return (int(name[1]) - 1) * 8 + (ord(name[0]) - ord("a"))


def _build_actions():
    actions = {}  # uci -> (from, to, promo, dir, dist, is_knight)
    for frm in range(64):
        r, f = divmod(frm, 8)
        for d, (dr, df) in enumerate(DIRECTIONS):
            for dist in range(1, 8):
                rr, ff = r + dr * dist, f + df * dist
                if not (0 <= rr < 8 and 0 <= ff < 8):
                    break
                to = rr * 8 + ff
                actions[sq_name(frm) + sq_name(to)] = (frm, to, 0, d, dist, False)
        for dr, df in KNIGHT_OFFSETS:
            rr, ff = r + dr, f + df
            if 0 <= rr < 8 and 0 <= ff < 8:
                to = rr * 8 + ff
                actions[sq_name(frm) + sq_name(to)] = (frm, to, 0, -1, 0, True)
    # Promotions: from rank 7 to 8 (white) and rank 2 to 1 (black side of the
    # shared table), straight and capture diagonals, all four suffixes.
    for r_from, r_to in ((6, 7), (1, 0)):
        for f in range(8):
            for df in (-1, 0, 1):
                ff = f + df
                if not 0 <= ff < 8:
                    continue
                frm, to = r_from * 8 + f, r_to * 8 + ff
                base = sq_name(frm) + sq_name(to)
                # Direction of the underlying ray (N-ish or S-ish family).
                dr = 1 if r_to > r_from else -1
                d = DIRECTIONS.index((dr, df))
                for suffix, code in PROMO_SUFFIX.items():
                    actions[base + suffix] = (frm, to, code, d, 1, False)
    ucis = sorted(actions)
    return ucis, actions


_UCIS, _ACTIONS = _build_actions()

NUM_ACTIONS = len(_UCIS)
assert NUM_ACTIONS == 1968, NUM_ACTIONS

ACTION_UCI = list(_UCIS)
ACTION_INDEX = {uci: i for i, uci in enumerate(_UCIS)}

FROM = np.array([_ACTIONS[u][0] for u in _UCIS], np.int32)
TO = np.array([_ACTIONS[u][1] for u in _UCIS], np.int32)
PROMO = np.array([_ACTIONS[u][2] for u in _UCIS], np.int32)
DIR = np.array([_ACTIONS[u][3] for u in _UCIS], np.int32)   # -1 for knight
DIST = np.array([_ACTIONS[u][4] for u in _UCIS], np.int32)  # 0 for knight
IS_KNIGHT = np.array([_ACTIONS[u][5] for u in _UCIS], bool)

# Squares strictly between from and to along the ray (max 6), padded -1.
BETWEEN = np.full((NUM_ACTIONS, 6), -1, np.int32)
for i, u in enumerate(_UCIS):
    frm, to, promo, d, dist, is_n = _ACTIONS[u]
    if is_n or dist <= 1:
        continue
    dr, df = DIRECTIONS[d]
    r, f = divmod(frm, 8)
    for k in range(1, dist):
        BETWEEN[i, k - 1] = (r + dr * k) * 8 + (f + df * k)

# Ray walk tables: RAY[sq, dir, step] = square index or -1.
RAY = np.full((64, 8, 7), -1, np.int32)
for sq in range(64):
    r, f = divmod(sq, 8)
    for d, (dr, df) in enumerate(DIRECTIONS):
        for k in range(1, 8):
            rr, ff = r + dr * k, f + df * k
            if not (0 <= rr < 8 and 0 <= ff < 8):
                break
            RAY[sq, d, k - 1] = rr * 8 + ff

# Knight / king adjacency: targets or -1.
KNIGHT_TARGETS = np.full((64, 8), -1, np.int32)
KING_TARGETS = np.full((64, 8), -1, np.int32)
for sq in range(64):
    r, f = divmod(sq, 8)
    for j, (dr, df) in enumerate(KNIGHT_OFFSETS):
        rr, ff = r + dr, f + df
        if 0 <= rr < 8 and 0 <= ff < 8:
            KNIGHT_TARGETS[sq, j] = rr * 8 + ff
    for j, (dr, df) in enumerate(DIRECTIONS):
        rr, ff = r + dr, f + df
        if 0 <= rr < 8 and 0 <= ff < 8:
            KING_TARGETS[sq, j] = rr * 8 + ff

# Squares from which an *opponent* pawn attacks sq (opponent pawns move
# toward rank 0, so they sit one rank above): or -1.
OPP_PAWN_FROM = np.full((64, 2), -1, np.int32)
for sq in range(64):
    r, f = divmod(sq, 8)
    for j, df in enumerate((-1, 1)):
        rr, ff = r + 1, f + df
        if 0 <= rr < 8 and 0 <= ff < 8:
            OPP_PAWN_FROM[sq, j] = rr * 8 + ff

# Special action ids.
CASTLE_K = ACTION_INDEX["e1g1"]
CASTLE_Q = ACTION_INDEX["e1c1"]
E1, C1, D1, F1, G1, B1, A1, H1 = map(name_sq, ("e1", "c1", "d1", "f1", "g1", "b1", "a1", "h1"))
A8, H8, E8 = map(name_sq, ("a8", "h8", "e8"))

# Zobrist-style hashing for repetition detection: two independent 32-bit
# tables over (piece code + 6, square) + castling + ep-file mixers.
_rng = np.random.default_rng(20260817)
ZOBRIST = _rng.integers(1, 2**32, size=(2, 13, 64), dtype=np.uint32)
ZOBRIST_CASTLE = _rng.integers(1, 2**32, size=(2, 4), dtype=np.uint32)
ZOBRIST_EP = _rng.integers(1, 2**32, size=(2, 9), dtype=np.uint32)  # 8 files + none

START_BOARD = np.zeros((8, 8), np.int8)
START_BOARD[0] = [ROOK, KNIGHT, BISHOP, QUEEN, KING, BISHOP, KNIGHT, ROOK]
START_BOARD[1] = PAWN
START_BOARD[6] = -PAWN
START_BOARD[7] = [-ROOK, -KNIGHT, -BISHOP, -QUEEN, -KING, -BISHOP, -KNIGHT, -ROOK]

FEN_PIECES = {"P": PAWN, "N": KNIGHT, "B": BISHOP, "R": ROOK, "Q": QUEEN, "K": KING}


def board_from_fen(fen: str):
    """Parse a FEN into (canonical board, castling[4], ep_file, halfmove,
    fullmove_plies, to_move_white). If black to move, the board is mirrored
    to the canonical side-to-move perspective (flip ranks + negate) and the
    castling rights are swapped (the canonical side-to-move contract)."""
    parts = fen.split()
    rows = parts[0].split("/")
    board = np.zeros((8, 8), np.int8)
    for r, row in enumerate(rows):  # FEN starts at rank 8
        f = 0
        for ch in row:
            if ch.isdigit():
                f += int(ch)
            else:
                code = FEN_PIECES[ch.upper()]
                board[7 - r, f] = code if ch.isupper() else -code
                f += 1
    if (board == KING).sum() != 1 or (board == -KING).sum() != 1:
        raise ValueError(f"FEN must contain exactly one king per side: {fen!r}")
    white = len(parts) < 2 or parts[1] == "w"
    rights_str = parts[2] if len(parts) > 2 else "KQkq"
    castling = np.array(
        ["K" in rights_str, "Q" in rights_str, "k" in rights_str, "q" in rights_str],
        bool,
    )
    ep_file = -1
    if len(parts) > 3 and parts[3] != "-":
        ep_file = ord(parts[3][0]) - ord("a")
    halfmove = int(parts[4]) if len(parts) > 4 else 0
    fullmove = int(parts[5]) if len(parts) > 5 else 1
    plies = (fullmove - 1) * 2 + (0 if white else 1)
    if not white:
        board = -board[::-1].copy()
        castling = castling[[2, 3, 0, 1]]
    return board, castling, ep_file, halfmove, plies, white


def mirror_uci(uci: str) -> str:
    """Flip a UCI move's ranks (file preserved): converts between the
    canonical (side-to-move) orientation and the absolute board orientation
    for black."""
    out = []
    for i, ch in enumerate(uci):
        if ch.isdigit():
            out.append(str(9 - int(ch)))
        else:
            out.append(ch)
    return "".join(out)
