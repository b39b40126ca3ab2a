"""Batched chess engine on torch tensors (the port of envs/chess/engine.py).

Same rules and state as the JAX engine, held to it field by field and ply by
ply (tests/test_torch_port_chess.py):

- Canonical perspective: the side to move owns the positive pieces, rank 0
  is its back rank; after every ply the board is rank-flipped and negated.
- Legality for each of the 1968 fixed actions: geometric pattern (the
  tables), clear path, destination rule, and king safety from one position
  analysis (checkers, check-resolution squares, absolute pins, the enemy
  attack map with the king removed); en-passant captures get a direct
  post-move verdict, castling is OR-ed into e1g1/e1c1.
- Terminals: checkmate (+1 for the mover), stalemate, the 75-move rule
  (halfmove clock >= 150 plies), insufficient material, and threefold
  repetition over a 100-ply ring of dual 32-bit Zobrist hashes, updated
  incrementally across the canonical mirror. Terminal states absorb.
- Observation: 8 history plies x (13 piece one-hot + repetition) + 4
  castling + 2 clock planes = 118 channels.

The JAX engine is written for one game and vmapped, and reads boards
through one-hot matmuls and flips ranks with a permutation matmul to suit
the TPU; here every state field has a leading batch axis, boards are read
with gathers and flipped with ``torch.flip``. All of it is integer or
boolean arithmetic, so the results are JAX's exactly. The hashes are
uint32 in JAX; torch keeps the same bits in int32 (XOR is the only
arithmetic on them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import ChessConfig, resolve_device
from custom_alphazero_tpu_torch.envs import core
from custom_alphazero_tpu_torch.envs.chess import tables as T

HISTORY = 8
HASH_RING = 100
OBS_CHANNELS = HISTORY * 14 + 6
A = T.NUM_ACTIONS
PAWN, KNIGHT, BISHOP = T.PAWN, T.KNIGHT, T.BISHOP
ROOK, QUEEN, KING = T.ROOK, T.QUEEN, T.KING


@dataclass
class ChessState:
    """A batch of canonical games (side to move owns the + pieces).

    board (B, 8, 8) int8; castling (B, 4) bool: own K, own Q, opp K, opp Q;
    ep_file (B,) int32, -1 = none (target square (5, file)); halfmove (B,)
    int32 plies since a pawn move or capture; fullmove (B,) int32 plies
    played; terminal, won (B,) bool (``won``: the last mover mated);
    legal (B, A) bool cached legal mask; in_check (B,) bool; history
    (B, 8, 8, 8) int8 boards, newest first; history_rep (B, 8) bool;
    hash_ring (B, 100, 2) int32 recent position hashes (uint32 bits);
    ring_idx (B,) int32; piece_hash, piece_hash_flip (B, 2) int32 piece
    placement hash in the current and in the flipped encoding.
    """

    board: torch.Tensor
    castling: torch.Tensor
    ep_file: torch.Tensor
    halfmove: torch.Tensor
    fullmove: torch.Tensor
    terminal: torch.Tensor
    won: torch.Tensor
    legal: torch.Tensor
    in_check: torch.Tensor
    history: torch.Tensor
    history_rep: torch.Tensor
    hash_ring: torch.Tensor
    ring_idx: torch.Tensor
    piece_hash: torch.Tensor
    piece_hash_flip: torch.Tensor

    def _map(self, fn, *others) -> "ChessState":
        return ChessState(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)
        })

    def where(self, mask: torch.Tensor, other: "ChessState") -> "ChessState":
        """Per game: ``self`` where ``mask`` (B,) is true, else ``other``."""
        return self._map(lambda a, b: torch.where(
            mask.view((-1,) + (1,) * (a.dim() - 1)), a, b), other)

    def take(self, index: torch.Tensor) -> "ChessState":
        """The games at ``index`` (a (K,) index tensor)."""
        return self._map(lambda a: a[index])

    def to(self, device) -> "ChessState":
        return self._map(lambda a: a.to(device))

    @staticmethod
    def cat(states: Sequence["ChessState"]) -> "ChessState":
        return states[0]._map(lambda *parts: torch.cat(parts), *states[1:])


class _Tables:
    """The static tables on one device, and the per-action masks that do
    not depend on the position."""

    def __init__(self, device: torch.device):
        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        i64 = torch.long
        frm, to = np.asarray(T.FROM), np.asarray(T.TO)
        promo, dirs, dist = (np.asarray(T.PROMO), np.asarray(T.DIR),
                             np.asarray(T.DIST))
        knight = np.asarray(T.IS_KNIGHT)
        diag = np.isin(dirs, T.DIAGONAL_DIRS)
        orth = np.isin(dirs, T.ORTHOGONAL_DIRS)
        plain = ~knight & (promo == 0)
        frm_rank, to_rank = frm // 8, to // 8
        self.frm, self.to = t(frm, i64), t(to, i64)
        self.promo = t(promo, torch.int8)
        self.between = t(np.maximum(T.BETWEEN, 0), i64)
        self.between_off = t(np.asarray(T.BETWEEN) < 0)
        self.is_knight = t(knight)
        self.slide = t(plain)
        self.slide_orth = t(plain & orth)
        self.slide_diag = t(plain & diag)
        self.king_step = t(plain & (dist == 1))
        self.push1 = t((promo == 0) & (dirs == 0) & (dist == 1)
                       & (to_rank < 7))
        self.push2 = t((promo == 0) & (dirs == 0) & (dist == 2)
                       & (frm_rank == 1))
        self.pawn_cap = t((promo == 0) & diag & (dirs != 3) & (dirs != 5)
                          & (dist == 1) & (to_rank < 7))
        self.promo_push = t((promo > 0) & (frm_rank == 6) & (dirs == 0))
        self.promo_cap = t((promo > 0) & (frm_rank == 6)
                           & ((dirs == 1) | (dirs == 7)))
        self.ep_shape = t((promo == 0) & diag & (dist == 1))
        # The pin axis (direction mod 4) a move travels along; -1 never
        # matches (knights).
        self.dir_axis = t(np.where(~knight & (dirs >= 0), dirs % 4, -1), i64)
        self.ray = t(T.RAY, i64)                      # (64, 8, 7), -1 off
        self.knight_t = t(T.KNIGHT_TARGETS, i64)      # (64, 8)
        self.king_t = t(T.KING_TARGETS, i64)          # (64, 8)
        self.opp_pawn = t(T.OPP_PAWN_FROM, i64)       # (64, 2)
        self.diag_col = t([d in T.DIAGONAL_DIRS for d in range(8)])[:, None]
        self.axis_of_d = t(np.arange(8) % 4, i64)
        squares = np.arange(64)
        self.sq_colour = t((squares // 8 + squares % 8) % 2, torch.int32)
        self.iota64 = t(squares, i64)

        def bits(x):  # uint32 -> the same bits as int32
            return np.ascontiguousarray(np.asarray(x, np.uint32)).view(
                np.int32)

        z = np.asarray(T.ZOBRIST)                         # (2, 13, 64)
        zm = z[:, ::-1, :][:, :, squares ^ 56]            # flipped view
        # (13, 64, 2): a cell's (code, square) pair of sub-hashes.
        self.zobrist = t(bits(z.transpose(1, 2, 0)))
        self.zobrist_flip = t(bits(zm.transpose(1, 2, 0)))
        self.z_castle = t(bits(np.asarray(T.ZOBRIST_CASTLE).T))  # (4, 2)
        self.z_ep = t(bits(np.asarray(T.ZOBRIST_EP).T))          # (9, 2)


_TABLES: Dict[str, _Tables] = {}


def _tables(device: torch.device) -> _Tables:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = _Tables(device)
    return _TABLES[key]


def _read(flat: torch.Tensor, squares: torch.Tensor) -> torch.Tensor:
    """Board values (B, ...) at per-game squares (B, ...), 0 where -1."""
    bsz = flat.shape[0]
    vals = flat.gather(1, squares.clamp_min(0).reshape(bsz, -1))
    return torch.where(squares >= 0, vals.view(squares.shape), 0)


def _mark(squares: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(B, 64) bool: the squares (B, K) whose flag is set (-1 = none)."""
    bsz = squares.shape[0]
    idx = torch.where(flags & (squares >= 0), squares, 64)
    out = torch.zeros((bsz, 65), dtype=torch.bool, device=squares.device)
    return out.scatter_(1, idx, True)[:, :64]


def _count_before(occ: torch.Tensor) -> torch.Tensor:
    """Occupied squares strictly nearer on the same ray (exclusive
    prefix count along the last axis)."""
    occ = occ.to(torch.int32)
    return occ.cumsum(-1) - occ


def _sliders(tb: _Tables, vals: torch.Tensor) -> torch.Tensor:
    """Enemy sliders that attack along each direction: bishops and queens
    on diagonals, rooks and queens on files and ranks. vals (..., 8, 7)."""
    return torch.where(tb.diag_col, (vals == -BISHOP) | (vals == -QUEEN),
                       (vals == -ROOK) | (vals == -QUEEN))


def _legal_mask(tb: _Tables, flat: torch.Tensor, castling: torch.Tensor,
                ep_file: torch.Tensor):
    """(legal (B, A), in_check (B,)) of canonical positions."""
    bsz = flat.shape[0]
    piece = flat[:, tb.frm]                     # (B, A)
    to_val = flat[:, tb.to]
    own_from = piece > 0
    dest_free = to_val <= 0                     # never capture own
    path_clear = ((flat[:, tb.between] == 0) | tb.between_off).all(-1)
    ep_target = torch.where(ep_file >= 0, 40 + ep_file, -100).long()
    to_ep = tb.to[None, :] == ep_target[:, None]
    is_pawn = piece == PAWN
    empty_to = to_val == 0

    pseudo = own_from & dest_free & (
        (tb.is_knight & (piece == KNIGHT))
        | (tb.slide & (piece == QUEEN) & path_clear)
        | (tb.slide_orth & (piece == ROOK) & path_clear)
        | (tb.slide_diag & (piece == BISHOP) & path_clear)
        | (tb.king_step & (piece == KING))
        | (is_pawn & tb.push1 & empty_to)
        | (is_pawn & tb.push2 & path_clear & empty_to)
        | (is_pawn & tb.pawn_cap & ((to_val < 0) | to_ep))
        | (is_pawn & tb.promo_push & empty_to)
        | (is_pawn & tb.promo_cap & (to_val < 0))
    )

    # ---- position analysis: checkers, pins, attack map ------------------
    king_sq = (flat == KING).to(torch.uint8).argmax(-1)          # (B,)
    ray_s = tb.ray[king_sq]                                      # (B, 8, 7)
    kn_s = tb.knight_t[king_sq]                                  # (B, 8)
    pw_s = tb.opp_pawn[king_sq]                                  # (B, 2)
    ray_v = _read(flat, ray_s)
    on = ray_s >= 0
    occ = (ray_v != 0) & on
    before = _count_before(occ)
    first = occ & (before == 0)
    slider_kind = _sliders(tb, ray_v)
    ray_has_chk = (first & slider_kind).any(-1)                  # (B, 8)
    kn_chk = _read(flat, kn_s) == -KNIGHT
    pw_chk = _read(flat, pw_s) == -PAWN
    nch = kn_chk.sum(-1) + pw_chk.sum(-1) + ray_has_chk.sum(-1)
    in_check = nch >= 1

    # Check-resolution squares (single check): capture the checker or block
    # the checking ray, up to and including its first piece.
    seg = (before == 0) & on & ray_has_chk[..., None]
    resolve = _mark(torch.cat([ray_s.view(bsz, 56), kn_s, pw_s], 1),
                    torch.cat([seg.view(bsz, 56), kn_chk, pw_chk], 1))

    # Absolute pins: a first own piece on a king ray with a matching enemy
    # slider right behind it may move only along that ray's line.
    first_own = first & (ray_v > 0)
    pinner = occ & (before == 1) & slider_kind
    d_pinned = first_own.any(-1) & pinner.any(-1)                # (B, 8)
    pin_src = (first_own & d_pinned[..., None]).view(bsz, 56)
    pin_idx = torch.where(pin_src, ray_s.view(bsz, 56), 64)
    pinned = torch.zeros((bsz, 65), dtype=torch.bool, device=flat.device)
    pinned = pinned.scatter_(1, pin_idx, True)[:, :64]
    pin_axis = torch.zeros((bsz, 65), dtype=torch.long, device=flat.device)
    pin_axis = pin_axis.scatter_(
        1, pin_idx, tb.axis_of_d[None, :, None].expand(bsz, 8, 7)
        .reshape(bsz, 56))[:, :64]

    # Enemy attack map of all 64 squares with our king removed (a king
    # stepping back along a checking ray stays attacked).
    ray_all = _read(flat, tb.ray[None].expand(bsz, 64, 8, 7))
    ray_all = torch.where(tb.ray[None] == king_sq[:, None, None, None], 0,
                          ray_all)
    occ_all = (ray_all != 0) & (tb.ray >= 0)
    slide_hit = (occ_all & (_count_before(occ_all) == 0)
                 & _sliders(tb, ray_all)).flatten(2).any(-1)
    attacked64 = (
        (_read(flat, tb.knight_t[None].expand(bsz, 64, 8)) == -KNIGHT).any(-1)
        | (_read(flat, tb.king_t[None].expand(bsz, 64, 8)) == -KING).any(-1)
        | (_read(flat, tb.opp_pawn[None].expand(bsz, 64, 2)) == -PAWN).any(-1)
        | slide_hit
    )                                                            # (B, 64)

    # ---- per-action assembly --------------------------------------------
    is_king_act = piece == KING
    ok_pin = ~pinned[:, tb.frm] | (tb.dir_axis[None, :] == pin_axis[:, tb.frm])
    ok_check = (nch == 0)[:, None] | resolve[:, tb.to]
    nonking_legal = (pseudo & ~is_king_act & (nch <= 1)[:, None] & ok_check
                     & ok_pin)
    king_legal = pseudo & is_king_act & ~attacked64[:, tb.to]

    # En-passant captures: a direct post-move verdict (the generic rules
    # miss the double vacancy on the rank and rays opened through the
    # captured pawn's square).
    is_ep = is_pawn & tb.ep_shape & to_ep
    cap_sq = 32 + ep_file.clamp_min(0).long()
    kn_hit = kn_chk.any(-1)
    pw_hit = (pw_chk & (pw_s != cap_sq[:, None])).any(-1)

    def ep_safe_from(frm_sq):
        """King not attacked after (frm vacated, captured pawn removed,
        target pawn placed)."""
        rv = torch.where((ray_s == frm_sq[:, None, None])
                         | (ray_s == cap_sq[:, None, None]), 0, ray_v)
        rv = torch.where(ray_s == ep_target[:, None, None], PAWN, rv)
        occ2 = (rv != 0) & on
        hit = (occ2 & (_count_before(occ2) == 0)
               & _sliders(tb, rv)).flatten(1).any(-1)
        return ~(hit | pw_hit | kn_hit)

    frm_a = tb.frm[None, :]
    ep_legal = pseudo & torch.where(
        frm_a == (cap_sq - 1)[:, None], ep_safe_from(cap_sq - 1)[:, None],
        (frm_a == (cap_sq + 1)[:, None]) & ep_safe_from(cap_sq + 1)[:, None])
    legal = torch.where(is_ep, ep_legal,
                        torch.where(is_king_act, king_legal, nonking_legal))

    # Castling: rights + empty path + the king crossing no attacked square.
    # OR-ed into e1g1/e1c1, which are also ordinary moves of a queen or rook
    # on e1.
    def castle_ok(right, empties, cross):
        ok = right & ~in_check & (flat[:, T.E1] == KING)
        for sq in empties:
            ok = ok & (flat[:, sq] == 0)
        for sq in cross:
            ok = ok & ~attacked64[:, sq]
        return ok

    legal[:, T.CASTLE_K] |= castle_ok(castling[:, 0], (T.F1, T.G1),
                                      (T.F1, T.G1))
    legal[:, T.CASTLE_Q] |= castle_ok(castling[:, 1], (T.B1, T.C1, T.D1),
                                      (T.D1, T.C1))
    return legal, in_check


def _put(board: torch.Tensor, square, value, mask: torch.Tensor) -> None:
    """board[b, square[b]] = value where mask (B,), in place."""
    if isinstance(square, int):
        board[:, square] = torch.where(mask, value, board[:, square])
        return
    idx = square.clamp(0, 63)[:, None]
    cur = board.gather(1, idx)
    board.scatter_(1, idx, torch.where(mask[:, None], value, cur)
                   .to(board.dtype))


def _apply_action(tb: _Tables, flat: torch.Tensor, action: torch.Tensor):
    """Apply (B,) actions to flat (B, 64) boards: (new_flat, info). No
    legality check: callers mask upstream."""
    frm, to, promo = tb.frm[action], tb.to[action], tb.promo[action]
    piece = flat.gather(1, frm[:, None])[:, 0]
    to_val = flat.gather(1, to[:, None])[:, 0]
    is_pawn = piece == PAWN
    ep_capture = is_pawn & (frm % 8 != to % 8) & (to_val == 0)
    moved = torch.where(promo > 0, promo, piece)
    new = flat.clone()
    new.scatter_(1, frm[:, None], 0)
    new.scatter_(1, to[:, None], moved[:, None])
    # En passant: remove the opponent pawn one rank below the target.
    _put(new, to - 8, 0, ep_capture)
    # Castling: the king travels two files from e1.
    king_e1 = (piece == KING) & (frm == T.E1)
    is_castle_k = king_e1 & (to == T.G1)
    is_castle_q = king_e1 & (to == T.C1)
    _put(new, T.H1, 0, is_castle_k)
    _put(new, T.F1, ROOK, is_castle_k)
    _put(new, T.A1, 0, is_castle_q)
    _put(new, T.D1, ROOK, is_castle_q)
    double_push = is_pawn & (to - frm == 16)
    info = dict(
        piece=piece, is_pawn=is_pawn, captured=(to_val != 0) | ep_capture,
        frm=frm, to=to, to_val=to_val, moved=moved, ep_capture=ep_capture,
        is_castle_k=is_castle_k, is_castle_q=is_castle_q,
        new_ep_file=torch.where(double_push, frm % 8, -1).to(torch.int32),
    )
    return new, info


def _xor_fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce ``dim`` (any order gives the same bits)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        folded = x[..., :half] ^ x[..., half:2 * half]
        if x.shape[-1] % 2:
            folded[..., :1] ^= x[..., -1:]
        x = folded
    return x[..., 0]


def _piece_hash_full(tb: _Tables, flat: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """(B, 2) piece-placement hash of flat boards under ``table``
    (``tb.zobrist``: the current view; ``tb.zobrist_flip``: the flipped)."""
    codes = (flat.long() + 6).clamp(0, 12)
    vals = table[codes, tb.iota64[None, :]]                      # (B, 64, 2)
    return _xor_fold(torch.where((flat != 0)[..., None], vals, 0), 1)


def _hashable_ep(flat: torch.Tensor, ep_file: torch.Tensor) -> torch.Tensor:
    """The ep file where a pseudo-legal ep capture exists (an own pawn
    beside the pushed pawn), else -1: a phantom ep square must not split
    the repetition hash."""
    base = 32 + ep_file.clamp_min(0).long()
    left = (ep_file >= 1) & (flat.gather(1, (base - 1)[:, None])[:, 0]
                             == PAWN)
    right = (ep_file >= 0) & (ep_file <= 6) & (
        flat.gather(1, (base + 1)[:, None])[:, 0] == PAWN)
    return torch.where((ep_file >= 0) & (left | right), ep_file, -1)


def _castle_ep_hash(tb: _Tables, flat, castling, ep_file) -> torch.Tensor:
    castle = _xor_fold(torch.where(castling[..., None], tb.z_castle, 0), 1)
    eff_ep = _hashable_ep(flat, ep_file)
    return castle ^ tb.z_ep[torch.where(eff_ep >= 0, eff_ep, 8).long()]


def _position_hash(tb: _Tables, flat, castling, ep_file) -> torch.Tensor:
    """(B, 2) hash of (pieces, castling, effective ep), recomputed in full
    (construction; steps update it incrementally)."""
    return (_piece_hash_full(tb, flat, tb.zobrist)
            ^ _castle_ep_hash(tb, flat, castling, ep_file))


def _hash_delta(tb: _Tables, info):
    """The XOR taking the pre-move piece hash to the post-move one, in the
    current and in the flipped view, each (B, 2). A move changes at most 4
    cells: from, to, the en-passant victim, the castling rook's two
    squares."""
    ep, ck, cq = info["ep_capture"], info["is_castle_k"], info["is_castle_q"]
    zero = torch.zeros_like(info["frm"])
    extra1_sq = torch.where(ep, info["to"] - 8, torch.where(
        ck, T.H1, torch.where(cq, T.A1, -1)))
    extra2_sq = torch.where(ck, T.F1, torch.where(cq, T.D1, -1))
    squares = torch.stack([info["frm"], info["to"], extra1_sq, extra2_sq], 1)
    old = torch.stack([info["piece"].long(), info["to_val"].long(),
                       torch.where(ep, -PAWN, ROOK), zero], 1)
    new = torch.stack([zero, info["moved"].long(), zero, zero + ROOK], 1)

    def contrib(codes, table):
        valid = (squares >= 0) & (codes != 0)
        vals = table[codes + 6, squares.clamp_min(0)]            # (B, 4, 2)
        return _xor_fold(torch.where(valid[..., None], vals, 0), 1)

    return (contrib(old, tb.zobrist) ^ contrib(new, tb.zobrist),
            contrib(old, tb.zobrist_flip) ^ contrib(new, tb.zobrist_flip))


def _insufficient_material(tb: _Tables, flat: torch.Tensor) -> torch.Tensor:
    absf = flat.abs()
    pawns, knights, bishops, rooks, queens = (
        (absf == c).sum(-1) for c in (PAWN, KNIGHT, BISHOP, ROOK, QUEEN))
    heavy = pawns + rooks + queens
    bare = (heavy == 0) & (knights + bishops <= 1)
    # A single bishop each, on squares of the same colour.
    own_b, opp_b = flat == BISHOP, flat == -BISHOP
    same_colour = (
        (heavy == 0) & (knights == 0)
        & (own_b.sum(-1) == 1) & (opp_b.sum(-1) == 1)
        & (torch.where(own_b, tb.sq_colour, 0).sum(-1)
           == torch.where(opp_b, tb.sq_colour, 0).sum(-1))
    )
    return bare | same_colour


def _as_tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x)
    return torch.as_tensor(x, device=device)


def _batched(x, dtype, batch: int, device, tail: Tuple[int, ...] = ()):
    """``x`` as (batch, *tail), broadcast from one game's value."""
    t = _as_tensor(x, device).to(dtype)
    return t.reshape((-1,) + tail).expand((batch,) + tail).contiguous()


class Chess(core.Env):
    """Chess over the fixed 1968-action table, batched."""

    def __init__(self, cfg: ChessConfig = ChessConfig()):
        self.cfg = cfg
        self.num_actions = A
        self.obs_shape = (8, 8, OBS_CHANNELS)
        # Replay bit-packing (replay/codec.py): every observe() channel is
        # binary but the two constant clock planes at the end.
        self.obs_scalar_channels = (OBS_CHANNELS - 2, OBS_CHANNELS - 1)

    # -- construction ------------------------------------------------------

    def init(self, batch: int, device=None) -> ChessState:
        return self.state_from_arrays(
            np.broadcast_to(T.START_BOARD, (batch, 8, 8)),
            np.ones((batch, 4), bool), -1, 0, 0, device)

    def state_from_arrays(self, board, castling, ep_file, halfmove, plies,
                          device=None) -> ChessState:
        """States from canonical arrays: board (B, 8, 8) or (8, 8),
        castling (B, 4) or (4,), and per-game or shared scalars."""
        device = resolve_device(device)
        board = _as_tensor(board, device).to(torch.int8).reshape(-1, 8, 8)
        bsz = board.shape[0]
        castling = _batched(np.asarray(castling), torch.bool, bsz, device,
                            (4,))
        ep_file = _batched(ep_file, torch.int32, bsz, device)
        halfmove = _batched(halfmove, torch.int32, bsz, device)
        plies = _batched(plies, torch.int32, bsz, device)
        tb = _tables(device)
        flat = board.reshape(bsz, 64)
        # Rights without their king and rook are cleared (a FEN defaults
        # missing fields to KQkq).
        castling = castling & torch.stack([
            (flat[:, T.E1] == KING) & (flat[:, T.H1] == ROOK),
            (flat[:, T.E1] == KING) & (flat[:, T.A1] == ROOK),
            (flat[:, T.E8] == -KING) & (flat[:, T.H8] == -ROOK),
            (flat[:, T.E8] == -KING) & (flat[:, T.A8] == -ROOK),
        ], 1)
        legal, in_check = _legal_mask(tb, flat, castling, ep_file)
        history = torch.zeros((bsz, HISTORY, 8, 8), dtype=torch.int8,
                              device=device)
        history[:, 0] = board
        ring = torch.zeros((bsz, HASH_RING, 2), dtype=torch.int32,
                           device=device)
        ring[:, 0] = _position_hash(tb, flat, castling, ep_file)
        no_moves = ~legal.any(-1)
        # A loaded position may already be decided.
        terminal = (no_moves | _insufficient_material(tb, flat)
                    | (halfmove >= 150))
        return ChessState(
            board=board, castling=castling, ep_file=ep_file,
            halfmove=halfmove, fullmove=plies, terminal=terminal,
            # From the last mover's perspective: a mated side to move means
            # the (virtual) last mover won.
            won=no_moves & in_check, legal=legal, in_check=in_check,
            history=history,
            history_rep=torch.zeros((bsz, HISTORY), dtype=torch.bool,
                                    device=device),
            hash_ring=ring,
            ring_idx=torch.ones((bsz,), dtype=torch.int32, device=device),
            piece_hash=_piece_hash_full(tb, flat, tb.zobrist),
            piece_hash_flip=_piece_hash_full(tb, flat, tb.zobrist_flip),
        )

    def from_fen(self, fen: Union[str, Sequence[str]],
                 device=None) -> ChessState:
        """One state per FEN (a batch of 1 for a single string)."""
        parsed = [T.board_from_fen(f)
                  for f in ([fen] if isinstance(fen, str) else fen)]
        board, castling, ep_file, halfmove, plies, _ = (
            np.stack(col) for col in zip(*parsed))
        return self.state_from_arrays(board, castling, ep_file, halfmove,
                                      plies, device)

    # -- dynamics ----------------------------------------------------------

    def _advance(self, state: ChessState, action: torch.Tensor):
        """Move application shared by step and step_lite: board, castling
        rights, the canonical mirror, clocks, incremental hash, repetition
        ring and history; the analysis fields are left as they were.
        Returns (advanced_state, ring_matches)."""
        tb = _tables(state.board.device)
        bsz = state.board.shape[0]
        flat = state.board.reshape(bsz, 64)
        new_flat, info = _apply_action(tb, flat, action.long())
        piece, frm, to = info["piece"], info["frm"], info["to"]

        # The own side loses rights on king and rook moves; the opponent
        # loses one when its rook's home square is captured.
        own_k = state.castling[:, 0] & (piece != KING) & ~(
            (frm == T.H1) & (piece == ROOK))
        own_q = state.castling[:, 1] & (piece != KING) & ~(
            (frm == T.A1) & (piece == ROOK))
        opp_k = state.castling[:, 2] & (to != T.H8)
        opp_q = state.castling[:, 3] & (to != T.A8)

        board = -torch.flip(new_flat.view(bsz, 8, 8), dims=(1,))
        castling = torch.stack([opp_k, opp_q, own_k, own_q], 1)
        ep_file = info["new_ep_file"]
        halfmove = torch.where(info["is_pawn"] | info["captured"], 0,
                               state.halfmove + 1).to(torch.int32)

        # The new view's placement hash is the old flipped-view hash XOR the
        # move's flipped-view delta.
        delta_cur, delta_flip = _hash_delta(tb, info)
        piece_hash = state.piece_hash_flip ^ delta_flip
        piece_hash_flip = state.piece_hash ^ delta_cur
        h = piece_hash ^ _castle_ep_hash(tb, board.reshape(bsz, 64),
                                         castling, ep_file)
        ring = state.hash_ring.clone()
        games = torch.arange(bsz, device=ring.device)
        ring[games, (state.ring_idx % HASH_RING).long()] = h
        matches = (ring == h[:, None, :]).all(-1).sum(-1)

        advanced = dataclasses.replace(
            state, board=board, castling=castling, ep_file=ep_file,
            halfmove=halfmove, fullmove=state.fullmove + 1,
            history=torch.cat([board[:, None], state.history[:, :-1]], 1),
            history_rep=torch.cat([(matches >= 2)[:, None],
                                   state.history_rep[:, :-1]], 1),
            hash_ring=ring, ring_idx=state.ring_idx + 1,
            piece_hash=piece_hash, piece_hash_flip=piece_hash_flip,
        )
        return advanced, matches

    def step(self, state: ChessState, action: torch.Tensor):
        advanced, matches = self._advance(state, action)
        tb = _tables(state.board.device)
        flat = advanced.board.reshape(advanced.board.shape[0], 64)
        legal, in_check = _legal_mask(tb, flat, advanced.castling,
                                      advanced.ep_file)
        no_moves = ~legal.any(-1)
        mate = no_moves & in_check
        terminal = (no_moves | (matches >= 3) | (advanced.halfmove >= 150)
                    | _insufficient_material(tb, flat))
        stepped = dataclasses.replace(
            advanced, terminal=terminal, won=mate,
            legal=legal & ~terminal[:, None], in_check=in_check)
        # Absorbing terminal states: stepping a finished game is a no-op.
        keep = state.terminal
        reward = torch.where(keep | ~mate, 0.0, 1.0)
        return state.where(keep, stepped), reward

    def step_lite(self, state: ChessState, action: torch.Tensor):
        """Descent step: everything ``observe`` and a later full ``step``
        read (board, castling, ep, clocks, history, repetition planes, hash
        ring), without the legality analysis; legal / in_check / terminal /
        won stay stale. Sound in the search, whose tree stores each node's
        terminal flag from the full step that created it."""
        return self._advance(state, action)[0]

    # -- queries -----------------------------------------------------------

    def legal_mask(self, state: ChessState) -> torch.Tensor:
        return state.legal & ~state.terminal[:, None]

    def is_terminal(self, state: ChessState) -> torch.Tensor:
        return state.terminal

    def terminal_value(self, state: ChessState) -> torch.Tensor:
        return torch.where(state.won, -1.0, 0.0)

    def observe(self, state: ChessState) -> torch.Tensor:
        """(B, 8, 8, 118) float32: per history ply (newest first) the 13
        piece one-hot planes (piece + 6; odd plies re-oriented to the side
        to move) and the repetition plane, then castling K, Q, K, Q, the
        plies played and the halfmove clock."""
        hist = state.history
        bsz = hist.shape[0]
        odd = (torch.arange(HISTORY, device=hist.device) % 2 == 1)
        aligned = torch.where(odd[None, :, None, None],
                              -torch.flip(hist, dims=(2,)), hist)
        onehot = torch.nn.functional.one_hot(aligned.long() + 6, 13).float()
        rep = state.history_rep.float()[:, :, None, None, None].expand(
            bsz, HISTORY, 8, 8, 1)
        planes = torch.cat([onehot, rep], -1).permute(0, 2, 3, 1, 4).reshape(
            bsz, 8, 8, HISTORY * 14)
        extra = torch.cat([state.castling.float(),
                           state.fullmove.float()[:, None],
                           state.halfmove.float()[:, None]], 1)
        return torch.cat([planes, extra[:, None, None, :].expand(
            bsz, 8, 8, 6)], -1)
