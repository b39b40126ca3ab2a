"""Connect-4 exact-solver oracle (the port's copy of solver/__init__.py).

Wraps the native C++ solver (native/c4solver.cpp, the port's own copy) via
ctypes, with the JAX package's oracle semantics:

- ``solve_moves`` / ``solve_board``: strong score of a position (sign =
  outcome for the side to move, magnitude = earliness of the win).
- ``ranked_moves_and_value``: rank the legal moves best-first: moves that
  end the game immediately rank first (score -inf in opponent view), the
  rest ascending by the child's score from the opponent's perspective;
  plus the board value in {-1, 0, 1}.
- ``policy_and_value``: one-hot policy on the best move over the fixed
  action space + value.
- ``make_solver_evaluate_fn``: a host-side MCTS leaf evaluator on torch
  tensors.

The solver runs on the host in both packages; it is no device kernel. The
shared library and the CLI (one position per stdin line, ``<moves> <score>
<nodes> <time_us>`` per stdout line) are compiled with g++ on first use,
never at import, into ``build/solver/`` at the repo root (a directory
``.gitignore`` lists), each file named by a digest of the source and its
flags, and written under a temporary name first, so that processes
building at once never load a half-written file. A missing g++ or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SRC = NATIVE_DIR / "c4solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "solver"
CXX_FLAGS = ("-O3", "-std=c++17")
_TARGET_FLAGS = {"lib": ("-shared", "-fPIC"), "cli": ("-DC4_CLI",)}

WIDTH, HEIGHT = 7, 6
COL_BITS = HEIGHT + 1
INVALID = -128

#: Opening book shipped next to the native solver (generated by
#: ``c4solver -g <depth> <path>``; format documented in c4solver.cpp), a
#: byte-for-byte copy of the JAX package's; loaded automatically.
DEFAULT_BOOK = str(NATIVE_DIR / "7x6.book")


def target_path(kind: str) -> Path:
    """Where the ``kind`` ("lib" or "cli") build of the current source and
    flags lives."""
    flags = CXX_FLAGS + _TARGET_FLAGS[kind]
    digest = hashlib.sha256(" ".join(flags).encode() + b"\0"
                            + SRC.read_bytes()).hexdigest()[:16]
    name = (f"libc4solver-{digest}.so" if kind == "lib"
            else f"c4solver-{digest}")
    return BUILD_DIR / name


def build(kind: str) -> str:
    """Path of the ``kind`` build, compiled first if it is not there."""
    out = target_path(kind)
    if out.exists():
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it builds the Connect-4 solver")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.name + ".",
                               suffix=".tmp")
    os.close(fd)
    proc = subprocess.run(
        [gxx, *CXX_FLAGS, *_TARGET_FLAGS[kind], str(SRC), "-o", tmp],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build the Connect-4 solver "
                           f"({kind}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def cli_path() -> str:
    return build("cli")


class ConnectFourSolver:
    """Strong 7x6 Connect-4 solver with a persistent transposition table.

    ``book``: path to an opening book, ``"auto"`` to use :data:`DEFAULT_BOOK`
    when it exists (the default), or ``None`` for no book.

    ``cache``: path to a persistent cross-process solve cache, ``"auto"``
    for ``$CAZ_SOLVER_CACHE`` or ``results/solver_cache.npz`` relative to
    the working directory (the default), or ``None`` to disable. The cache
    stores exact scores of SHALLOW positions (plies <=
    :data:`CACHE_MAX_PLIES`), the ones that cost seconds to solve, as
    ``keys`` (current, mask) uint64 pairs and int8 ``scores`` in an .npz:
    the JAX package's format, so either package reads the other's cache.
    """

    CACHE_MAX_PLIES = 16
    _CACHE_FLUSH_EVERY = 64

    def __init__(self, book: str | None = "auto",
                 cache: str | None = "auto"):
        lib = ctypes.CDLL(build("lib"))
        lib.c4_new.restype = ctypes.c_void_p
        lib.c4_free.argtypes = [ctypes.c_void_p]
        lib.c4_solve_moves.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.c4_solve_moves.restype = ctypes.c_int
        lib.c4_solve_bitboard.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int
        ]
        lib.c4_solve_bitboard.restype = ctypes.c_int
        lib.c4_book_load.argtypes = [ctypes.c_char_p]
        lib.c4_book_load.restype = ctypes.c_void_p
        lib.c4_book_free.argtypes = [ctypes.c_void_p]
        lib.c4_book_depth.argtypes = [ctypes.c_void_p]
        lib.c4_book_depth.restype = ctypes.c_int
        lib.c4_set_book.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.c4_book_generate.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.c4_book_generate.restype = ctypes.c_uint64
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.c4_new())
        self._book = None
        self.book_depth = -1
        if book == "auto":
            book = DEFAULT_BOOK if os.path.exists(DEFAULT_BOOK) else None
        if book is not None:
            handle = lib.c4_book_load(book.encode())
            if not handle:
                raise FileNotFoundError(f"Cannot load opening book {book!r}")
            self._book = ctypes.c_void_p(handle)
            self.book_depth = lib.c4_book_depth(self._book)
            lib.c4_set_book(self._handle, self._book)
        if cache == "auto":
            cache = os.environ.get(
                "CAZ_SOLVER_CACHE", os.path.join("results",
                                                 "solver_cache.npz")
            )
        self._cache_path = cache
        self._cache: dict = {}
        self._cache_dirty = 0
        if cache and os.path.exists(cache):
            try:
                data = np.load(cache)
                self._cache = dict(zip(
                    map(tuple, data["keys"].tolist()),
                    data["scores"].tolist(),
                ))
            except Exception:
                self._cache = {}  # corrupt cache: regenerate

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.c4_free(self._handle)
            self._handle = None
        if getattr(self, "_book", None):
            self._lib.c4_book_free(self._book)
            self._book = None

    # -- core queries ------------------------------------------------------

    def solve_moves(self, moves: str) -> int:
        """Score of the position after a 1-indexed column sequence ("4453")."""
        score = self._lib.c4_solve_moves(self._handle, moves.encode())
        if score == INVALID:
            raise ValueError(f"Illegal or finished move sequence: {moves!r}")
        return score

    def solve_board(self, board: np.ndarray) -> int:
        """Score of a canonical board array (H, W) int8, +1 = side to move,
        row 0 = top (the env's state layout)."""
        current, mask, plies = board_to_bitboard(board)
        cacheable = (
            self._cache_path is not None and plies <= self.CACHE_MAX_PLIES
        )
        if cacheable:
            hit = self._cache.get((int(current), int(mask)))
            if hit is not None:
                return int(hit)
        score = self._lib.c4_solve_bitboard(self._handle, current, mask, plies)
        if score == INVALID:
            raise ValueError("Board already contains a win")
        if cacheable:
            self._cache[(int(current), int(mask))] = int(score)
            self._cache_dirty += 1
            if self._cache_dirty >= self._CACHE_FLUSH_EVERY:
                self.flush_cache()
        return score

    def flush_cache(self) -> None:
        """Persist the solve cache (atomic replace; merges are last-writer
        wins per flush, fine for a monotonically-growing exact memo)."""
        if not self._cache_path or not self._cache:
            self._cache_dirty = 0
            return
        os.makedirs(os.path.dirname(self._cache_path) or ".", exist_ok=True)
        keys = np.asarray(list(self._cache.keys()), np.uint64)
        scores = np.asarray(list(self._cache.values()), np.int8)
        tmp = self._cache_path + ".tmp.npz"  # savez keeps an .npz suffix
        np.savez_compressed(tmp, keys=keys, scores=scores)
        os.replace(tmp, self._cache_path)
        self._cache_dirty = 0

    # -- oracle API ----------------------------------------------------------

    def ranked_moves_and_value(
        self, board: np.ndarray
    ) -> Tuple[List[int], float]:
        """Rank legal columns best-first (indices into ``legal_columns``);
        value in {-1, 0, 1} for the side to move."""
        legal = legal_columns(board)
        if not legal:
            raise ValueError("No legal moves (terminal board)")
        child_values = np.zeros(len(legal))
        for i, col in enumerate(legal):
            child, ended = play_canonical(board, col)
            if ended:
                # Game-ending moves (win or board-filling) rank best.
                child_values[i] = -np.inf
            else:
                child_values[i] = self.solve_board(child)
        ranked = list(np.argsort(child_values, kind="stable"))
        value = float(np.sign(self.solve_board(board)))
        return ranked, value

    def policy_and_value(
        self, board: np.ndarray, num_actions: int = WIDTH
    ) -> Tuple[np.ndarray, float]:
        """One-hot oracle policy over the fixed action space + value."""
        ranked, value = self.ranked_moves_and_value(board)
        legal = legal_columns(board)
        policy = np.zeros(num_actions)
        policy[legal[int(ranked[0])]] = 1.0
        return policy, value

    def move_rank_score(self, board: np.ndarray, col: int) -> float:
        """Arena solver score of choosing `col`: 1 - (rank+1)/num_legal."""
        ranked, _ = self.ranked_moves_and_value(board)
        legal = legal_columns(board)
        rank = ranked.index(legal.index(col))
        return 1.0 - (rank + 1) / len(legal)


def generate_book(depth: int, path: str = DEFAULT_BOOK) -> int:
    """Generate a depth-``depth`` opening book (exact strong scores for every
    position with at most ``depth`` stones); returns the entry count.
    Expensive: the depth-``depth`` frontier is solved exactly position by
    position (hours for depth 8), an offline tool."""
    solver = ConnectFourSolver(book=None)
    return int(solver._lib.c4_book_generate(depth, path.encode()))


# ---------------------------------------------------------------------------
# Canonical-board helpers (host-side NumPy)
# ---------------------------------------------------------------------------

def board_to_bitboard(board: np.ndarray) -> Tuple[int, int, int]:
    """Canonical (H, W) array -> (current-player bits, occupancy bits, plies).
    Bit layout matches the native solver: bit = col*(H+1) + row-from-bottom."""
    if board.shape != (HEIGHT, WIDTH):
        raise ValueError(f"expected a {HEIGHT}x{WIDTH} board, got "
                         f"{board.shape}")
    current = mask = 0
    plies = 0
    for row in range(HEIGHT):
        for col in range(WIDTH):
            v = int(board[row, col])
            if v == 0:
                continue
            bit = 1 << (col * COL_BITS + (HEIGHT - 1 - row))
            mask |= bit
            plies += 1
            if v == 1:
                current |= bit
    return current, mask, plies


def legal_columns(board: np.ndarray) -> List[int]:
    return [c for c in range(WIDTH) if board[0, c] == 0]


def play_canonical(board: np.ndarray, col: int) -> Tuple[np.ndarray, bool]:
    """Drop a +1 stone in `col`, mirror to canonical perspective; returns
    (child board, game ended)."""
    child = board.copy()
    rows = np.nonzero(child[:, col] == 0)[0]
    row = rows.max()
    child[row, col] = 1
    ended = _wins_through(child, row, col) or not (child == 0).any()
    return -child, ended


def _wins_through(board: np.ndarray, r: int, c: int, n: int = 4) -> bool:
    color = board[r, c]
    for dr, dc in ((1, 0), (0, 1), (1, 1), (1, -1)):
        count = 1
        for sign in (1, -1):
            rr, cc = r + sign * dr, c + sign * dc
            while 0 <= rr < HEIGHT and 0 <= cc < WIDTH and board[rr, cc] == color:
                count += 1
                rr += sign * dr
                cc += sign * dc
        if count >= n:
            return True
    return False


def _board_has_win(board: np.ndarray, n: int = 4) -> bool:
    for r in range(HEIGHT):
        for c in range(WIDTH):
            if board[r, c] != 0 and _wins_through(board, r, c, n):
                return True
    return False


def make_solver_evaluate_fn(num_actions: int = WIDTH):
    """MCTS leaf evaluator with oracle priors and values.

    ``evaluate(obs)`` takes (B, H, W, 4) observations on any device, copies
    the boards to the host once, solves each, and returns float32 (probs
    (B, A), values (B,)) on ``obs.device``. Terminal boards get zeros (the
    search ignores evaluations of terminal leaves). It computes on the
    host, so no CUDA graph can hold it: a fused search that uses it takes
    ``graph=False``.
    """
    solver = ConnectFourSolver()

    def evaluate(obs: torch.Tensor):
        boards = (obs[..., 1] - obs[..., 2]).to(torch.int8).cpu().numpy()
        probs = np.zeros((len(boards), num_actions), np.float32)
        values = np.zeros((len(boards),), np.float32)
        for i, board in enumerate(boards):
            if not legal_columns(board) or _board_has_win(board):
                continue
            probs[i], values[i] = solver.policy_and_value(board, num_actions)
        return (torch.from_numpy(probs).to(obs.device),
                torch.from_numpy(values).to(obs.device))

    return evaluate
