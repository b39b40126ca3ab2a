"""Convert the persistent solve cache into a native opening-book file (the
port of tools/book_from_cache.py).

Every shallow position the solve cache has paid for goes into the native
C4BK book format (solver/native/c4solver.cpp ``Book``). The book is
partial: ``Book::probe`` returns a miss for an absent key and the solver
searches, so a partial book is sound; it grows with the cache, along the
openings that the evaluations replay. The bytes are the JAX tool's for the
same cache.

Run: python -m custom_alphazero_tpu_torch.tools.book_from_cache \\
       [--cache=results/solver_cache.npz] [--out=.../7x6_cache.book] \\
       [--max_plies=16]
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from custom_alphazero_tpu_torch import solver as sv
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args

_BOTTOM = sum(1 << (c * sv.COL_BITS) for c in range(sv.WIDTH))
_COL_MASK = (1 << sv.COL_BITS) - 1


def _mirror_bits(x: int) -> int:
    r = 0
    for c in range(sv.WIDTH):
        col = (x >> (c * sv.COL_BITS)) & _COL_MASK
        r |= col << ((sv.WIDTH - 1 - c) * sv.COL_BITS)
    return r


def canonical_key(current: int, mask: int) -> int:
    """The book key of a bitboard position: the smaller of its key and its
    mirror's."""
    k = current + mask + _BOTTOM
    km = _mirror_bits(current) + _mirror_bits(mask) + _BOTTOM
    return min(k, km)


def write_book(entries: dict, depth: int, path: str) -> int:
    """entries: {canonical_key: score}; writes the C4BK format (magic,
    version 1, width, height, depth, count, sorted u64 keys, i8 scores)."""
    keys = np.asarray(sorted(entries), np.uint64)
    scores = np.asarray([entries[int(k)] for k in keys], np.int8)
    with open(path, "wb") as fp:
        fp.write(b"C4BK")
        fp.write(struct.pack("<BBBB", 1, sv.WIDTH, sv.HEIGHT, depth))
        fp.write(struct.pack("<Q", len(keys)))
        fp.write(keys.tobytes())
        fp.write(scores.tobytes())
    return len(keys)


def convert(cache_path: str, out_path: str, max_plies: int = 16) -> int:
    """Book the cache's positions of at most ``max_plies`` stones; returns
    the number of entries."""
    data = np.load(cache_path)
    entries: dict = {}
    for (current, mask), score in zip(
        data["keys"].tolist(), data["scores"].tolist()
    ):
        if bin(int(mask)).count("1") > max_plies:
            continue
        entries[canonical_key(int(current), int(mask))] = int(score)
    return write_book(entries, max_plies, out_path)


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    cache = args.get("--cache", os.path.join("results", "solver_cache.npz"))
    out = args.get(
        "--out", os.path.join(os.path.dirname(sv.DEFAULT_BOOK),
                              "7x6_cache.book")
    )
    n = convert(cache, out, int(args.get("--max_plies", 16)))
    print(f"book: {n} entries -> {out}")
    return n


if __name__ == "__main__":
    main()
