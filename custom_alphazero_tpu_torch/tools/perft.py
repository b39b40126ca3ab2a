"""Perft: exhaustive move-path counting, to validate the chess rules.

The port of tools/perft.py. Batched breadth-first expansion: every frontier
position's legal mask is cached in its state, so a level's children are
one ``Chess.step`` per chunk of (parent, action) pairs; the last level is
counted from the masks without stepping.

CLI (on the card):  python -m custom_alphazero_tpu_torch.tools.perft "<fen>" <depth>
(``start`` for the start position; ``--device=cpu`` to run on the CPU.)
"""

from __future__ import annotations

import sys

import torch

from custom_alphazero_tpu_torch.config import resolve_device
from custom_alphazero_tpu_torch.envs.chess.engine import Chess, ChessState

# Positions stepped at once: the legality pass holds about 30 KB of
# temporaries per position.
CHUNK = 4096


def perft(env: Chess, root: ChessState, depth: int, chunk: int = CHUNK,
          verbose: bool = False) -> int:
    """Count the move paths of length ``depth`` from ``root`` (one game)."""
    if depth == 0:
        return 1
    frontier = root
    for level in range(depth - 1):
        parents, actions = env.legal_mask(frontier).nonzero(as_tuple=True)
        total = len(parents)
        if total == 0:
            return 0
        frontier = ChessState.cat([
            env.step(frontier.take(parents[lo:lo + chunk]),
                     actions[lo:lo + chunk])[0]
            for lo in range(0, total, chunk)
        ])
        if verbose:
            print(f"depth {level + 1}: {total} nodes", file=sys.stderr)
    return int(env.legal_mask(frontier).sum())


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    for arg in [a for a in args if a.startswith("--device=")]:
        device = arg.partition("=")[2]
        args.remove(arg)
    fen, depth = args[0], int(args[1])
    env = Chess()
    device = resolve_device(device)
    root = env.init(1, device) if fen == "start" else env.from_fen(fen,
                                                                  device)
    print(perft(env, root, depth, verbose=True))


if __name__ == "__main__":
    main()
