"""The chess engine, batched on torch tensors (the port of envs/chess/)."""

from custom_alphazero_tpu_torch.envs.chess import tables  # noqa: F401
from custom_alphazero_tpu_torch.envs.chess.engine import (  # noqa: F401
    Chess,
    ChessState,
)
