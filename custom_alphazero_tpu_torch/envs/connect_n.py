"""Batched Connect-N engine on torch tensors.

Same semantics as custom_alphazero_tpu/envs/connect_n.py, held to it ply for
ply by tests/test_torch_port_env.py:

- Canonical mirror: after every ply ``board = -placed`` so the side to move
  is always +1.
- Gravity: a stone dropped in column c lands on the lowest empty row (row 0
  is the top). Without gravity, action = x * height + y addresses cell
  (y, x).
- Win: n-in-a-row along rows, columns and both diagonals; draw when the
  board fills with no win. Terminal states are absorbing.
- Observation: planes [empty, mover, opponent, ones], float32 (H, W, 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from custom_alphazero_tpu_torch.config import ConnectNConfig, resolve_device
from custom_alphazero_tpu_torch.envs import core


@dataclass
class ConnectNState:
    """A batch of games.

    board: (B, H, W) int8, +1 = side-to-move stones, -1 = opponent stones.
    heights: (B, W) int32 stones per column.
    fullmove: (B,) int32 plies played.
    terminal: (B,) bool game over.
    won: (B,) bool the last mover won.
    """

    board: torch.Tensor
    heights: torch.Tensor
    fullmove: torch.Tensor
    terminal: torch.Tensor
    won: torch.Tensor

    def where(self, mask: torch.Tensor, other: "ConnectNState"):
        """Per game: ``self`` where ``mask`` (B,) is true, else ``other``."""

        def pick(a, b):
            return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        return ConnectNState(
            board=pick(self.board, other.board),
            heights=pick(self.heights, other.heights),
            fullmove=pick(self.fullmove, other.fullmove),
            terminal=pick(self.terminal, other.terminal),
            won=pick(self.won, other.won),
        )


def has_line(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) true where the bool plane (B, H, W) holds n-in-a-row in any of
    the 4 direction families. Shifted-window sums of 0/1 integers, exact."""
    p = plane.to(torch.int32)
    _, h, w = p.shape
    horiz = sum(p[:, :, i:w - n + 1 + i] for i in range(n))
    vert = sum(p[:, i:h - n + 1 + i, :] for i in range(n))
    diag = sum(p[:, i:h - n + 1 + i, i:w - n + 1 + i] for i in range(n))
    anti = sum(
        p[:, i:h - n + 1 + i, n - 1 - i:w - i] for i in range(n)
    )
    hit = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for sums in (horiz, vert, diag, anti):
        hit = hit | (sums == n).flatten(1).any(dim=1)
    return hit


class ConnectN(core.Env):
    """Connect-N over a static-geometry board, batched."""

    def __init__(self, cfg: ConnectNConfig = ConnectNConfig()):
        self.cfg = cfg
        self.num_actions = cfg.num_actions
        self.obs_shape = (cfg.height, cfg.width, 4)

    def init(self, batch: int, device=None) -> ConnectNState:
        cfg = self.cfg
        device = resolve_device(device)
        return ConnectNState(
            board=torch.zeros((batch, cfg.height, cfg.width), dtype=torch.int8,
                              device=device),
            heights=torch.zeros((batch, cfg.width), dtype=torch.int32,
                                device=device),
            fullmove=torch.zeros((batch,), dtype=torch.int32, device=device),
            terminal=torch.zeros((batch,), dtype=torch.bool, device=device),
            won=torch.zeros((batch,), dtype=torch.bool, device=device),
        )

    def _cell(self, state: ConnectNState, action: torch.Tensor):
        cfg = self.cfg
        action = action.long()
        if cfg.gravity:
            col = action
            row = cfg.height - 1 - state.heights.gather(1, col[:, None])[:, 0]
        else:
            col = action // cfg.height
            row = action % cfg.height
        # Clamp so that a masked illegal action still indexes the board.
        return row.long().clamp(0, cfg.height - 1), col

    def _placed(self, state: ConnectNState, action: torch.Tensor):
        row, col = self._cell(state, action)
        placed = state.board.clone()
        batch = torch.arange(placed.shape[0], device=placed.device)
        placed[batch, row, col] = 1
        if self.cfg.gravity:
            heights = state.heights.clone()
            heights[batch, col] += 1
        else:
            heights = state.heights
        return placed, heights

    def step(self, state: ConnectNState, action: torch.Tensor):
        cfg = self.cfg
        placed, heights = self._placed(state, action)
        win = has_line(placed == 1, cfg.n)
        filled = state.fullmove + 1 >= cfg.height * cfg.width
        stepped = ConnectNState(
            board=-placed,  # mirror: the next side to move becomes +1
            heights=heights,
            fullmove=state.fullmove + 1,
            terminal=win | filled,
            won=win,
        )
        # Absorbing terminal states: stepping a finished game is a no-op.
        keep = state.terminal
        reward = torch.where(keep | ~win, 0.0, 1.0)
        return state.where(keep, stepped), reward

    def step_lite(self, state: ConnectNState, action: torch.Tensor):
        """Descent-path step: place + mirror, no win detection."""
        placed, heights = self._placed(state, action)
        return ConnectNState(
            board=-placed,
            heights=heights,
            fullmove=state.fullmove + 1,
            terminal=torch.zeros_like(state.terminal),
            won=torch.zeros_like(state.won),
        )

    def legal_mask(self, state: ConnectNState) -> torch.Tensor:
        if self.cfg.gravity:
            # A column is open iff its top cell is empty.
            mask = state.board[:, 0, :] == 0
        else:
            mask = (state.board == 0).transpose(1, 2).reshape(
                state.board.shape[0], -1
            )
        return mask & ~state.terminal[:, None]

    def observe(self, state: ConnectNState) -> torch.Tensor:
        board = state.board
        return torch.stack(
            [
                (board == 0).float(),
                (board == 1).float(),
                (board == -1).float(),
                torch.ones_like(board, dtype=torch.float32),
            ],
            dim=-1,
        )

    def is_terminal(self, state: ConnectNState) -> torch.Tensor:
        return state.terminal

    def terminal_value(self, state: ConnectNState) -> torch.Tensor:
        return torch.where(state.won, -1.0, 0.0)
