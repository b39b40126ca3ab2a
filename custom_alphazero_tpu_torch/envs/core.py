"""Batched environment interface.

The JAX package writes single-game pure functions and ``vmap``s them; here
every method takes and returns a whole batch of games, the leading axis of
every state tensor. The canonical-perspective contract is the JAX one
(custom_alphazero_tpu/envs/core.py):

- The state is stored from the side to move's point of view (+1 = mover).
- ``step`` applies the mover's action, flips perspective and returns the
  reward for the player who just moved: +1 win, 0 otherwise.
- Terminal states are absorbing: stepping them is a no-op with reward 0.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

EnvState = Any


class Env:
    """Batched environment protocol; all shapes are static per batch."""

    num_actions: int
    obs_shape: Tuple[int, int, int]

    def init(self, batch: int, device=None) -> EnvState:
        raise NotImplementedError

    def step(self, state: EnvState,
             action: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Apply (B,) actions; returns (next_state, (B,) reward-for-mover)."""
        raise NotImplementedError

    def step_lite(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Place + mirror + bookkeeping only (terminal bits left stale)."""
        return self.step(state, action)[0]

    def legal_mask(self, state: EnvState) -> torch.Tensor:
        """(B, num_actions) bool."""
        raise NotImplementedError

    def observe(self, state: EnvState) -> torch.Tensor:
        """(B, H, W, C) float32 canonical observation."""
        raise NotImplementedError

    def is_terminal(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def terminal_value(self, state: EnvState) -> torch.Tensor:
        """Value for the side to move at a terminal state: -1 if the last
        mover won, 0 on a draw."""
        raise NotImplementedError
