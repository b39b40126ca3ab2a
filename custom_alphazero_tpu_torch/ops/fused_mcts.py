"""Fused Connect-N search, (games, nodes * actions) layout, on the card.

The port of custom_alphazero_tpu/ops/fused_mcts.py (the v1 fused search).
It runs the same software-pipelined waves as the v2 search
(ops/fused_mcts_v2.py, which holds the loop), on the v1 kernel's carry:
float32 edge arrays (B, N*A), edge ``k = node * A + action``, so a node's A
edges are one contiguous row, and (B, 8, 8) boards at the kernel's
boundary.

``wave_step`` launches the CUDA kernel csrc/fused_mcts.cu for CUDA tensors;
``wave_step_reference`` is its plain PyTorch version, which the wrapper
takes for CPU tensors; ``wave_reference`` is the wave alone, as the TPU
kernel computes it. Where the v1 TPU kernel differs from the v2 one (the
argmax over the whole edge range, lines counted on the unpadded board), the
port follows it literally; ``fused_mcts_v2.wave_plain`` says why neither
changes a search.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from custom_alphazero_tpu_torch.envs.connect_n import ConnectNState
from custom_alphazero_tpu_torch.ops import fused_mcts_v2
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (  # noqa: F401
    StepBuffers,
    WaveGeometry,
    supports,
)

_PH = 8
_PW = 8


class Carry(NamedTuple):
    prior: torch.Tensor          # (B, N*A)
    children: torch.Tensor       # (B, N*A)
    visits: torch.Tensor         # (B, N*A)
    value_sum: torch.Tensor      # (B, N*A)
    parent: torch.Tensor         # (B, N)
    parent_action: torch.Tensor  # (B, N)
    expanded: torch.Tensor       # (B, N)
    is_terminal: torch.Tensor    # (B, N)
    reward: torch.Tensor         # (B, N)
    node_count: torch.Tensor     # (B, 1)
    leaf: torch.Tensor           # (B, 1)
    leaf_terminal: torch.Tensor  # (B, 1)


def _edge_rows(carry) -> Carry:
    """The carry with its edge arrays as (B, N*A) rows."""
    bsz = carry.parent.shape[0]
    return Carry(*(t.view(bsz, -1) for t in carry[:4]), *carry[4:])


def init_carry(env, root_states: ConnectNState, num_nodes: int) -> Carry:
    """A new fresh-tree carry: the root in slot 0, terminal roots marked."""
    # Fresh edge arrays hold one value each (0 or -1), so only their shape
    # differs between the two layouts.
    return _edge_rows(fused_mcts_v2.init_carry(env, root_states, num_nodes))


def _as_v2(carry: Carry) -> fused_mcts_v2.Carry:
    """The carry seen in the v2 layout: (B, A, N) views of the edges."""
    bsz, n = carry.parent.shape
    edges = (t.view(bsz, n, -1).transpose(1, 2) for t in carry[:4])
    return fused_mcts_v2.Carry(*edges, *carry[4:])


def wave_reference(wave: int, mixed, renormed, value, root_board,
                   carry: Carry, geom: WaveGeometry):
    """One wave in plain PyTorch: updates ``carry`` in place (the TPU
    kernel aliases it) and returns ``(carry, leaf_board)``, boards
    (B, 8, 8)."""
    bsz = root_board.shape[0]
    leaf_board = fused_mcts_v2.wave_plain(
        wave, mixed, renormed, value, root_board.reshape(bsz, _PH * _PW),
        _as_v2(carry), geom, v1_rules=True,
    )
    return carry, leaf_board.view(bsz, _PH, _PW)


def wave_step_reference(buffers: StepBuffers, carry: Carry,
                        geom: WaveGeometry) -> None:
    """The plain PyTorch version of kernel K2's step (boards (B, 8, 8))."""
    wave_step_reference.calls += 1
    fused_mcts_v2.wave_step_plain(buffers, _as_v2(carry), geom, v1_rules=True)


wave_step_reference.calls = 0


def wave_step(buffers: StepBuffers, carry: Carry, geom: WaveGeometry,
              record: bool = False) -> None:
    """One step: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Updates ``buffers`` and ``carry`` in place. ``record``: as
    in ``fused_mcts_v2.wave_step``."""
    if buffers.root_board.device.type == "cpu":
        return wave_step_reference(buffers, carry, geom)
    bsz, n = carry.parent.shape
    fused_mcts_v2.launch("fused_mcts", buffers, carry, geom,
                         (bsz, n * buffers.probs.shape[-1]))
    if not record:
        wave_step.launches += 1


# Kernel launches: eager ones and, in the search, replays of a captured one.
wave_step.launches = 0


class FusedConnectNSearch(fused_mcts_v2.FusedConnectNSearchV2):
    """Fresh-tree PUCT search of gravity Connect-N boards up to 8x8, on the
    v1 kernel. ``search_root_stats`` gives what ``MCTS.search`` +
    ``root_child_visits`` / ``root_child_value_sums`` give, bit for bit."""

    _wave_step = staticmethod(wave_step)
    _board_shape = (_PH, _PW)

    def _empty_carry(self, bsz: int, num_nodes: int):
        return _edge_rows(super()._empty_carry(bsz, num_nodes))

    def _root_stats(self, carry) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.env.num_actions
        return (carry.visits[:, :a].to(torch.int32),
                carry.value_sum[:, :a].clone())
