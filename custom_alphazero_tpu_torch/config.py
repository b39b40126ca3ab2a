"""Configuration dataclasses of the self-play slice.

Own copies of the JAX package's ``ConnectNConfig``, ``MCTSConfig``,
``ModelConfig`` and ``SelfPlayConfig``, with the same fields and defaults, so
a configuration snapshot (e.g. ``artifacts/c4-r5/config.json``) reads into
either package. Field comments live with the JAX originals
(custom_alphazero_tpu/config.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ConnectNConfig:
    width: int = 7
    height: int = 6
    n: int = 4
    gravity: bool = True

    def __post_init__(self):
        if not 2 <= self.n <= min(self.width, self.height):
            raise ValueError(f"n={self.n} does not fit a "
                             f"{self.width}x{self.height} board")

    @property
    def num_actions(self) -> int:
        # One action per column with gravity; otherwise one per cell,
        # ordered column-major (action = x * height + y).
        return self.width if self.gravity else self.width * self.height


@dataclass(frozen=True)
class MCTSConfig:
    simulations: int = 250
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.03
    dirichlet_fraction: float = 0.25
    use_dirichlet: bool = False
    greedy_from_move: int = 8
    use_solver: bool = False
    max_nodes: int = 0
    reuse_tree: bool = False
    topk_actions: int = 0
    use_gumbel: bool = False
    gumbel_max_considered: int = 16
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0
    fast_edge_stats: bool = False


@dataclass(frozen=True)
class ModelConfig:
    depth: int = 4
    filters: int = 128
    policy_filters: int = 2
    value_filters: int = 1
    value_hidden: int = 256
    l2: float = 1e-4
    momentum: float = 0.9
    lr_boundaries: Tuple[int, ...] = (150_000, 300_000)
    lr_values: Tuple[float, ...] = (1e-2, 1e-3, 1e-4)
    batch_size: int = 256
    grad_clip_norm: float = 0.0
    # bfloat16 activations (production on the card); "float32" for parity.
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class SelfPlayConfig:
    games_per_generation: int = 256
    discount: float = 1.0
    exclude_draws: bool = True
    continuous: bool = False
    max_plies: int = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never carries on on the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.index is None:  # tensors report their card's index
        device = torch.device("cuda", torch.cuda.current_device())
    return device
