"""AlphaZero losses and optimizer (the port of models/losses.py).

- policy loss: mean over the batch of the soft cross-entropy
  -sum(pi * log_softmax(logits));
- value loss: mean squared error to the game outcome z;
- L2 penalty on conv and dense kernels only (not biases, not BatchNorm),
  added to the loss: it is not a ``weight_decay``;
- SGD with momentum and a piecewise-constant learning rate keyed on the
  cumulative optimizer step count, as plain functions on tensors:
  optax's ``trace = g + momentum * trace; p -= lr * trace``, preceded by
  optax's global-norm clip, which has no epsilon.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from custom_alphazero_tpu_torch.config import ModelConfig


def policy_loss(logits: torch.Tensor, target_pi: torch.Tensor) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    return -(target_pi * log_probs).sum(dim=-1).mean()


def value_loss(value: torch.Tensor, target_z: torch.Tensor) -> torch.Tensor:
    return (value - target_z).square().mean()


def kernel_parameters(net: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The conv and dense weights of ``net``: what the L2 penalty covers."""
    return [m.weight for m in net.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]


def l2_penalty(kernels: Sequence[torch.Tensor], scale: float) -> torch.Tensor:
    return scale * sum(k.square().sum() for k in kernels)


def learning_rate(cfg: ModelConfig, step: int) -> float:
    """The piecewise-constant learning rate at optimizer step ``step``: the
    value switches at ``step >= boundary``. A train step reads it at the
    step count before its update. Rounded to float32 as the JAX schedule
    computes it: the initial value times the ratios passed so far (a
    schedule without boundaries is the plain value)."""
    if not cfg.lr_boundaries:
        return float(cfg.lr_values[0])
    rate = torch.tensor(cfg.lr_values[0], dtype=torch.float32)
    for i, boundary in enumerate(cfg.lr_boundaries):
        if step >= boundary:
            rate = rate * torch.tensor(
                cfg.lr_values[i + 1] / cfg.lr_values[i], dtype=torch.float32)
    return rate.item()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None,
                        ) -> List[torch.Tensor]:
    """optax's clip: unchanged while the global norm is below ``max_norm``,
    else ``(g / norm) * max_norm``. No epsilon, and no host sync. ``norm``:
    the global norm where ``grads`` hold only part of the gradient (a
    sharded layer's rows)."""
    if norm is None:
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
    below = norm < max_norm
    return [torch.where(below, g, (g / norm) * max_norm) for g in grads]


@torch.no_grad()
def sgd_momentum_update(params: Sequence[torch.Tensor],
                        trace: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        lr: float, momentum: float) -> None:
    """In place: trace = g + momentum * trace; p -= lr * trace."""
    torch._foreach_mul_(trace, momentum)
    torch._foreach_add_(trace, grads)
    torch._foreach_add_(params, trace, alpha=-lr)
