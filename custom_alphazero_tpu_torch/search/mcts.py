"""The pieces of search/mcts.py that the fused Connect-N search uses.

Prior renormalization, the per-wave root Dirichlet noise plan and the noisy
root prior, with the JAX arithmetic in the same order so that root
statistics stay bit-equal to JAX (tests/test_torch_port_search.py). The
general ``MCTS.search`` (eager path, top-K priors, reuse) is not ported yet;
ROADMAP.md queues it.

Row sums over the action axis are taken left to right (``rowsum``), the
order XLA's CPU reduction uses for these short rows, so that non-dyadic
sums (the Dirichlet normaliser) round as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from custom_alphazero_tpu_torch.config import MCTSConfig
from custom_alphazero_tpu_torch.envs.core import Env
from custom_alphazero_tpu_torch.ops.rng import safe_gamma


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """(..., A) -> (..., 1) sum over the last axis, left to right."""
    total = x[..., 0:1]
    for a in range(1, x.shape[-1]):
        total = total + x[..., a:a + 1]
    return total


class MCTS:
    """Root-prior helpers of the batched PUCT search."""

    def __init__(self, env: Env, cfg: MCTSConfig = MCTSConfig()):
        self.env = env
        self.cfg = cfg

    def _renormalize(self, probs: torch.Tensor,
                     legal: torch.Tensor) -> torch.Tensor:
        """Legal-masked renormalized priors, uniform over legal moves when
        the mass is zero, with a 1e-35 floor so that ``prior > 0`` is
        exactly the legal mask."""
        masked = torch.where(legal, probs, 0.0)
        total = rowsum(masked)
        num_legal = legal.sum(dim=-1, keepdim=True).clamp_min(1)
        renormed = torch.where(
            total > 0.0,
            masked / total.clamp_min(1e-30),
            legal.float() / num_legal,
        )
        return torch.where(legal, renormed.clamp_min(1e-35), 0.0)

    def noise_plan(self, generator: Optional[torch.Generator]):
        """The search's root-noise source: the generator, or None when
        noise is off."""
        if not self.cfg.use_dirichlet:
            return None
        if generator is None:
            raise ValueError("use_dirichlet needs a torch.Generator")
        return generator

    def wave_noise(self, plan, batch: int, device) -> Optional[torch.Tensor]:
        """This wave's (B, A) Gamma draw, or None when noise is off. Draws
        come from the plan generator in wave order."""
        if plan is None:
            return None
        return safe_gamma(plan, self.cfg.dirichlet_alpha,
                          (batch, self.env.num_actions), device)

    def _root_noisy_prior(self, root_prior: torch.Tensor,
                          gamma: Optional[torch.Tensor]) -> torch.Tensor:
        """(1 - eps) * P + eps * Dir(alpha) over the legal root actions."""
        cfg = self.cfg
        if not cfg.use_dirichlet:
            return root_prior
        legal = root_prior > 0
        gamma = torch.where(legal, gamma, 0.0)
        noise = gamma / rowsum(gamma).clamp_min(1e-30)
        mixed = ((1.0 - cfg.dirichlet_fraction) * root_prior
                 + cfg.dirichlet_fraction * noise)
        # Keep the legal floor: noise can underflow to zero.
        return torch.where(legal, mixed.clamp_min(1e-35), 0.0)
