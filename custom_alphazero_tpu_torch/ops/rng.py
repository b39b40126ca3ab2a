"""Bounded-iteration Gamma sampling for root Dirichlet noise.

The port of ops/rng.py::safe_gamma, on torch's own random stream (it does
not replay JAX's threefry bits; the parity tests inject JAX's draws
instead, and this sampler is tested in distribution). A search draws
all its waves' root noise as one (S, B, A) block, one call here, before
its waves: torch's stream order is "block", not "per wave" (one call's
Philox layout on CUDA differs from S calls'; on the CPU, at alpha 1, the
block equals S per-wave draws bit for bit). ``safe_gamma.calls`` counts
the calls.

- alpha == 1: the exact exponential -log U, U in [tiny, 1) — the Connect-4
  production regime (dirichlet_alpha=1.0).
- alpha >= 1 otherwise: Marsaglia-Tsang with a fixed number of candidate
  (normal, uniform) pairs, an accepted one taken; a miss (probability
  <= 0.05^ATTEMPTS) falls back to d = alpha - 1/3.
- alpha < 1: Gamma(alpha + 1) * U^(1/alpha) (the boosting lemma).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

ATTEMPTS = 8


def _uniform(generator, shape, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_min(tiny)


def safe_gamma(generator: torch.Generator, alpha: float, shape, device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 Gamma(alpha) draws of ``shape`` from ``generator``, written
    into ``out`` (float32, of ``shape``) when given."""
    alpha = float(alpha)
    if alpha <= 0.0:
        raise ValueError(f"alpha={alpha} must be positive")
    shape = tuple(shape)
    safe_gamma.calls += 1
    if alpha == 1.0:
        # In place: rand, clamp, log, neg, four launches on the card.
        u = torch.rand(shape, generator=generator, device=device, out=out)
        return u.clamp_min_(torch.finfo(torch.float32).tiny).log_().neg_()

    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    tiny = torch.finfo(torch.float32).tiny
    g = torch.full(shape, d, dtype=torch.float32, device=device)
    # The last accepted candidate wins; candidates are i.i.d., so that has
    # the law of the first accepted one.
    for _ in range(ATTEMPTS):
        x = torch.randn(shape, generator=generator, device=device)
        u = _uniform(generator, shape, device)
        t = 1.0 + c * x
        v = t * t * t
        ok = (v > 0.0) & (
            torch.log(u)
            < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(tiny))
        )
        g = torch.where(ok, d * v, g)
    if boost:
        ub = _uniform(generator, shape, device)
        g = g * torch.exp(torch.log(ub) / alpha)
    return g if out is None else out.copy_(g)


safe_gamma.calls = 0


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """float32 standard Gumbel draws -log(-log U), U in [tiny, 1), as
    ``jax.random.gumbel`` draws them."""
    return -torch.log(-torch.log(_uniform(generator, tuple(shape), device)))
