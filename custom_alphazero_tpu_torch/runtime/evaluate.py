"""Leaf evaluation closure (the port of runtime/train.py::make_evaluate_fn)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from custom_alphazero_tpu_torch.models.policy_value import PolicyValueNet
from custom_alphazero_tpu_torch.ops import fused_net

EvaluateFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_evaluate_fn(net: PolicyValueNet) -> EvaluateFn:
    """(B, H, W, C) observations -> (full softmax (B, A), value (B,)), both
    float32. Legal masking happens in the search, as in JAX.

    An eval-mode bf16 net on CUDA observations runs the fused forward
    (ops/fused_net.py: one kernel per conv with its BatchNorm, bias,
    residual and ReLU); anything else runs ``net(obs)``."""
    fused = fused_net.FusedForward(net)

    @torch.inference_mode()
    def evaluate(obs: torch.Tensor):
        if fused_net.applies(net, obs):
            logits, value = fused(obs)
        else:
            logits, value = net(obs)
        return torch.softmax(logits.float(), dim=-1), value.float()

    return evaluate
