"""Leaf evaluation closure (the port of runtime/train.py::make_evaluate_fn)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from custom_alphazero_tpu_torch.models.policy_value import PolicyValueNet

EvaluateFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_evaluate_fn(net: PolicyValueNet) -> EvaluateFn:
    """(B, H, W, C) observations -> (full softmax (B, A), value (B,)), both
    float32. Legal masking happens in the search, as in JAX."""

    @torch.inference_mode()
    def evaluate(obs: torch.Tensor):
        logits, value = net(obs)
        return torch.softmax(logits.float(), dim=-1), value.float()

    return evaluate
