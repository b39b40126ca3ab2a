"""AlphaZero's policy-value net, with identity skips, and its SGD step in
plain PyTorch, on a Flax-layout parameter tree, computed in float32 with
TF32 off (the caller sets ``torch.backends`` so; ``drivers.common.
strict_float32``).

Net (AlphaZero, Silver et al., Science 362:1140 (2018), Methods; its block
and heads are AlphaGo Zero's, Silver et al., Nature 550:354 (2017),
Methods, "Neural network architecture"): a conv->BN->relu stem
(``ConvBlock_0``), then ``depth`` residual blocks (``ResidualBlock_i``:
conv->BN->relu (``ConvBlock_0``), conv->BN (``ConvBlock_1``), the block's
input itself added, relu), all 3x3 convs of the same filters; a policy head
(``ConvBlock_1`` 1x1 conv of 2 filters->BN->relu, flatten in (H, W, C)
order, ``Dense_0`` to logits) and a value head (``ConvBlock_2`` 1x1 conv of
1 filter->BN->relu, flatten, ``Dense_1`` relu, ``Dense_2`` tanh). BatchNorm
in training normalises with the batch mean and biased variance and moves
each running statistic by 0.01 towards them.

Departures from the papers, each as the port's net has it:

- the input is Connect-4's 4 planes (empty, own, opponent, ones), where
  AlphaZero's inputs stack a history of planes for chess, shogi and Go;
- the policy head is AlphaGo Zero's dense head to the 7 columns, where
  AlphaZero's chess head is a conv to 8 x 8 x 73 move planes;
- every conv carries a bias ('SAME' padding), where the papers' convs
  have none before BatchNorm;
- BatchNorm's epsilon is Flax's 1e-3.

Loss and update as ``net.py``'s: soft cross-entropy, squared value error,
1e-4 x every kernel's squared norm, the auxiliary value term on labelled
rows in eval mode; optax's SGD with momentum.

``quantize``: a function applied to every conv and dense input and weight
(its gradient passing straight through), for the precision controls.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from azbench.reference.net import (  # noqa: F401  (re-exported helpers)
    EPS,
    STAT_MOMENTUM,
    Tree,
    _straight_through,
    flatten,
    float8_rounding,
    kernel_names,
    learning_rate,
    to_device,
)


def blocks(depth: int) -> List[Tuple[str, int, bool]]:
    """(path, kernel size, relu) of every conv block in forward order, the
    residual blocks' two as (conv1, conv2)."""
    out = [("ConvBlock_0", 3, True)]
    for i in range(depth):
        out += [(f"ResidualBlock_{i}/ConvBlock_0", 3, True),
                (f"ResidualBlock_{i}/ConvBlock_1", 3, False)]
    return out + [("ConvBlock_1", 1, True), ("ConvBlock_2", 1, True)]


def forward(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
            train: bool = False, quantize: Optional[Callable] = None,
            batch: Optional[dict] = None):
    """(logits (B, A), value (B,), new running statistics or None).

    obs: (B, H, W, C) float32. ``train`` normalises with batch statistics
    and returns the moved running statistics (and, given ``batch``, puts
    each BatchNorm's batch mean and biased variance there); eval mode uses
    ``stats``."""
    q = _straight_through(quantize) if quantize is not None else (lambda x: x)
    new_stats = {} if train else None

    def conv_block(x, path, kernel, relu):
        w = params[f"{path}/Conv_0/kernel"].permute(3, 2, 0, 1)  # HWIO->OIHW
        x = F.conv2d(q(x), q(w), params[f"{path}/Conv_0/bias"],
                     padding=kernel // 2)
        bn = f"{path}/BatchNorm_0"
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
            new_stats[f"{bn}/mean"] = (STAT_MOMENTUM * stats[f"{bn}/mean"]
                                       + (1 - STAT_MOMENTUM) * mean.detach())
            new_stats[f"{bn}/var"] = (STAT_MOMENTUM * stats[f"{bn}/var"]
                                      + (1 - STAT_MOMENTUM) * var.detach())
            if batch is not None:
                batch[f"{bn}/mean"], batch[f"{bn}/var"] = mean, var
        else:
            mean, var = stats[f"{bn}/mean"], stats[f"{bn}/var"]
        x = ((x - mean[None, :, None, None])
             * torch.rsqrt(var + EPS)[None, :, None, None]
             * params[f"{bn}/scale"][None, :, None, None]
             + params[f"{bn}/bias"][None, :, None, None])
        return torch.relu(x) if relu else x

    def dense(x, name):
        return q(x) @ q(params[f"{name}/kernel"]) + params[f"{name}/bias"]

    plan = blocks(depth)
    x = conv_block(obs.permute(0, 3, 1, 2), *plan[0])
    for i in range(depth):
        a, b = plan[1 + 2 * i:3 + 2 * i]
        x = torch.relu(x + conv_block(conv_block(x, *a), *b))
    pol = conv_block(x, *plan[-2]).permute(0, 2, 3, 1).flatten(1)
    val = conv_block(x, *plan[-1]).permute(0, 2, 3, 1).flatten(1)
    logits = dense(pol, "Dense_0")
    value = torch.tanh(dense(torch.relu(dense(val, "Dense_1")), "Dense_2"))
    return logits, value[:, 0], new_stats


def evaluate(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
             quantize: Optional[Callable] = None, block: int = 1024):
    """Eval-mode (softmax probabilities, value), in blocks of rows."""
    probs, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            logits, value, _ = forward(params, stats, obs[i:i + block], depth,
                                       quantize=quantize)
            probs.append(torch.softmax(logits, dim=-1))
            values.append(value)
    return torch.cat(probs), torch.cat(values)


def sgd_step(params: Tree, stats: Tree, trace: Tree, obs, pi, z,
             aux_obs, aux_z, depth: int, l2: float, aux_weight: float,
             lr: float, momentum: float,
             quantize: Optional[Callable] = None):
    """One step: (params, stats, trace, losses dict, gradients), all new
    tensors. ``aux_obs``/``aux_z`` None: no auxiliary term."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    aux = torch.zeros((), device=obs.device)
    if aux_obs is not None and aux_weight > 0:
        _, aux_value, _ = forward(leaves, stats, aux_obs, depth,
                                  quantize=quantize)
        aux = (aux_value - aux_z).square().mean()
    logits, value, new_stats = forward(leaves, stats, obs, depth, train=True,
                                       quantize=quantize)
    lp = -(pi * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    lv = (value - z).square().mean()
    reg = l2 * sum(leaves[k].square().sum() for k in kernel_names(leaves))
    loss = lp + lv + reg + aux_weight * aux
    names = list(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k]
                                                        for k in names])))
    with torch.no_grad():
        new_trace = {k: grads[k] + momentum * trace[k] for k in names}
        new_params = {k: params[k] - lr * new_trace[k] for k in names}
    losses = {"loss": loss.item(), "policy": lp.item(), "value": lv.item(),
              "l2": reg.item(), "aux": aux.item()}
    return new_params, new_stats, new_trace, losses, grads
