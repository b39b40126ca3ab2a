"""Leela Chess Zero's squeeze-excitation residual net and its SGD step in
plain PyTorch, on a Flax-layout parameter tree, computed in float32 with
TF32 off (the caller sets ``torch.backends`` so; ``drivers.common.
strict_float32``).

Net (lczero-training, ``tf/tfprocess.py``: ``residual_block`` with
``squeeze_excitation`` and ``ApplySqueezeExcitation``; the T40 run's nets
are 20 blocks x 256 filters; squeeze-excitation is Hu et al., arXiv
1709.01507, to which Lc0 adds a learned offset): a conv->BN->relu stem
(``ConvBlock_0``), then ``depth`` residual blocks (``ResidualBlock_i``):

    h       = relu(BN1(conv1(x)))                    (ConvBlock_0)
    y       = BN2(conv2(h))                          (ConvBlock_1)
    s       = the mean of y over the board's cells   (B, C)
    z       = relu(s W1 + b1)                        (SqueezeExcite_0/Dense_0)
    [g | o] = z W2 + b2                              (SqueezeExcite_0/Dense_1)
    out     = relu(x + sigmoid(g) * y + o)

all 3x3 convs of the same filters, W1 (C, C / ratio), W2 (C / ratio, 2C);
then the heads of ``net_identity.py``: a policy head (``ConvBlock_1`` 1x1
conv of 2 filters->BN->relu, flatten in (H, W, C) order, ``Dense_0`` to
logits) and a value head (``ConvBlock_2`` 1x1 conv of 1 filter->BN->relu,
flatten, ``Dense_1`` relu, ``Dense_2`` tanh). BatchNorm in training
normalises with the batch mean and biased variance and moves each running
statistic by 0.01 towards them.

Departures from Lc0's net, each as the port's net has it:

- the input is Connect-4's 4 planes (empty, own, opponent, ones), where
  Lc0's inputs are 112 planes of 8 x 8 (history, castling, rule-50);
- the policy head is AlphaGo Zero's dense head to the 7 columns and the
  value head a tanh, where Lc0's T40 nets have a convolutional policy head
  and a win/draw/loss value head;
- every conv carries a bias ('SAME' padding), where Lc0's convs have none
  before BatchNorm;
- BatchNorm's epsilon is Flax's 1e-3 and it has a learned scale.

Loss and update as ``net.py``'s: soft cross-entropy, squared value error,
1e-4 x every kernel's squared norm (the gate's dense kernels with them, as
Lc0 regularises them), the auxiliary value term on labelled rows in eval
mode; optax's SGD with momentum.

``quantize``: a function applied to every conv and dense input and weight
(its gradient passing straight through), for the precision controls.
``gate`` False: the no-gate control, the same weights with sigmoid(g) taken
as 1 and o as 0 (each block's y added as it is).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from azbench.reference.net_identity import (  # noqa: F401  (re-exported)
    EPS,
    STAT_MOMENTUM,
    Tree,
    _straight_through,
    blocks,
    flatten,
    float8_rounding,
    kernel_names,
    learning_rate,
    to_device,
)


def forward(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
            train: bool = False, quantize: Optional[Callable] = None,
            batch: Optional[dict] = None, gate: bool = True):
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

    def excite(y, path):
        if not gate:
            return y
        z = torch.relu(dense(y.mean(dim=(2, 3)), f"{path}/Dense_0"))
        g, o = dense(z, f"{path}/Dense_1").chunk(2, dim=1)
        return torch.sigmoid(g)[:, :, None, None] * y + o[:, :, None, None]

    plan = blocks(depth)
    x = conv_block(obs.permute(0, 3, 1, 2), *plan[0])
    for i in range(depth):
        a, b = plan[1 + 2 * i:3 + 2 * i]
        y = conv_block(conv_block(x, *a), *b)
        x = torch.relu(x + excite(y, f"ResidualBlock_{i}/SqueezeExcite_0"))
    pol = conv_block(x, *plan[-2]).permute(0, 2, 3, 1).flatten(1)
    val = conv_block(x, *plan[-1]).permute(0, 2, 3, 1).flatten(1)
    logits = dense(pol, "Dense_0")
    value = torch.tanh(dense(torch.relu(dense(val, "Dense_1")), "Dense_2"))
    return logits, value[:, 0], new_stats


def evaluate(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
             quantize: Optional[Callable] = None, block: int = 1024,
             gate: bool = True):
    """Eval-mode (softmax probabilities, value), in blocks of rows."""
    probs, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            logits, value, _ = forward(params, stats, obs[i:i + block], depth,
                                       quantize=quantize, gate=gate)
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
