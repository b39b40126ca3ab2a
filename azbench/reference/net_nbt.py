"""KataGo's nested-bottleneck residual net with global pooling
(b18c384nbt) and its SGD step in plain PyTorch, on a Flax-layout parameter
tree, computed in float32 with TF32 off (the caller sets
``torch.backends`` so; ``drivers.common.strict_float32``).

Net (KataGo, https://github.com/lightvector/KataGo, python/modelconfigs.py
``b18c384nbt``: 18 blocks, trunk 384, mid 192, gpool 64; python/
model_pytorch.py ``NestedBottleneckResBlock``, ``ResBlock`` with
``c_gpool`` and ``KataGPool``; global pooling: D. Wu, arXiv 1902.10565,
appendix). With n(.) a BatchNorm (its scale and offset a channel at
inference) and every block pre-activation (the skip stream x is never
normalised or rectified):

    stem:  x = relu(n(conv3x3(obs)))                       (ConvBlock_0)
    block (NestedBottleneckBlock_i):
      a  = conv1x1(relu(n(x)))                  C -> mid    (NormConv_0)
      b  = a + inner(a)                                     (InnerBlock_0)
      c  = b + inner(b)                                     (InnerBlock_1)
      x' = x + conv1x1(relu(n(c)))              mid -> C    (NormConv_1)
    inner (InnerBlock_j):
      u  = relu(n(a))
      r  = conv3x3(u)                                       (NormConv_0)
      pooled (GlobalPoolBias_0, the first inner block of a pooled block):
        g = relu(n(conv3x3(u)))                 mid -> P    (Conv_0, BatchNorm_0)
        p = [mean(g), mean(g) (sqrt(cells) - 14) / 10, max(g)] over the board
        r = r + p W                             3P -> mid - P (Dense_0)
      inner(a) = conv3x3(relu(n(r)))            -> mid      (NormConv_1)
    trunk: relu(n(x)) of the last block's output           (BatchNorm_0)

In a pooled block r has mid - P channels; else mid. Then the heads of
``net_identity.py``: a policy head (``ConvBlock_1`` 1x1 conv of 2
filters->BN->relu, flatten in (H, W, C) order, ``Dense_0`` to logits) and
a value head (``ConvBlock_2`` 1x1 conv of 1 filter->BN->relu, flatten,
``Dense_1`` relu, ``Dense_2`` tanh). A NormConv's ``BatchNorm_0``
normalises its input, ahead of its ``Conv_0``. BatchNorm in training
normalises with the batch mean and biased variance and moves each running
statistic by 0.01 towards them.

Departures from KataGo's net, each as the port's net has it:

- the stem is the port's 3x3 conv->BN->ReLU, where KataGo's input layer
  is a 5x5 conv of its spatial features plus a dense layer of its global
  ones;
- the input is Connect-4's 4 planes (empty, own, opponent, ones), where
  KataGo's are 22 spatial and 19 global features of Go;
- the heads are the port's dense policy head to the 7 columns and tanh
  value head, where KataGo has a pooled policy head and value, ownership
  and score heads;
- every conv carries a bias ('SAME' padding), where KataGo's convs have
  none;
- the norms are Flax's BatchNorm (epsilon 1e-3, a learned scale), where
  b18c384nbt uses KataGo's fixed-scale norm (epsilon 1e-4);
- no board mask: the board is always full size, so the pooled means and
  maxima run over all 42 cells.

Loss and update as ``net.py``'s: soft cross-entropy, squared value error,
1e-4 x every kernel's squared norm (the pooled biases' dense kernels with
them), the auxiliary value term on labelled rows in eval mode; optax's SGD
with momentum.

``quantize``: a function applied to every conv and dense input and weight
and to every activation that the port's fused forward stores between its
launches (its gradient passing straight through), for the precision
controls: the stem's output, each conv's output after its bias and skip
(the trunk's skip stream x, the inner streams a and b, the block's c), and
in a pooled block r and g. The fused forward keeps those in bfloat16, so a
control of the whole forward rounds them too, the skip stream included;
``bfloat16_rounding`` gives the reading of a sound bfloat16 forward.
``gpool`` False: the no-gpool control, the same weights with the pooled
bias left out (r as conv1 gives it). ``inner_skip`` False: the
no-inner-skip control, each inner block's output without a or b added.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from azbench.reference.net_identity import (  # noqa: F401  (re-exported)
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


def bfloat16_rounding(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, back in float32: the configuration's own
    precision, for the reading that places a sound run's gaps."""
    return x.to(torch.bfloat16).to(torch.float32)


def forward(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
            train: bool = False, quantize: Optional[Callable] = None,
            batch: Optional[dict] = None, gpool: bool = True,
            inner_skip: bool = True):
    """(logits (B, A), value (B,), new running statistics or None).

    obs: (B, H, W, C) float32. ``train`` normalises with batch statistics
    and returns the moved running statistics (and, given ``batch``, puts
    each BatchNorm's batch mean and biased variance there); eval mode uses
    ``stats``. A block pools where ``params`` holds its first inner
    block's ``GlobalPoolBias_0``."""
    q = _straight_through(quantize) if quantize is not None else (lambda x: x)
    new_stats = {} if train else None

    def norm(x, bn):
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
        return ((x - mean[None, :, None, None])
                * torch.rsqrt(var + EPS)[None, :, None, None]
                * params[f"{bn}/scale"][None, :, None, None]
                + params[f"{bn}/bias"][None, :, None, None])

    def conv(x, path):
        w = params[f"{path}/Conv_0/kernel"]
        return F.conv2d(q(x), q(w.permute(3, 2, 0, 1)),  # HWIO->OIHW
                        params[f"{path}/Conv_0/bias"],
                        padding=w.shape[0] // 2)

    def conv_block(x, path):  # conv -> BN -> relu
        return torch.relu(norm(conv(x, path), f"{path}/BatchNorm_0"))

    def norm_conv(x, path):  # relu(BN(x)) -> conv
        return conv(torch.relu(norm(x, f"{path}/BatchNorm_0")), path)

    def dense(x, name):
        return q(x) @ q(params[f"{name}/kernel"]) + params[f"{name}/bias"]

    def pooled_bias(u, path):
        g = q(conv_block(u, path))
        cells = g.shape[2] * g.shape[3]
        mean = g.mean(dim=(2, 3))
        p = torch.cat([mean, mean * ((math.sqrt(cells) - 14.0) / 10.0),
                       g.amax(dim=(2, 3))], dim=1)
        return (q(p) @ q(params[f"{path}/Dense_0/kernel"]))[:, :, None, None]

    def inner(a, path):
        u = torch.relu(norm(a, f"{path}/NormConv_0/BatchNorm_0"))
        r = conv(u, f"{path}/NormConv_0")
        if f"{path}/GlobalPoolBias_0/Dense_0/kernel" in params:
            # Stored between the conv and the pooling launch.
            r = q(r)
            if gpool:
                r = r + pooled_bias(u, f"{path}/GlobalPoolBias_0")
        out = norm_conv(r, f"{path}/NormConv_1")
        return q(a + out if inner_skip else out)

    x = q(conv_block(obs.permute(0, 3, 1, 2), "ConvBlock_0"))
    for i in range(depth):
        path = f"NestedBottleneckBlock_{i}"
        y = q(norm_conv(x, f"{path}/NormConv_0"))
        for j in range(2):
            y = inner(y, f"{path}/InnerBlock_{j}")
        x = q(x + norm_conv(y, f"{path}/NormConv_1"))
    x = torch.relu(norm(x, "BatchNorm_0"))
    pol = conv_block(x, "ConvBlock_1").permute(0, 2, 3, 1).flatten(1)
    val = conv_block(x, "ConvBlock_2").permute(0, 2, 3, 1).flatten(1)
    logits = dense(pol, "Dense_0")
    value = torch.tanh(dense(torch.relu(dense(val, "Dense_1")), "Dense_2"))
    return logits, value[:, 0], new_stats


def evaluate(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
             quantize: Optional[Callable] = None, block: int = 1024,
             gpool: bool = True, inner_skip: bool = True):
    """Eval-mode (softmax probabilities, value), in blocks of rows."""
    probs, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            logits, value, _ = forward(params, stats, obs[i:i + block], depth,
                                       quantize=quantize, gpool=gpool,
                                       inner_skip=inner_skip)
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
