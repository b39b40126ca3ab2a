"""The AlphaZero policy-value net and its SGD step in plain PyTorch, on a
Flax-layout parameter tree (names and layouts as the checkpoint stores
them), computed in float32 with TF32 off.

Net: a conv->BN->relu stem (``ConvBlock_0``), ``depth`` residual blocks
(``ResidualBlock_i``: conv->BN->relu, conv->BN, plus a 1x1 conv->BN
projection of the block input, added, relu), a policy head (``ConvBlock_1``
1x1 conv->BN->relu, flatten in (H, W, C) order, ``Dense_0`` to logits) and a
value head (``ConvBlock_2``, flatten, ``Dense_1`` relu, ``Dense_2`` tanh).
Convs are 'SAME' padded and carry a bias. BatchNorm is Flax's: epsilon
1e-3; a training forward normalises with the batch mean and biased variance
and moves each running statistic by 0.01 towards them.

Loss: soft cross-entropy of the policy, squared error of the value, 1e-4
times the squared norm of every conv and dense kernel, plus an auxiliary
squared error of the value on labelled rows whose forward runs in eval mode.
Update: optax's SGD with momentum, ``trace = g + m * trace; p -= lr *
trace``, the learning rate piecewise constant in the step count.

``quantize``: a function applied to every conv and dense input and weight
(and its gradient passes straight through); the benchmark's precision
controls pass a rounding to float8 through it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-3
STAT_MOMENTUM = 0.99

Tree = Dict[str, torch.Tensor]  # "ConvBlock_0/Conv_0/kernel" -> tensor


def flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def to_device(flat: Dict[str, np.ndarray], device) -> Tree:
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in flat.items()}


def blocks(depth: int) -> List[Tuple[str, int, bool]]:
    """(path, kernel size, relu) of every conv block in forward order, the
    residual blocks' three as (conv1, conv2, proj)."""
    out = [("ConvBlock_0", 3, True)]
    for i in range(depth):
        out += [(f"ResidualBlock_{i}/ConvBlock_0", 3, True),
                (f"ResidualBlock_{i}/ConvBlock_1", 3, False),
                (f"ResidualBlock_{i}/ConvBlock_2", 1, False)]
    return out + [("ConvBlock_1", 1, True), ("ConvBlock_2", 1, True)]


def _straight_through(quantize):
    def q(x):
        return x + (quantize(x) - x).detach()
    return q


def forward(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
            train: bool = False, quantize: Optional[Callable] = None):
    """(logits (B, A), value (B,), new running statistics or None).

    obs: (B, H, W, C) float32. ``train`` normalises with batch statistics
    and returns the moved running statistics; eval mode uses ``stats``."""
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
        a, b, p = plan[1 + 3 * i:4 + 3 * i]
        y = conv_block(conv_block(x, *a), *b)
        x = torch.relu(conv_block(x, *p) + y)
    pol = conv_block(x, *plan[-2]).permute(0, 2, 3, 1).flatten(1)
    val = conv_block(x, *plan[-1]).permute(0, 2, 3, 1).flatten(1)
    logits = dense(pol, "Dense_0")
    value = torch.tanh(dense(torch.relu(dense(val, "Dense_1")), "Dense_2"))
    return logits, value[:, 0], new_stats


def evaluate(params: Tree, stats: Tree, obs: torch.Tensor, depth: int,
             quantize: Optional[Callable] = None, block: int = 4096):
    """Eval-mode (softmax probabilities, value), in blocks of rows."""
    probs, values = [], []
    with torch.no_grad():
        for i in range(0, obs.shape[0], block):
            logits, value, _ = forward(params, stats, obs[i:i + block], depth,
                                       quantize=quantize)
            probs.append(torch.softmax(logits, dim=-1))
            values.append(value)
    return torch.cat(probs), torch.cat(values)


def kernel_names(params: Tree) -> List[str]:
    return [k for k in params if k.endswith("/kernel")]


def learning_rate(values: Sequence[float], boundaries: Sequence[int],
                  step: int) -> float:
    """Piecewise constant: ``values[i]`` from ``boundaries[i-1]`` on."""
    rate = values[0]
    for i, boundary in enumerate(boundaries):
        if step >= boundary:
            rate = values[i + 1]
    return float(rate)


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


def float8_rounding(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (largest magnitude
    mapped to 448), back in float32: the precision one step below bfloat16
    that the controls compute in."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def half_batch(rows: torch.Tensor) -> torch.Tensor:
    """The first half of a batch: the fault 'half of the batch left out,
    the mean taken over the rest'."""
    return rows[: rows.shape[0] // 2]
