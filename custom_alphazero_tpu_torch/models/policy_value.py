"""Policy-value residual network (the port of models/policy_value.py).

Layer for layer the Flax net: a conv->BN->relu stem, ``depth`` residual
blocks of (conv->BN->relu, conv->BN) plus a 1x1 conv->BN projection of the
block input, added then relu'd; a policy head (1x1 conv, 2 filters ->
flatten -> dense to logits) and a value head (1x1 conv, 1 filter -> flatten
-> dense(value_hidden) -> relu -> dense(1) -> tanh).
``cfg.residual_projection=False`` (the port's own option) drops the
projection: each block adds its input itself, as AlphaGo Zero's and
AlphaZero's blocks do (Silver et al. 2017, 2018, Methods).
``cfg.se_ratio > 0`` (the port's own, identity blocks only) gates each
block's second conv output with Leela Chess Zero's squeeze-excitation
(``SqueezeExcite``) before the add. ``cfg.mid_filters > 0`` (the port's
own) builds KataGo's pre-activation nested bottleneck blocks instead
(``NestedBottleneckBlock``; ``cfg.gpool_blocks`` of them pooled), then a
final BatchNorm and ReLU (``trunk_norm``) before the heads.

Input is NHWC like the JAX net, and both heads flatten in NHWC order so the
Flax dense kernels carry over unchanged (models/convert.py). ``BatchNorm``
is Flax's: ``epsilon=1e-3``, running statistics that move by 0.01 per train
step, and a running variance fed by the biased batch variance.

``cfg.compute_dtype == "bfloat16"`` runs the trunk, the head convs and the
value hidden layer under bf16 autocast, and the two final dense layers in
float32 on float32 inputs, which is where the Flax net keeps float32.
Autocast rounds at other points than Flax's bf16 BatchNorm, so bf16 outputs
agree with JAX only to a looser bound (tests/test_torch_port_net.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from custom_alphazero_tpu_torch.config import ModelConfig
from custom_alphazero_tpu_torch.parallel import distributed


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over NCHW.

    ``nn.BatchNorm2d`` feeds its running variance the unbiased batch
    variance; Flax feeds it the biased one, so the two drift apart by
    n / (n - 1) per step. In training mode this module normalises with the
    batch statistics and updates both running statistics itself, from the
    mean and inverse deviation the normalisation computed. It has no
    ``num_batches_tracked``.

    Under data parallelism (``data_parallel(net, group, dp)``) a training
    forward normalises with the statistics of the global batch, as JAX's
    single program over the global batch does: per-channel sums and sums
    of squares are summed over the data group (and their gradient with
    them), the variance is Flax's ``E[x^2] - E[x]^2``, and the running
    statistics take the global mean and biased variance."""

    momentum = 0.01  # 1 - Flax's 0.99
    eps = 1e-3
    # (data group, its size) under data parallelism, else None.
    reduce = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
            if torch.is_grad_enabled():
                # Autograd keeps the statistics for the backward pass, and
                # a train-mode forward before it updates the buffers in
                # place (the train step's auxiliary forward): keep copies.
                mean, var = mean.clone(), var.clone()
            return torch.nn.functional.batch_norm(
                x, mean, var, self.weight, self.bias, False, 0.0, self.eps)
        if self.reduce is not None:
            return self._global_forward(x)
        if x.device.type == "cpu":
            # PyTorch's CPU kernel, fed the convs' channels-last output in
            # the net, returned gradients up to 1e-2 off a float64 version
            # once the BatchNorm scales and offsets are away from 1 and 0;
            # on a contiguous copy they agree to float32 rounding.
            x = x.contiguous()
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.float().square().reciprocal() - self.eps  # biased
            self.running_mean.lerp_(mean.float(), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return out

    def _global_forward(self, x):
        group, dp = self.reduce
        xf = x.float()
        count = dp * (x.numel() // x.shape[1])
        sums = distributed.all_reduce_autograd(
            torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))]), group)
        mean, mean2 = (sums / count).view(2, -1)
        var = (mean2 - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
               + self.bias[None, :, None, None])
        return out.to(x.dtype)


def data_parallel(net: nn.Module, group, dp: int) -> None:
    """Make ``net``'s BatchNorm layers normalise training batches with the
    statistics of the global batch, summed over ``group`` of ``dp`` ranks
    (dp=1: the local batch, as before)."""
    for module in net.modules():
        if isinstance(module, BatchNorm):
            module.reduce = (group, dp) if dp > 1 else None


class ConvBlock(nn.Module):
    """conv -> BN -> optional relu."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.bn = BatchNorm(cout)

    def forward(self, x, activate: bool = True):
        x = self.bn(self.conv(x))
        return torch.relu(x) if activate else x


class SqueezeExcite(nn.Module):
    """Leela Chess Zero's squeeze-excitation (lczero-training's
    ``squeeze_excitation``; Hu et al., arXiv 1709.01507, with a learned
    offset): the mean of y (NCHW) over the board, ``dense1`` to
    filters / ratio units and relu, ``dense2`` to 2 x filters, whose first
    half g scales y through a sigmoid and second half o is added:
    sigmoid(g) * y + o, per channel."""

    def __init__(self, filters: int, ratio: int):
        super().__init__()
        self.dense1 = nn.Linear(filters, filters // ratio)
        self.dense2 = nn.Linear(filters // ratio, 2 * filters)

    def forward(self, y):
        z = torch.relu(self.dense1(y.mean(dim=(2, 3))))
        g, o = self.dense2(z).chunk(2, dim=1)
        return torch.sigmoid(g)[:, :, None, None] * y + o[:, :, None, None]


class ResidualBlock(nn.Module):
    """Two 3x3 convs + the block input, add, relu; with ``projection`` the
    input goes through a 1x1 conv->BN first (``proj``, else None); with
    ``se_ratio`` > 0 the second conv's output goes through a
    squeeze-excitation gate first (``se``, else None)."""

    def __init__(self, filters: int, projection: bool = True,
                 se_ratio: int = 0):
        super().__init__()
        self.conv1 = ConvBlock(filters, filters)
        self.conv2 = ConvBlock(filters, filters)
        self.proj = (ConvBlock(filters, filters, kernel=1) if projection
                     else None)
        self.se = SqueezeExcite(filters, se_ratio) if se_ratio else None

    def forward(self, x):
        y = self.conv2(self.conv1(x), activate=False)
        if self.se is not None:
            y = self.se(y)
        skip = x if self.proj is None else self.proj(x, activate=False)
        return torch.relu(skip + y)


class NormConv(nn.Module):
    """A pre-activation conv: conv(relu(BN(x))), the BatchNorm over the
    input's channels and a bias on the conv (KataGo's NormActConv, with the
    port's BatchNorm and conv bias)."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.bn = BatchNorm(cin)
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)

    def activate(self, x):
        return torch.relu(self.bn(x))

    def forward(self, x):
        return self.conv(self.activate(x))


def global_pool(g: torch.Tensor) -> torch.Tensor:
    """KataGo's KataGPool over a full board of NCHW ``g``: per channel the
    mean, the mean scaled by (sqrt(cells) - 14) / 10, and the max, (B, 3C)."""
    cells = g.shape[2] * g.shape[3]
    mean = g.mean(dim=(2, 3))
    return torch.cat([mean, mean * ((math.sqrt(cells) - 14.0) / 10.0),
                      g.amax(dim=(2, 3))], dim=1)


class GlobalPoolBias(nn.Module):
    """A pooled inner block's pooled branch (KataGo's ResBlock with
    ``c_gpool``): g = relu(BN(conv(u))) of the block's activated input u
    (``conv``, ``bn``: conv, then BatchNorm), pooled by ``global_pool`` and
    mapped by ``dense`` (no bias) to a bias a channel of the regular
    branch."""

    def __init__(self, cin: int, pooled: int, regular: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, pooled, 3, padding=1)
        self.bn = BatchNorm(pooled)
        self.dense = nn.Linear(3 * pooled, regular, bias=False)

    def forward(self, u):
        g = torch.relu(self.bn(self.conv(u)))
        return self.dense(global_pool(g))[:, :, None, None]


class InnerBlock(nn.Module):
    """a + conv2(relu(BN(conv1(relu(BN(a)))))) at ``mid`` channels; with
    ``pooled`` > 0, conv1 gives mid - pooled channels, to which the pooled
    branch (``gpool``, else None) of the same activated input adds its
    channel bias before conv2's norm."""

    def __init__(self, mid: int, pooled: int = 0):
        super().__init__()
        regular = mid - pooled
        self.conv1 = NormConv(mid, regular, 3)
        self.gpool = (GlobalPoolBias(mid, pooled, regular) if pooled
                      else None)
        self.conv2 = NormConv(regular, mid, 3)

    def forward(self, a):
        u = self.conv1.activate(a)
        r = self.conv1.conv(u)
        if self.gpool is not None:
            r = r + self.gpool(u)
        return a + self.conv2(r)


class NestedBottleneckBlock(nn.Module):
    """KataGo's ``bottlenest2`` block, pre-activation throughout: x +
    post(inner2(inner1(pre(x)))), ``pre`` a 1x1 NormConv from ``filters``
    to ``mid``, two ``InnerBlock``s, ``post`` a 1x1 NormConv back; with
    ``pooled`` > 0 the first inner block pools (``bottlenest2gpool``). The
    skip stream x is never normalised or rectified."""

    def __init__(self, filters: int, mid: int, pooled: int = 0):
        super().__init__()
        self.pre = NormConv(filters, mid, 1)
        self.inner = nn.ModuleList([InnerBlock(mid, pooled),
                                    InnerBlock(mid)])
        self.post = NormConv(mid, filters, 1)

    def forward(self, x):
        y = self.pre(x)
        for inner in self.inner:
            y = inner(y)
        return x + self.post(y)


class PolicyValueNet(nn.Module):
    """NHWC observations -> (policy logits (B, A) float32, value (B,))."""

    def __init__(self, num_actions: int, cfg: ModelConfig = ModelConfig(),
                 in_channels: int = 4, board_hw: tuple = (6, 7)):
        super().__init__()
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        h, w = board_hw
        self.stem = ConvBlock(in_channels, cfg.filters)
        if cfg.mid_filters:
            self.blocks = nn.ModuleList(
                [NestedBottleneckBlock(
                    cfg.filters, cfg.mid_filters,
                    cfg.gpool_filters if i + 1 in cfg.gpool_blocks else 0)
                 for i in range(cfg.depth)])
            self.trunk_norm = BatchNorm(cfg.filters)
        else:
            self.blocks = nn.ModuleList(
                [ResidualBlock(cfg.filters, cfg.residual_projection,
                               cfg.se_ratio)
                 for _ in range(cfg.depth)]
            )
            self.trunk_norm = None
        self.policy_conv = ConvBlock(cfg.filters, cfg.policy_filters, 1)
        self.policy_dense = nn.Linear(cfg.policy_filters * h * w, num_actions)
        self.value_conv = ConvBlock(cfg.filters, cfg.value_filters, 1)
        self.value_dense1 = nn.Linear(cfg.value_filters * h * w,
                                      cfg.value_hidden)
        self.value_dense2 = nn.Linear(cfg.value_hidden, 1)

    def forward(self, obs_nhwc: torch.Tensor):
        with torch.autocast(
            obs_nhwc.device.type, dtype=torch.bfloat16,
            enabled=self.cfg.compute_dtype == "bfloat16",
        ):
            x = self.stem(obs_nhwc.permute(0, 3, 1, 2))  # NHWC -> NCHW
            for block in self.blocks:
                x = block(x)
            if self.trunk_norm is not None:
                x = torch.relu(self.trunk_norm(x))
            p = self.policy_conv(x).permute(0, 2, 3, 1).flatten(1)
            v = self.value_conv(x).permute(0, 2, 3, 1).flatten(1)
            v = torch.relu(self.value_dense1(v))
        logits = self.policy_dense(p.float())
        value = torch.tanh(self.value_dense2(v.float()))[:, 0]
        return logits, value


def masked_policy(logits: torch.Tensor, legal_mask: torch.Tensor):
    """Softmax over legal actions only; uniform if no action is legal."""
    neg_inf = torch.finfo(logits.dtype).min
    masked = torch.where(legal_mask, logits, neg_inf)
    return torch.where(
        legal_mask.any(dim=-1, keepdim=True),
        torch.softmax(masked, dim=-1),
        torch.full_like(logits, 1.0 / logits.shape[-1]),
    )
