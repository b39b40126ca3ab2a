"""Flax variables -> the port's PolicyValueNet.

Takes the Flax ``params`` / ``batch_stats`` trees as nested dicts of numpy
arrays (what ``jax.device_get`` of a train state gives, or what
io/checkpoint.py reads from disk without JAX) and fills the net:

- Flax Conv kernel (kh, kw, cin, cout) -> torch (cout, cin, kh, kw).
- Flax Dense kernel (in, out) -> torch Linear weight (out, in).
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var -> running
  mean/var.
- Flax module names: the stem is ConvBlock_0, the policy head conv
  ConvBlock_1, the value head conv ConvBlock_2; Dense_0 is the policy
  dense, Dense_1 / Dense_2 the value MLP.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import ModelConfig, resolve_device
from custom_alphazero_tpu_torch.models.policy_value import (
    ConvBlock,
    PolicyValueNet,
)


def _tensor(x) -> torch.Tensor:
    # Copy: arrays from JAX are read-only views torch must not wrap.
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _load_conv_block(block: ConvBlock, params: Mapping[str, Any],
                     stats: Mapping[str, Any]) -> None:
    conv, bn_p, bn_s = (params["Conv_0"], params["BatchNorm_0"],
                        stats["BatchNorm_0"])
    with torch.no_grad():
        block.conv.weight.copy_(_tensor(conv["kernel"]).permute(3, 2, 0, 1))
        block.conv.bias.copy_(_tensor(conv["bias"]))
        block.bn.weight.copy_(_tensor(bn_p["scale"]))
        block.bn.bias.copy_(_tensor(bn_p["bias"]))
        block.bn.running_mean.copy_(_tensor(bn_s["mean"]))
        block.bn.running_var.copy_(_tensor(bn_s["var"]))


def _load_dense(linear: torch.nn.Linear, params: Mapping[str, Any]) -> None:
    with torch.no_grad():
        linear.weight.copy_(_tensor(params["kernel"]).T)
        linear.bias.copy_(_tensor(params["bias"]))


def from_jax_variables(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any],
                       num_actions: int,
                       cfg: ModelConfig = ModelConfig(),
                       in_channels: int = 4,
                       board_hw: tuple = (6, 7),
                       device=None) -> PolicyValueNet:
    """Build an eval-mode PolicyValueNet on ``device`` from Flax variables."""
    device = resolve_device(device)
    net = PolicyValueNet(num_actions, cfg, in_channels, board_hw)
    p, s = params, batch_stats
    _load_conv_block(net.stem, p["ConvBlock_0"], s["ConvBlock_0"])
    for i, block in enumerate(net.blocks):
        bp, bs = p[f"ResidualBlock_{i}"], s[f"ResidualBlock_{i}"]
        _load_conv_block(block.conv1, bp["ConvBlock_0"], bs["ConvBlock_0"])
        _load_conv_block(block.conv2, bp["ConvBlock_1"], bs["ConvBlock_1"])
        _load_conv_block(block.proj, bp["ConvBlock_2"], bs["ConvBlock_2"])
    _load_conv_block(net.policy_conv, p["ConvBlock_1"], s["ConvBlock_1"])
    _load_conv_block(net.value_conv, p["ConvBlock_2"], s["ConvBlock_2"])
    _load_dense(net.policy_dense, p["Dense_0"])
    _load_dense(net.value_dense1, p["Dense_1"])
    _load_dense(net.value_dense2, p["Dense_2"])
    return net.to(device).eval()
