"""Flax variables and train state <-> the port's PolicyValueNet and TrainState.

The Flax side is nested dicts of numpy arrays (what ``jax.device_get`` of a
train state gives after ``flax.serialization.to_state_dict``, or what
io/checkpoint.py reads from disk without JAX):

- Flax Conv kernel (kh, kw, cin, cout) <-> torch (cout, cin, kh, kw).
- Flax Dense kernel (in, out) <-> torch Linear weight (out, in).
- BatchNorm scale/bias <-> weight/bias, batch_stats mean/var <-> running
  mean/var.
- Flax module names: the stem is ConvBlock_0, the policy head conv
  ConvBlock_1, the value head conv ConvBlock_2; Dense_0 is the policy
  dense, Dense_1 / Dense_2 the value MLP. ResidualBlock_i holds conv1,
  conv2 and the projection as ConvBlock_0, _1 and _2; a net without the
  projection (``residual_projection=False``, the port's own) has no
  ConvBlock_2 in its blocks, nor in its statistics and momentum. A block
  with a squeeze-excitation gate (``se_ratio > 0``, the port's own) holds
  its two dense layers as SqueezeExcite_0/Dense_0 and Dense_1, in the
  params and the momentum (they have no statistics).
- A net of nested bottleneck blocks (``mid_filters > 0``, the port's own)
  holds NestedBottleneckBlock_i in their place: NormConv_0 (the 1x1 conv
  down), InnerBlock_0 and InnerBlock_1, NormConv_1 (the 1x1 conv up);
  each InnerBlock_j holds NormConv_0 and NormConv_1, and a pooled one
  GlobalPoolBias_0 (Conv_0, BatchNorm_0, Dense_0 with a kernel alone)
  beside them. A NormConv's BatchNorm_0 normalises its input, ahead of its
  Conv_0. The trunk's final norm is BatchNorm_0 at the top level.
- The optimizer state of ``optax.sgd(schedule, momentum)`` is the tuple
  ``(TraceState(trace), ScaleByScheduleState(count))``, serialised as
  ``{"0": {"trace": <params-shaped tree>}, "1": {"count": int32}}``; with
  ``grad_clip_norm > 0`` the chain wraps it as ``{"0": {}, "1": <that>}``.
  The trace is the port's momentum, in the layouts above.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import ModelConfig, resolve_device
from custom_alphazero_tpu_torch.models.policy_value import (
    ConvBlock,
    GlobalPoolBias,
    PolicyValueNet,
)
from custom_alphazero_tpu_torch.runtime.train import TrainState

# How a torch tensor maps to its Flax array: the permutation that takes the
# Flax layout to torch's (and its inverse back).
_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0), "vec": (0,)}
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0), "vec": (0,)}


def _tensor(x) -> torch.Tensor:
    # Copy: arrays from JAX are read-only views torch must not wrap.
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv_block(block: ConvBlock, path: Tuple[str, ...]):
    yield path + ("Conv_0", "kernel"), block.conv.weight, "conv"
    yield path + ("Conv_0", "bias"), block.conv.bias, "vec"
    yield path + ("BatchNorm_0", "scale"), block.bn.weight, "vec"
    yield path + ("BatchNorm_0", "bias"), block.bn.bias, "vec"


def _nested_blocks(net: PolicyValueNet):
    """(module with ``conv`` and ``bn``, Flax path) of every nested
    bottleneck block's conv, in forward order."""
    for i, block in enumerate(net.blocks):
        path = (f"NestedBottleneckBlock_{i}",)
        yield block.pre, path + ("NormConv_0",)
        for j, inner in enumerate(block.inner):
            inner_path = path + (f"InnerBlock_{j}",)
            yield inner.conv1, inner_path + ("NormConv_0",)
            if inner.gpool is not None:
                yield inner.gpool, inner_path + ("GlobalPoolBias_0",)
            yield inner.conv2, inner_path + ("NormConv_1",)
        yield block.post, path + ("NormConv_1",)


def _conv_blocks(net: PolicyValueNet) -> Iterator[Tuple[ConvBlock, tuple]]:
    yield net.stem, ("ConvBlock_0",)
    if net.trunk_norm is not None:
        yield from _nested_blocks(net)
    for i, block in enumerate(net.blocks if net.trunk_norm is None
                              else ()):
        yield block.conv1, (f"ResidualBlock_{i}", "ConvBlock_0")
        yield block.conv2, (f"ResidualBlock_{i}", "ConvBlock_1")
        if block.proj is not None:
            yield block.proj, (f"ResidualBlock_{i}", "ConvBlock_2")
    yield net.policy_conv, ("ConvBlock_1",)
    yield net.value_conv, ("ConvBlock_2",)


def _dense(linear: torch.nn.Linear, path: Tuple[str, ...]):
    yield path + ("kernel",), linear.weight, "dense"
    yield path + ("bias",), linear.bias, "vec"


def _param_layout(net: PolicyValueNet):
    """(Flax path, torch parameter, kind) of every parameter."""
    for block, path in _conv_blocks(net):
        yield from _conv_block(block, path)
        if isinstance(block, GlobalPoolBias):
            yield path + ("Dense_0", "kernel"), block.dense.weight, "dense"
    if net.trunk_norm is not None:
        yield ("BatchNorm_0", "scale"), net.trunk_norm.weight, "vec"
        yield ("BatchNorm_0", "bias"), net.trunk_norm.bias, "vec"
    for i, block in enumerate(net.blocks):
        if getattr(block, "se", None) is not None:
            gate = (f"ResidualBlock_{i}", "SqueezeExcite_0")
            yield from _dense(block.se.dense1, gate + ("Dense_0",))
            yield from _dense(block.se.dense2, gate + ("Dense_1",))
    for name, linear in (("Dense_0", net.policy_dense),
                         ("Dense_1", net.value_dense1),
                         ("Dense_2", net.value_dense2)):
        yield from _dense(linear, (name,))


def _stats_layout(net: PolicyValueNet):
    """(Flax path, torch buffer, kind) of every running statistic."""
    for block, path in _conv_blocks(net):
        yield path + ("BatchNorm_0", "mean"), block.bn.running_mean, "vec"
        yield path + ("BatchNorm_0", "var"), block.bn.running_var, "vec"
    if net.trunk_norm is not None:
        yield ("BatchNorm_0", "mean"), net.trunk_norm.running_mean, "vec"
        yield ("BatchNorm_0", "var"), net.trunk_norm.running_var, "vec"


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _to_flax(tensor: torch.Tensor, kind: str) -> np.ndarray:
    """A host copy in Flax's layout (a copy on the CPU too: a checkpoint
    may be written while training goes on)."""
    return tensor.detach().float().permute(_TO_FLAX[kind]).contiguous().to(
        "cpu", copy=True).numpy()


def load_jax_variables(net: PolicyValueNet, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> None:
    """Fill ``net``'s parameters and running statistics, in place. Raises
    ValueError where a residual block of ``params`` has a projection
    (ConvBlock_2) or a squeeze-excitation gate (SqueezeExcite_0) and
    ``net``'s has none, or the reverse, and where ``params`` has nested
    bottleneck blocks or pooled inner blocks that ``net`` lacks, or the
    reverse."""
    nested = net.trunk_norm is not None
    if nested != any(key.startswith("NestedBottleneckBlock_")
                     for key in params):
        raise ValueError(
            f"the variables {'lack' if nested else 'have'} nested bottleneck "
            f"blocks (NestedBottleneckBlock_i) and the net "
            f"{'has' if nested else 'lacks'} them (mid_filters="
            f"{net.cfg.mid_filters})")
    for i, block in enumerate(net.blocks if nested else ()):
        saved = params[f"NestedBottleneckBlock_{i}"].get("InnerBlock_0", {})
        have = block.inner[0].gpool is not None
        if ("GlobalPoolBias_0" in saved) != have:
            raise ValueError(
                f"NestedBottleneckBlock_{i}: the variables "
                f"{'lack' if have else 'have'} a pooled inner block "
                f"(GlobalPoolBias_0) and the net's block "
                f"{'has' if have else 'lacks'} one (gpool_blocks="
                f"{net.cfg.gpool_blocks})")
    for i, block in enumerate(net.blocks if not nested else ()):
        saved = params.get(f"ResidualBlock_{i}", {})
        for key, what, have, option in (
                ("ConvBlock_2", "a projection", block.proj is not None,
                 f"residual_projection={block.proj is not None}"),
                ("SqueezeExcite_0", "a squeeze-excitation gate",
                 block.se is not None, "se_ratio="
                 f"{0 if block.se is None else net.cfg.se_ratio}")):
            if (key in saved) != have:
                raise ValueError(
                    f"ResidualBlock_{i}: the variables "
                    f"{'lack' if have else 'have'} {what} ({key}) and the "
                    f"net's block {'has' if have else 'lacks'} one ({option})")
    with torch.no_grad():
        for layout, tree in ((_param_layout(net), params),
                             (_stats_layout(net), batch_stats)):
            for path, tensor, kind in layout:
                tensor.copy_(_tensor(_get(tree, path)).permute(_TO_TORCH[kind]))


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
    load_jax_variables(net, params, batch_stats)
    return net.to(device).eval()


def to_jax_variables(net: PolicyValueNet) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``net`` as nested dicts of numpy arrays in
    Flax's names and layouts: the inverse of ``from_jax_variables``."""
    params: dict = {}
    batch_stats: dict = {}
    for layout, tree in ((_param_layout(net), params),
                         (_stats_layout(net), batch_stats)):
        for path, tensor, kind in layout:
            _put(tree, path, _to_flax(tensor, kind))
    return params, batch_stats


def _sgd_state(opt_state: Mapping[str, Any]) -> Mapping[str, Any]:
    """The ``(TraceState, ScaleByScheduleState)`` pair of an optimizer
    state, with or without the clip's wrapper."""
    return opt_state if "trace" in opt_state["0"] else opt_state["1"]


def trace_from_jax(opt_state: Mapping[str, Any],
                   net: PolicyValueNet) -> List[torch.Tensor]:
    """The momentum buffers of a Flax optimizer state, one per entry of
    ``net.parameters()`` and on its device."""
    trace = _sgd_state(opt_state)["0"]["trace"]
    by_param = {
        id(tensor): _tensor(_get(trace, path)).permute(
            _TO_TORCH[kind]).contiguous().to(tensor.device)
        for path, tensor, kind in _param_layout(net)
    }
    return [by_param[id(p)] for p in net.parameters()]


def opt_state_to_jax(net: PolicyValueNet, trace: List[torch.Tensor],
                     steps: int, grad_clip: bool) -> dict:
    """The Flax optimizer state of ``make_optimizer`` holding ``trace`` at
    count ``steps``; ``grad_clip`` adds the clip's (empty) wrapper."""
    by_param = {id(p): t for p, t in zip(net.parameters(), trace)}
    tree: dict = {}
    for path, tensor, kind in _param_layout(net):
        _put(tree, path, _to_flax(by_param[id(tensor)], kind))
    sgd = {"0": {"trace": tree}, "1": {"count": np.array(steps, np.int32)}}
    return {"0": {}, "1": sgd} if grad_clip else sgd


def train_state_to_jax(state: TrainState, cfg: ModelConfig) -> dict:
    """A port TrainState as the state dict of the JAX package's TrainState
    (params, batch_stats, opt_state, steps)."""
    params, batch_stats = to_jax_variables(state.net)
    return {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": opt_state_to_jax(state.net, state.trace, state.steps,
                                      cfg.grad_clip_norm > 0),
        "steps": np.array(state.steps, np.int32),
    }


def train_state_from_jax(tree: Mapping[str, Any], num_actions: int,
                         cfg: ModelConfig = ModelConfig(),
                         in_channels: int = 4, board_hw: tuple = (6, 7),
                         device=None) -> TrainState:
    """A port TrainState (net, momentum, steps) on ``device`` from the state
    dict of a JAX TrainState."""
    net = from_jax_variables(tree["params"], tree["batch_stats"], num_actions,
                             cfg, in_channels, board_hw, device)
    return TrainState(net=net, trace=trace_from_jax(tree["opt_state"], net),
                      steps=int(tree["steps"]))
