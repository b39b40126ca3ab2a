"""The (data, model) mesh of ranks (the port of parallel/mesh.py).

Rank r sits at ``(r // mp, r % mp)`` of a ``(dp, mp)`` grid: the layout of
JAX's ``np.asarray(devices[:dp*mp]).reshape(dp, mp)``. Games and batches
are split over ``data``; the ranks of one data row hold the same rows and
compute the same thing, but for the dense kernels that ``shard_params``
splits over ``model``.

A Flax Dense kernel (in, out) whose ``out`` divides by ``mp`` is
column-sharded in JAX; torch's ``nn.Linear.weight`` is that kernel
transposed, so here a rank holds a block of *rows* of the weight (and of
the bias), in ``ColumnParallelLinear``. Its forward gathers the full output
over the model group before the next layer; the backward reduces the input
gradient over it. On Connect-4 only the value head's hidden layer
(``value_hidden`` columns) divides: the policy layer (7 columns) and the
final Dense(1) stay whole, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from custom_alphazero_tpu_torch.config import MeshConfig
from custom_alphazero_tpu_torch.parallel import distributed


class Mesh:
    """The grid of ranks and this rank's place and groups in it.

    ``group`` spans the mesh's ranks (None: the whole world),
    ``data_group`` the ranks of this rank's model column (the ranks that
    hold the other rows of its data), ``model_group`` those of its data row
    (the ranks that hold the other shards of its kernels); each ``*_host``
    twin carries host tensors. Groups exist only with a process group."""

    def __init__(self, dp: int, mp: int, rank: int = 0, world: int = 1):
        self.dp, self.mp = dp, mp
        self.grid = np.arange(dp * mp).reshape(dp, mp)
        self.rank = rank
        self.member = rank < dp * mp
        self.data_index, self.model_index = divmod(rank, mp)
        self.group = self.group_host = None
        self.data_group = self.data_group_host = None
        self.model_group = None
        if not distributed.is_initialized():
            return
        # Every rank creates every group, in the same order.
        if dp * mp < world:
            self.group, self.group_host = distributed.new_group(
                list(range(dp * mp)))
        for m in range(mp):
            if mp == 1:
                groups = self.group, self.group_host
            else:
                groups = distributed.new_group(self.grid[:, m].tolist())
            if self.member and m == self.model_index:
                self.data_group, self.data_group_host = groups
        if mp > 1:
            for d in range(dp):
                group, _ = distributed.new_group(self.grid[d].tolist())
                if self.member and d == self.data_index:
                    self.model_group = group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp


def make_mesh(cfg: MeshConfig = MeshConfig(),
              world: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the ``world`` ranks (default: the process
    group's size, 1 without one)."""
    world = distributed.world_size() if world is None else world
    mp = max(cfg.model_parallelism, 1)
    dp = cfg.data_parallelism or max(world // mp, 1)
    if dp * mp > world:
        raise ValueError(
            f"Mesh {dp}x{mp} needs {dp * mp} devices, have {world}"
        )
    return Mesh(dp, mp, distributed.rank(), world)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.dp:
        raise ValueError(
            f"batch {global_batch} not divisible by data axis {mesh.dp}")
    return global_batch // mesh.dp


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of a tensor (or of each tensor of a tuple): the
    ``data_index``-th of ``dp`` equal blocks of the leading axis."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(t, mesh) for t in tree)
    n = local_batch_size(tree.shape[0], mesh)
    return tree[mesh.data_index * n:(mesh.data_index + 1) * n]


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over the model group (every shard
    of the layer adds its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce(grad.contiguous().clone(),
                                      ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """The shards' outputs concatenated along the features; the gradient is
    this shard's columns of the output's."""

    @staticmethod
    def forward(ctx, y, group, index, parts):
        ctx.index, ctx.k = index, y.shape[-1]
        return distributed.all_gather_sum(y, index, parts, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.k, ctx.k), None, None, None


class ColumnParallelLinear(nn.Linear):
    """Rows ``[index * k, (index + 1) * k)`` of a Linear's weight and bias
    (columns of the Flax kernel), ``k = out_features / parts``; the forward
    returns the full output, gathered over ``group``."""

    def __init__(self, full: nn.Linear, index: int, parts: int, group):
        k = full.out_features // parts
        super().__init__(full.in_features, k, device=full.weight.device,
                         dtype=full.weight.dtype)
        self.index, self.parts, self.group = index, parts, group
        self.full_features = full.out_features
        with torch.no_grad():
            self.weight.copy_(full.weight[index * k:(index + 1) * k])
            self.bias.copy_(full.bias[index * k:(index + 1) * k])

    def forward(self, x):
        y = super().forward(_CopyToModel.apply(x, self.group))
        return _GatherFromModel.apply(y, self.group, self.index, self.parts)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full-size weight or bias."""
        k = self.out_features
        return full[self.index * k:(self.index + 1) * k]

    def gather(self, piece: torch.Tensor) -> torch.Tensor:
        """The full-size tensor of which ``piece`` is this rank's rows."""
        return distributed.all_gather_sum(piece, self.index, self.parts,
                                          self.group, dim=0)


def shard_owners(net: nn.Module) -> Dict[int, ColumnParallelLinear]:
    """id(parameter) -> its ColumnParallelLinear, for the sharded ones."""
    return {id(p): m for m in net.modules()
            if isinstance(m, ColumnParallelLinear)
            for p in (m.weight, m.bias)}


def shard_params(net: nn.Module, mesh: Mesh,
                 trace: Optional[List[torch.Tensor]] = None) -> nn.Module:
    """Column-shard, in place, every Linear whose output width divides by
    ``mesh.mp`` (the Flax kernels JAX's ``shard_params`` shards: 2-D
    kernels whose last dimension divides; convolutions stay whole), with
    the matching rows of ``trace`` (one tensor per ``net.parameters()``
    entry). Everything else stays replicated. Identity at mp=1."""
    if mesh.mp == 1:
        return net
    for module in list(net.modules()):
        for name, child in list(module.named_children()):
            if (type(child) is nn.Linear
                    and child.out_features % mesh.mp == 0):
                setattr(module, name, ColumnParallelLinear(
                    child, mesh.model_index, mesh.mp, mesh.model_group))
    if trace is not None:
        # The swap keeps every parameter's place in net.parameters().
        owners = shard_owners(net)
        for i, p in enumerate(net.parameters()):
            if id(p) in owners:
                trace[i] = owners[id(p)].shard(trace[i]).clone()
    return net


def full_tensors(net: nn.Module, tensors: List[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """Full-size copies of ``tensors`` (one per ``net.parameters()`` entry:
    the parameters themselves or their momentum): the shards gathered over
    the model group, the rest as they are. Every rank of the group calls
    it."""
    owners = shard_owners(net)
    return [owners[id(p)].gather(t) if id(p) in owners else t
            for p, t in zip(net.parameters(), tensors)]


def load_full(net: nn.Module, tensors: List[torch.Tensor],
              targets: List[torch.Tensor]) -> None:
    """Copy full-size ``tensors`` (one per ``net.parameters()`` entry) into
    ``targets`` (the parameters or their momentum), each shard taking its
    rows."""
    owners = shard_owners(net)
    with torch.no_grad():
        for p, full, target in zip(net.parameters(), tensors, targets):
            target.copy_(owners[id(p)].shard(full) if id(p) in owners
                         else full)


def sharded_square_sum(net: nn.Module, tensors) -> Optional[torch.Tensor]:
    """Sum of squares of the sharded entries of ``tensors`` (one per
    ``net.parameters()`` entry) on this rank, or None without shards."""
    owners = shard_owners(net)
    parts = [t.float().square().sum() for p, t in zip(net.parameters(),
                                                      tensors)
             if id(p) in owners]
    return sum(parts) if parts else None
