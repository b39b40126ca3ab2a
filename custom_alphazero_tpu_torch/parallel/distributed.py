"""Multi-process start-up and the port's collectives (the port of
parallel/distributed.py).

One process per rank, each started the same way:

    torchrun --nproc_per_node=N -m custom_alphazero_tpu_torch.runtime.loop ...

``initialize`` joins the process group (a no-op for one process) and pins
the rank to its card; ``runtime.loop.run`` then builds the (data, model)
mesh over the ranks (parallel/mesh.py). Host-local work (checkpoints,
metrics, solver scoring, printed lines) is gated on ``is_coordinator()``.

Backend: NCCL when every rank on the host has a card of its own; Gloo
otherwise (two ranks on one card: NCCL refuses a card twice), with the
tensors still on the card, and Gloo on the CPU when the caller asks for the
CPU. ``initialize`` prints its choice on one line.

Every collective the port makes goes through a wrapper here, and each
wrapper that moves data adds one to ``COUNTS[kind]`` (``all_reduce``,
``gather``, ``all_gather``): ``tools/multihost_proxy.py`` reads the
counts. Gloo carries ``all_reduce`` and ``broadcast`` of card tensors but
no gather: a gather of card rows is either an all-reduce of a zero-padded
buffer (``all_gather_sum``, small tensors in the forward) or staged
through host memory to the group's first rank (``gather_host``,
checkpoints and arena logs, which only the coordinator writes), over a
Gloo group.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

# Collectives issued by this process, by kind (reset by the caller).
COUNTS: dict = {}
# The device of this rank's collectives and the Gloo twin of the world
# group when the backend is NCCL: process-wide, like the process group.
_STATE: dict = {"device": None, "host_group": None}

INIT_METHOD_ENV = "CAZ_DIST_INIT_METHOD"
TIMEOUT_ENV = "CAZ_DIST_TIMEOUT_S"


def initialize(device=None, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); ``init_method`` (or ``$CAZ_DIST_INIT_METHOD``, e.g. a
    ``file://`` store) takes the place of the address. One process without
    an ``init_method`` joins nothing. ``device=None`` is the card: the rank
    takes card ``LOCAL_RANK % device_count`` before anything is allocated
    there."""
    env = os.environ
    init_method = init_method or env.get(INIT_METHOD_ENV)
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    device = torch.device("cuda" if device is None else device)
    if world_size == 1 and init_method is None:
        return device  # one process: nothing to join, nothing to pin
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
    else:
        backend = "gloo"
    _STATE["device"] = device
    if dist.is_initialized():
        return device
    if init_method is None:
        init_method = "env://"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=float(env.get(TIMEOUT_ENV, 1800))))
    if backend == "nccl":
        _STATE["host_group"] = dist.new_group(backend="gloo")
    devices = all_gather_object(str(device))
    if rank == 0:
        print(f"distributed: world={world_size} backend={backend} "
              f"devices=[{', '.join(devices)}]", flush=True)
    return device


def is_initialized() -> bool:
    return dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def new_group(ranks: List[int]):
    """(device group, host group) over ``ranks``: the second carries host
    tensors (Gloo), and is the first under Gloo. Every rank calls this for
    every group, in the same order."""
    group = dist.new_group(ranks)
    if backend() == "gloo":
        return group, group
    return group, dist.new_group(ranks, backend="gloo")


def _host_group(group=None):
    """The Gloo group over the world where ``group`` is None."""
    if group is None and _STATE["host_group"] is not None:
        return _STATE["host_group"]
    return group


def _count(kind: str) -> None:
    COUNTS[kind] = COUNTS.get(kind, 0) + 1


def reset_counts() -> None:
    COUNTS.clear()


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place (nothing without a process
    group) and return it."""
    if dist.is_initialized():
        _count("all_reduce")
        dist.all_reduce(tensor, group=group)
    return tensor


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient is summed over it too (each rank's
    loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce(tensor.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """A differentiable sum over ``group``."""
    return _AllReduce.apply(tensor, group) if dist.is_initialized() else tensor


def all_gather_sum(tensor: torch.Tensor, index: int, parts: int, group,
                   dim: int = 0) -> torch.Tensor:
    """The ``parts`` equal pieces of the group's ranks concatenated along
    ``dim``, piece ``index`` being ``tensor``: an all-reduce of a
    zero-padded float32 buffer (exact: every other term is zero), so it
    runs on card tensors under Gloo too."""
    dim = dim % tensor.dim()
    k = tensor.shape[dim]
    shape = list(tensor.shape)
    shape[dim] = k * parts
    full = torch.zeros(shape, dtype=torch.float32, device=tensor.device)
    full.narrow(dim, index * k, k).copy_(tensor)
    return all_reduce(full, group).to(tensor.dtype)


def gather_host(tensor: torch.Tensor, group=None
                ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``tensor`` (equal shapes), in the group's rank order,
    as host tensors on the group's first rank (None on the others): staged
    through host memory over a Gloo group. ``group`` must carry host
    tensors (the second of ``new_group``); every rank of it calls this."""
    local = tensor.detach().to("cpu").contiguous()
    if not dist.is_initialized():
        return [local]
    flag = local.dtype == torch.bool
    if flag:
        local = local.view(torch.uint8)
    group = _host_group(group)
    first = 0 if group is None else dist.get_global_rank(group, 0)
    out = None
    if dist.get_rank() == first:
        out = [torch.empty_like(local)
               for _ in range(dist.get_world_size(group))]
    _count("gather")
    dist.gather(local, out, dst=first, group=group)
    if out is None:
        return None
    return [t.view(torch.bool) for t in out] if flag else out


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order (host only)."""
    if not dist.is_initialized():
        return [obj]
    group = _host_group(group)
    out = [None] * dist.get_world_size(group)
    _count("all_gather")
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, group=None):
    """The coordinator's picklable ``obj`` on every rank of ``group`` (a
    host group; None: the world)."""
    return all_gather_object(obj, group)[0]


def _device() -> torch.device:
    return _STATE["device"] or torch.device("cpu")


def broadcast_flag(value: bool, group=None) -> bool:
    """The coordinator's boolean, agreed on every rank: an all-reduce in
    which only the coordinator's term can be nonzero. For decisions that
    must not split the ranks (the STOP file, the solver veto): a rank that
    decided alone could leave the others waiting in a collective."""
    if not dist.is_initialized():
        return bool(value)
    flag = torch.tensor([1.0 if value and is_coordinator() else 0.0],
                        device=_device())
    return bool(all_reduce(flag, group).item() > 0)


def sync_hosts(name: str = "barrier", group=None) -> None:
    """A barrier through a summed one per rank (checked)."""
    if not dist.is_initialized():
        return
    ones = all_reduce(torch.ones(1, device=_device()), group)
    expected = dist.get_world_size(group)
    if int(ones.item()) != expected:
        raise RuntimeError(f"sync_hosts({name!r}): {int(ones.item())} of "
                           f"{expected} ranks")


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, host_group=None)
