"""Device-resident FIFO replay ring (the port of replay/buffer.py).

Semantics of the JAX ring:

- bounded FIFO of ``capacity`` rows, oldest evicted first;
- ``replay_add`` lands a batch's valid rows at consecutive slots in order;
  a batch with more valid rows than ``capacity`` writes only its newest
  ``capacity``; an already-packed batch is accepted;
- uniform sampling without replacement over the filled region.

XLA drops a scatter to an out-of-bounds slot; torch does not. So the ring's
arrays carry one spare row behind the ``capacity`` real ones, and every
dropped row of a batch is written there. ``head`` and ``size`` are device
tensors and ``replay_add`` never waits for the device. Unlike the JAX
function, ``replay_add`` writes into the ring's memory in place; the state it
returns shares it.

Sampling is split into drawing the indices (``replay_sample_indices``, from
the caller's ``torch.Generator``: the random stream is torch's, not JAX's)
and gathering and decoding them (``replay_gather``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import resolve_device
from custom_alphazero_tpu_torch.replay.codec import (
    BitplaneCodec,
    PackedObs,
    TopKPolicy,
    TopKPolicyCodec,
)


class ReplayState(NamedTuple):
    """The ring. Array fields have ``capacity + 1`` rows: the last is the
    spare row that takes dropped writes and is never read."""

    obs: Any             # (C+1, H, W, ch) float32, or PackedObs with a codec
    policy: Any          # (C+1, A) float32, or TopKPolicy with a policy codec
    value: torch.Tensor  # (C+1,) float32
    head: torch.Tensor   # () int32: next write slot
    size: torch.Tensor   # () int32: filled rows, <= C

    @property
    def capacity(self) -> int:
        return self.value.shape[0] - 1

    def rows(self) -> "ReplayState":
        """The ring without its spare row (views): the arrays of the JAX
        ring, and what a checkpoint stores."""
        cap = self.capacity
        return ReplayState(_map(lambda t: t[:cap], self.obs),
                           _map(lambda t: t[:cap], self.policy),
                           self.value[:cap], self.head, self.size)


def _map(fn, tree, *rest):
    """``fn`` over a tensor or over the fields of a NamedTuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return type(tree)(*(fn(*leaves) for leaves in zip(tree, *rest)))


def replay_init(capacity: int, obs_shape, num_actions: int,
                codec: Optional[BitplaneCodec] = None,
                policy_codec: Optional[TopKPolicyCodec] = None,
                device=None) -> ReplayState:
    device = resolve_device(device)
    rows = capacity + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayState(
        obs=(codec.packed_zeros((rows,), device) if codec is not None
             else zeros(rows, *obs_shape)),
        policy=(policy_codec.packed_zeros((rows,), device)
                if policy_codec is not None else zeros(rows, num_actions)),
        value=zeros(rows),
        head=zeros(dtype=torch.int32),
        size=zeros(dtype=torch.int32),
    )


def replay_add(state: ReplayState, batch,
               codec: Optional[BitplaneCodec] = None,
               policy_codec: Optional[TopKPolicyCodec] = None) -> ReplayState:
    """Masked FIFO append of a ``SelfPlayBatch``, in place."""
    capacity = state.capacity
    mask = batch.valid
    total = mask.sum()
    offsets = torch.cumsum(mask, 0) - 1
    # More valid rows than the ring holds: keep the newest `capacity`.
    mask = mask & (offsets >= total - capacity)
    # Re-rank the survivors from 0 so their slots stay consecutive.
    offsets = torch.cumsum(mask, 0) - 1
    slots = torch.where(mask, (state.head + offsets) % capacity, capacity)
    count = mask.sum()
    if codec is not None and not isinstance(batch.obs, PackedObs):
        obs_rows = codec.encode(batch.obs)
    else:
        obs_rows = batch.obs
    policy_rows = (policy_codec.encode(batch.policy)
                   if policy_codec is not None else batch.policy)

    def write(store, rows):
        return store.index_copy_(0, slots, rows.to(store.dtype))

    return ReplayState(
        obs=_map(write, state.obs, obs_rows),
        policy=_map(write, state.policy, policy_rows),
        value=write(state.value, batch.value),
        head=((state.head + count) % capacity).to(torch.int32),
        size=(state.size + count).clamp_max(capacity).to(torch.int32),
    )


def replay_sample_indices(state: ReplayState, generator: torch.Generator,
                          batch_size: int) -> torch.Tensor:
    """``batch_size`` distinct row indices, uniform over the filled region
    (the top of one uniform score per row). Needs size >= batch_size, which
    the loop's warm-up gate enforces."""
    capacity = state.capacity
    device = state.value.device
    scores = torch.rand(capacity, generator=generator, device=device)
    filled = torch.arange(capacity, device=device) < state.size
    scores = torch.where(filled, scores, -torch.inf)
    return torch.topk(scores, batch_size).indices


def replay_gather(state: ReplayState, indices: torch.Tensor,
                  codec: Optional[BitplaneCodec] = None,
                  policy_codec: Optional[TopKPolicyCodec] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(obs, policy, value) of the rows ``indices``, decoded."""
    obs = _map(lambda t: t[indices], state.obs)
    if codec is not None:
        obs = codec.decode(obs)
    policy = _map(lambda t: t[indices], state.policy)
    if policy_codec is not None:
        policy = policy_codec.decode(policy)
    return obs, policy, state.value[indices]


def replay_sample(state: ReplayState, generator: torch.Generator,
                  batch_size: int, codec: Optional[BitplaneCodec] = None,
                  policy_codec: Optional[TopKPolicyCodec] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A uniform sample of ``batch_size`` rows without replacement."""
    indices = replay_sample_indices(state, generator, batch_size)
    return replay_gather(state, indices, codec, policy_codec)


def replay_state_dict(state: ReplayState) -> dict:
    """A host copy of the ring as a state dict in the JAX ring's layout (no
    spare row; packed words as uint32), for a checkpoint."""
    def host(t):
        return t.detach().to("cpu", copy=True).numpy()

    rows = state.rows()
    obs, policy = rows.obs, rows.policy
    return {
        "obs": ({"words": host(obs.words).view(np.uint32),
                 "scalars": host(obs.scalars)}
                if isinstance(obs, PackedObs) else host(obs)),
        "policy": ({"values": host(policy.values),
                    "indices": host(policy.indices)}
                   if isinstance(policy, TopKPolicy) else host(policy)),
        "value": host(rows.value),
        "head": host(rows.head),
        "size": host(rows.size),
    }


def replay_from_state_dict(tree: dict, device=None,
                           shard: Tuple[int, int] = (0, 1)) -> ReplayState:
    """A ring on ``device`` from a checkpoint's state dict. ``shard=(d,
    dp)``: data shard d's ring of a ring written by ``dp`` shards (JAX's
    global layout: cursors of shape (dp,), each shard's rows contiguous in
    shard order). A ring written at another ``dp`` raises ``ValueError``:
    rows cannot move between shards' cursors."""
    device = resolve_device(device)
    index, parts = shard
    head, size = np.asarray(tree["head"]), np.asarray(tree["size"])
    saved = 1 if head.ndim == 0 else head.shape[0]
    if saved != parts or head.ndim > 1:
        raise ValueError(
            f"the checkpoint's replay ring was written by {saved} data "
            f"shard(s) (cursors of shape {head.shape}); this run has "
            f"data parallelism {parts}: resume at the data parallelism "
            "that wrote it, or without its ring (loop.checkpoint_replay)"
        )
    rows = np.asarray(tree["value"]).shape[0] // parts

    def store(array):
        array = np.asarray(array)[index * rows:(index + 1) * rows]
        if array.dtype == np.uint32:
            array = array.view(np.int32)
        t = torch.from_numpy(array.copy()).to(device)
        spare = torch.zeros((1,) + t.shape[1:], dtype=t.dtype, device=device)
        return torch.cat([t, spare])

    def scalar(x):
        return torch.tensor(int(x.reshape(-1)[index]), dtype=torch.int32,
                            device=device)

    obs, policy = tree["obs"], tree["policy"]
    return ReplayState(
        obs=(PackedObs(store(obs["words"]), store(obs["scalars"]))
             if isinstance(obs, dict) else store(obs)),
        policy=(TopKPolicy(store(policy["values"]), store(policy["indices"]))
                if isinstance(policy, dict) else store(policy)),
        value=store(tree["value"]),
        head=scalar(head),
        size=scalar(size),
    )
