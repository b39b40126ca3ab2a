"""Bit-packed observation storage and sparse policy rows for the replay ring
(the port of replay/codec.py).

``BitplaneCodec`` packs an observation's binary channels into 32-bit words
and keeps each channel that is constant over the board as one float32
scalar. The packed words hold the same bytes as the JAX codec's uint32
words: the bits are laid out plane-major (channel, row, column), and bit
``i`` of word ``j`` is bit ``32 j + i`` of that sequence. torch has next to
no uint32 arithmetic, so the words are int32 here: a set bit 31 makes a
word negative, which changes no byte of it; ``decode`` masks with ``& 1``
after its (arithmetic) right shift.

``TopKPolicyCodec`` stores the K largest entries of a policy row,
renormalised, with their indices; ties go to the lowest index, as
``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

WORD = 32


class PackedObs(NamedTuple):
    """Packed observations (leading batch axes broadcast)."""

    words: torch.Tensor    # (..., n_words) int32: packed binary channels
    scalars: torch.Tensor  # (..., n_scalars) float32: constant channels


class BitplaneCodec:
    """Packs (H, W, C) float observations whose channels are each either
    binary (values in {0, 1}) or constant over the spatial grid.

    binary_channels / scalar_channels partition range(C). A scalar
    channel's value is read at spatial position (0, 0)."""

    def __init__(self, obs_shape: Tuple[int, int, int],
                 binary_channels: Sequence[int],
                 scalar_channels: Sequence[int] = ()):
        h, w, c = obs_shape
        binary = tuple(binary_channels)
        scalars = tuple(scalar_channels)
        if sorted(binary + scalars) != list(range(c)):
            raise ValueError("channels must partition the observation")
        self.obs_shape = tuple(obs_shape)
        self.binary_channels = binary
        self.scalar_channels = scalars
        # Static permutation restoring [binary..., scalar...] -> 0..C-1.
        order = binary + scalars
        self.inv_perm = tuple(order.index(i) for i in range(c))
        self.n_bits = h * w * len(binary)
        self.n_words = -(-self.n_bits // WORD)
        self.n_scalars = len(scalars)

    def packed_zeros(self, leading: Tuple[int, ...], device) -> PackedObs:
        """The packed storage of ``leading`` rows."""
        return PackedObs(
            words=torch.zeros(leading + (self.n_words,), dtype=torch.int32,
                              device=device),
            scalars=torch.zeros(leading + (self.n_scalars,),
                                dtype=torch.float32, device=device),
        )

    def encode(self, obs: torch.Tensor) -> PackedObs:
        """(..., H, W, C) float32 -> PackedObs, batched over leading axes."""
        lead = tuple(obs.shape[:-3])
        dev = obs.device
        # (..., C_bin, H, W): channel-major, so each plane's bits stay
        # contiguous within words.
        planes = obs[..., list(self.binary_channels)].movedim(-1, -3)
        bits = (planes > 0.5).reshape(lead + (-1,))
        pad = self.n_words * WORD - self.n_bits
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        grouped = bits.reshape(lead + (self.n_words, WORD)).to(torch.int64)
        weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
            WORD, dtype=torch.int64, device=dev)
        # Sums below 2**32; the cast to int32 wraps and keeps the low 32 bits.
        words = (grouped * weights).sum(-1).to(torch.int32)
        if self.n_scalars:
            scalars = obs[..., 0, 0, list(self.scalar_channels)].float()
        else:
            scalars = torch.zeros(lead + (0,), dtype=torch.float32, device=dev)
        return PackedObs(words=words, scalars=scalars)

    def decode(self, packed: PackedObs) -> torch.Tensor:
        """PackedObs -> (..., H, W, C) float32: the exact inverse of encode
        for binary planes; scalar channels become constant planes again."""
        h, w, _ = self.obs_shape
        lead = tuple(packed.words.shape[:-1])
        shifts = torch.arange(WORD, dtype=torch.int32,
                              device=packed.words.device)
        bits = (packed.words[..., None] >> shifts) & 1
        bits = bits.reshape(lead + (-1,))[..., : self.n_bits]
        planes = bits.reshape(
            lead + (len(self.binary_channels), h, w)).float()
        planes = planes.movedim(-3, -1)  # (..., H, W, C_bin)
        if self.n_scalars:
            const = packed.scalars[..., None, None, :].expand(
                lead + (h, w, self.n_scalars))
            planes = torch.cat([planes, const], dim=-1)
        return planes[..., list(self.inv_perm)]


def codec_for_env(env) -> BitplaneCodec:
    """The codec an env declares through ``obs_scalar_channels`` (channels
    constant over the board; everything else must be binary). An env
    without the attribute is all-binary."""
    c = env.obs_shape[-1]
    scalar = tuple(getattr(env, "obs_scalar_channels", ()))
    binary = tuple(i for i in range(c) if i not in scalar)
    return BitplaneCodec(env.obs_shape, binary, scalar)


class TopKPolicy(NamedTuple):
    """Sparse policy row: top-K (renormalised) probabilities + indices."""

    values: torch.Tensor   # (..., K) float32
    indices: torch.Tensor  # (..., K) int32


class TopKPolicyCodec:
    """Sparse storage for policy targets of a large action space. A search
    policy has at most min(simulations, legal moves) non-zeros, so top-K
    with K at least that is exact; a smaller K drops the tail and
    renormalises."""

    def __init__(self, num_actions: int, k: int):
        if not 0 < k <= num_actions:
            raise ValueError(f"k={k} outside 1..{num_actions}")
        self.num_actions = num_actions
        self.k = k

    def packed_zeros(self, leading: Tuple[int, ...], device) -> TopKPolicy:
        return TopKPolicy(
            values=torch.zeros(leading + (self.k,), dtype=torch.float32,
                               device=device),
            indices=torch.zeros(leading + (self.k,), dtype=torch.int32,
                                device=device),
        )

    def encode(self, policy: torch.Tensor) -> TopKPolicy:
        # A stable descending sort keeps ties in index order.
        values, indices = torch.sort(policy, dim=-1, descending=True,
                                     stable=True)
        values, indices = values[..., : self.k], indices[..., : self.k]
        total = values.sum(-1, keepdim=True).clamp_min(1e-30)
        return TopKPolicy(values=(values / total).float(),
                          indices=indices.to(torch.int32))

    def decode(self, packed: TopKPolicy) -> torch.Tensor:
        lead = tuple(packed.values.shape[:-1])
        dense = torch.zeros((packed.values[..., 0].numel(), self.num_actions),
                            dtype=torch.float32, device=packed.values.device)
        # Add, not set: zero-valued padding may repeat an index harmlessly.
        dense.scatter_add_(1, packed.indices.reshape(-1, self.k).long(),
                           packed.values.reshape(-1, self.k))
        return dense.reshape(lead + (self.num_actions,))
