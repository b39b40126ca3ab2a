"""Decoding of the replay ring's bit-packed observations, from the format's
definition: the binary channels' bits in (channel, row, column) order, bit
i of 32-bit word j holding bit 32 j + i; the constant channels stored as
one float each; channels then restored to their original order."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def decode(words: np.ndarray, scalars: np.ndarray, shape: Sequence[int],
           binary: Sequence[int], constant: Sequence[int] = ()) -> np.ndarray:
    """(R, n_words) words (any 32-bit integer type) and (R, n_const) floats
    -> (R, H, W, C) float32 observations."""
    h, w, c = shape
    words = np.ascontiguousarray(words).view(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(len(words), -1)[:, :h * w * len(binary)]
    out = np.zeros((len(words), h, w, c), np.float32)
    planes = bits.reshape(len(words), len(binary), h, w)
    for i, channel in enumerate(binary):
        out[..., channel] = planes[:, i]
    for i, channel in enumerate(constant):
        out[..., channel] = scalars[:, i, None, None]
    return out
