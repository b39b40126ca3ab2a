"""The FLOP and byte counts against hand counts at small shapes."""

from __future__ import annotations

import numpy as np

from azbench import flops


def test_net_flops_by_hand():
    # 2x2 board, 1 input channel, 2 actions, 1 block of 2 filters, heads
    # of 1 filter each, value hidden 3.
    cells = 4
    stem = cells * 9 * 1 * 2
    block = cells * (9 * 2 * 2 + 9 * 2 * 2 + 2 * 2)
    heads = cells * 2 * 1 + cells * 2 * 1
    dense = cells * 1 * 2 + cells * 1 * 3 + 3
    assert flops.net_forward_flops(2, 2, 1, 2, 2, 1, 1, 1, 3) == 2 * (
        stem + block + heads + dense)


def test_c4_r5_forward_flops():
    # 7x6, 4 planes, 7 actions, 4 blocks of 128, heads 2 / 1, hidden 256.
    macs = 42 * (9 * 4 * 128 + 4 * (2 * 9 * 128 * 128 + 128 * 128)
                 + 128 * 3) + 84 * 7 + 42 * 256 + 256
    assert flops.net_forward_flops(6, 7, 4, 7, 128, 4, 2, 1, 256) == 2 * macs
    assert abs(2 * macs / 1e6 - 105.04) < 0.01


def test_k1_bytes_by_hand():
    a, cells = 7, 42
    # One game, previous leaf at depth 2, new leaf at depth 3.
    per_game = ((4 * a + 1 + 64 + 3 + 3 + 2) + (a + 1 + 2 + 8)
                + 4 * (4 * a + 2) + (4 + 6 + 3) + (2 * a + 64 + 4 * cells))
    assert flops.k1_step_bytes(np.array([2]), np.array([3]), a, cells) == (
        4 * per_game)
    # Bytes add over games.
    two = flops.k1_step_bytes(np.array([2, 2]), np.array([3, 3]), a, cells)
    assert two == 8 * per_game


def test_peaks_table():
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    assert peak["bf16_flops"] == 989e12 and peak["hbm_bytes_per_s"] == 3.35e12
