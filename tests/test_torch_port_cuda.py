"""The CUDA wave kernels against their plain PyTorch versions, and the
three searches against each other, on the card.

Marked ``cuda``: they skip where there is no CUDA card (the kernels have no
CPU mode). On a card, without JAX (tests/conftest.py imports it):
``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

import chip_smoke
from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [dict(width=7, height=6, n=4),
                                      dict(width=5, height=4, n=3)],
                         ids=["7x6n4", "5x4n3"])
def test_wave_kernel_bit_equal_to_plain_version(geometry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    env = ConnectN(ConnectNConfig(**geometry))
    cfg = MCTSConfig(simulations=48, use_dirichlet=True, dirichlet_alpha=1.0)
    states = chip_smoke.random_positions(env, 96, 20, gen, device)
    max_err, *_ = chip_smoke.kernel_vs_plain(env, cfg, states, 48, gen,
                                             timed=False)
    assert max_err == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [dict(width=7, height=6, n=4),
                                      dict(width=5, height=4, n=3)],
                         ids=["7x6n4", "5x4n3"])
def test_k2_wave_kernel_bit_equal_to_plain_version(geometry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(2)
    env = ConnectN(ConnectNConfig(**geometry))
    cfg = MCTSConfig(simulations=48, use_dirichlet=True, dirichlet_alpha=1.0)
    states = chip_smoke.random_positions(env, 96, 20, gen, device)
    max_err, *_ = chip_smoke.kernel_vs_plain(env, cfg, states, 48, gen,
                                             timed=False, kernel="K2")
    assert max_err == 0.0


@pytest.mark.cuda
def test_general_search_matches_fused_searches_on_card():
    """MCTS.search, K1 and K2 searches on the card from one generator seed
    each: bit-equal root visits and value sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from custom_alphazero_tpu_torch.ops.fused_mcts import FusedConnectNSearch
    from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
        FusedConnectNSearchV2,
    )
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=40, use_dirichlet=True, dirichlet_alpha=1.0)
    states = chip_smoke.random_positions(
        env, 64, 20, torch.Generator(device=device).manual_seed(3), device)
    evaluate = chip_smoke.dyadic_evaluate(7)
    mcts = MCTS(env, cfg)
    tree = mcts.search(states, evaluate,
                       torch.Generator(device=device).manual_seed(4), 40)
    want = (mcts.root_child_visits(tree), mcts.root_child_value_sums(tree))
    for impl in (FusedConnectNSearchV2, FusedConnectNSearch):
        got = impl(env, cfg).search_root_stats(
            states, evaluate, torch.Generator(device=device).manual_seed(4),
            40)
        assert chip_smoke.same_bits(got[0], want[0])
        assert chip_smoke.same_bits(got[1], want[1])
    assert int(want[0].sum()) > 0
