"""The CUDA wave kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips where there is no CUDA card (the kernel has no
CPU mode). On a card: ``python -m pytest tests/test_torch_port_cuda.py``.
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
