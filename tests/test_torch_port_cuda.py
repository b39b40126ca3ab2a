"""The CUDA wave kernels against their plain PyTorch versions, the searches
against each other, and the search's CUDA graph, on the card.

Marked ``cuda``: they skip where there is no CUDA card (the kernels have no
CPU mode). On a card, without JAX (tests/conftest.py imports it):
``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

import chip_smoke
from custom_alphazero_tpu_torch.config import ConnectNConfig, MCTSConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import WARMUP_WAVES


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


def _fused(kernel):
    from custom_alphazero_tpu_torch.ops import fused_mcts, fused_mcts_v2

    if kernel == "K2":
        return fused_mcts, fused_mcts.FusedConnectNSearch
    return fused_mcts_v2, fused_mcts_v2.FusedConnectNSearchV2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_graph_replay_equals_host_launches_and_plain_version(kernel):
    """One search three ways from one noise seed: every wave a replay of
    the captured graph, every wave launched from the host, and every step
    through the plain version. Bit-equal root visits and value sums; the
    graph search twice on one object (the second replays the cached
    graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    module, impl = _fused(kernel)
    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    sims = 40
    cfg = MCTSConfig(simulations=sims, use_dirichlet=True,
                     dirichlet_alpha=1.0)
    states = chip_smoke.random_positions(
        env, 64, 20, torch.Generator(device=device).manual_seed(3), device)
    evaluate = chip_smoke.dyadic_evaluate(7)

    def noise():
        return torch.Generator(device=device).manual_seed(4)

    search = impl(env, cfg)
    module.wave_step.launches = 0
    first = search.search_root_stats(states, evaluate, noise(), sims)
    assert module.wave_step.launches == sims + 1 + WARMUP_WAVES
    module.wave_step.launches = 0
    again = search.search_root_stats(states, evaluate, noise(), sims)
    assert module.wave_step.launches == sims + 1
    assert len(search.static(64, sims).graphs) == 1
    host = impl(env, cfg).search_root_stats(states, evaluate, noise(), sims,
                                            graph=False)

    plain = impl(env, cfg)
    static = plain.static(64, sims)
    plain.reset(static, states)
    gen = noise()
    for w in range(sims):
        static.buffers.gamma[w] = plain._mcts.wave_noise(gen, 64, device)
    module.wave_step_reference.calls = 0
    for w in range(sims + 1):
        module.wave_step_reference(static.buffers, static.carry,
                                   plain.geometry(sims))
        if w < sims:
            plain._evaluate(static, evaluate)
    assert module.wave_step_reference.calls == sims + 1
    want = plain._root_stats(static.carry)

    for got in (first, again, host):
        assert chip_smoke.same_bits(got[0], want[0])
        assert chip_smoke.same_bits(got[1], want[1])
    assert int(want[0].sum()) > 0


@pytest.mark.cuda
def test_search_object_reused_across_plies_under_graph():
    """Three plies of self-play, the search object and its graph reused
    every ply: the samples equal those of host-launched waves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from custom_alphazero_tpu_torch.config import SelfPlayConfig
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn

    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=24, use_dirichlet=True, dirichlet_alpha=1.0)
    sp = SelfPlayConfig(continuous=True, exclude_draws=False)
    evaluate = chip_smoke.dyadic_evaluate(7)
    runs = []
    for graph in (None, False):
        generate = make_selfplay_fn(env, cfg, sp, 3, graph=graph)
        fused_mcts_v2.wave_step.launches = 0
        runs.append(generate(
            evaluate, torch.Generator(device=device).manual_seed(6), 32))
        warmup = WARMUP_WAVES if graph is None else 0
        assert fused_mcts_v2.wave_step.launches == 3 * 25 + warmup
    (graph_batch, graph_stats), (host_batch, host_stats) = runs
    for x, y in zip(graph_batch, host_batch):
        assert chip_smoke.same_bits(x, y)
    for x, y in zip(graph_stats, host_stats):
        assert chip_smoke.same_bits(x, y)


@pytest.mark.cuda
def test_capture_of_host_bound_evaluator_raises():
    """An evaluator that computes on the host cannot be captured: the
    default path raises and does not give way to host launches, which
    graph=False asks for explicitly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, impl = _fused("K1")
    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    cfg = MCTSConfig(simulations=8)
    states = env.init(16)
    dyadic = chip_smoke.dyadic_evaluate(7)

    def on_host(obs):
        probs, value = dyadic(obs.cpu())
        return probs.to(device), value.to(device)

    search = impl(env, cfg)
    with pytest.raises(RuntimeError):
        search.search_root_stats(states, on_host, None, 8)
    torch.cuda.synchronize()
    visits, _ = impl(env, cfg).search_root_stats(states, on_host, None, 8,
                                                 graph=False)
    want, _ = impl(env, cfg).search_root_stats(states, dyadic, None, 8)
    assert chip_smoke.same_bits(visits, want)
