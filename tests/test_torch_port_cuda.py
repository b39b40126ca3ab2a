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


def _small_samples(device, rows=600):
    """A batch of well-formed samples on ``device`` from a numpy seed."""
    import numpy as np

    from custom_alphazero_tpu_torch.runtime.selfplay import SelfPlayBatch

    rng = np.random.default_rng(0)
    cells = rng.integers(0, 3, size=(rows, 6, 7))
    obs = np.stack([cells == c for c in range(3)]
                   + [np.broadcast_to(rng.integers(0, 2, (rows, 1, 1)),
                                      (rows, 6, 7))], -1).astype(np.float32)
    pi = rng.random((rows, 7)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    return SelfPlayBatch(
        *(torch.from_numpy(x).to(device) for x in (
            obs, pi, rng.choice([-1.0, 0.0, 1.0], rows).astype(np.float32),
            rng.random(rows) < 0.8)))


@pytest.mark.cuda
def test_replay_ring_on_card_equals_cpu_ring():
    """The packed ring on the card after wrapping adds, and a sample from
    it, equal the CPU ring's given the same batches and indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from custom_alphazero_tpu_torch.replay.buffer import (
        replay_add,
        replay_gather,
        replay_init,
        replay_sample_indices,
    )
    from custom_alphazero_tpu_torch.replay.codec import codec_for_env

    env = ConnectN(ConnectNConfig())
    codec = codec_for_env(env)
    capacity = 1000
    rings = {d: replay_init(capacity, env.obs_shape, 7, codec, device=d)
             for d in ("cuda", "cpu")}
    samples = _small_samples("cuda")
    for i in range(4):
        for d in rings:
            batch = type(samples)(*(t.to(d) for t in samples))
            rings[d] = replay_add(
                rings[d], batch._replace(value=batch.value * (-1) ** i),
                codec)
    assert int(rings["cuda"].size) == capacity
    for x, y in zip((*rings["cuda"].rows().obs, *rings["cuda"].rows()[1:]),
                    (*rings["cpu"].rows().obs, *rings["cpu"].rows()[1:])):
        assert torch.equal(x.cpu(), y)
    gen = torch.Generator(device="cuda").manual_seed(1)
    idx = replay_sample_indices(rings["cuda"], gen, 256)
    assert len(set(idx.tolist())) == 256 and int(idx.max()) < capacity
    for x, y in zip(replay_gather(rings["cuda"], idx, codec),
                    replay_gather(rings["cpu"], idx.cpu(), codec)):
        assert torch.equal(x.cpu(), y)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One float32 train step (clip and aux terms on) from the same state
    and batch on the card and on the CPU, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from custom_alphazero_tpu_torch.config import ModelConfig
    from custom_alphazero_tpu_torch.runtime.train import (
        init_train_state,
        make_train_step,
        new_train_state,
    )

    cfg = ModelConfig(depth=2, filters=32, value_hidden=64,
                      compute_dtype="float32", grad_clip_norm=1.0)
    cpu = init_train_state(7, cfg, torch.Generator().manual_seed(0),
                           (6, 7, 4), device="cpu")
    gpu = new_train_state(copy.deepcopy(cpu.net).cuda())
    step = make_train_step(cfg, aux_value_weight=0.25, aux_value_batch=64,
                           aux_policy_weight=0.5)
    samples = _small_samples("cpu", 256)
    aux = _small_samples("cpu", 100)
    aux_pi = torch.eye(7)[aux.policy.argmax(-1)]
    idx = torch.arange(64) % 100
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        metrics = {}
        for state, d in ((cpu, "cpu"), (gpu, "cuda")):
            for _ in range(3):
                _, metrics[d] = step(
                    state, samples.obs.to(d), samples.policy.to(d),
                    samples.value.to(d), None, aux.obs.to(d),
                    aux.value.to(d), aux_pi.to(d), idx.to(d))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for term in ("loss", "policy_loss", "value_loss", "l2",
                 "solver_value_loss", "solver_policy_loss"):
        assert abs(float(getattr(metrics["cuda"], term))
                   - float(getattr(metrics["cpu"], term))) < 1e-4, term
    for x, y in zip(gpu.net.state_dict().values(),
                    cpu.net.state_dict().values()):
        assert (x.cpu() - y).abs().max() < 1e-4
    assert gpu.steps == cpu.steps == 3


@pytest.mark.cuda
def test_arena_captures_two_graphs_per_pair():
    """A searched arena on the card captures one graph per ply parity, and
    none again on the next arena of the same pair, also after the
    candidate's weights were changed in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from custom_alphazero_tpu_torch.config import ArenaConfig, ModelConfig
    from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import (
        FusedConnectNSearchV2,
    )
    from custom_alphazero_tpu_torch.runtime.arena import make_arena_fn
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
    from custom_alphazero_tpu_torch.runtime.train import init_train_state

    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    gen = torch.Generator(device=device).manual_seed(0)
    cfg = ModelConfig(depth=1, filters=16, value_hidden=32)
    nets = [init_train_state(7, cfg, gen, env.obs_shape).net
            for _ in range(2)]
    candidate, incumbent = (make_evaluate_fn(net) for net in nets)
    arena = make_arena_fn(env, ArenaConfig(evaluate_with_mcts=True),
                          MCTSConfig(simulations=16, use_dirichlet=True,
                                     dirichlet_alpha=1.0), 12)
    before = FusedConnectNSearchV2.captures
    first = arena(candidate, incumbent, gen, 32)
    assert FusedConnectNSearchV2.captures - before == 2
    with torch.no_grad():
        for p in nets[0].parameters():
            p.mul_(0.5)
    second = arena(candidate, incumbent, gen, 32)
    assert FusedConnectNSearchV2.captures - before == 2
    for result in (first, second):
        assert int(result.wins + result.losses + result.draws) == 32
        assert bool((result.log.movers[0, :16] == 0).all())


@pytest.mark.cuda
def test_oracle_and_tree_render_on_card():
    """The solver oracle takes card observations and answers on the card,
    as on the CPU; a search tree on the card renders to the same DOT text
    as the same search on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from custom_alphazero_tpu_torch import solver
    from custom_alphazero_tpu_torch.search.mcts import MCTS
    from custom_alphazero_tpu_torch.tools.visualize import tree_to_dot

    device = torch.device("cuda")
    env = ConnectN(ConnectNConfig())
    state = env.init(1, device)
    for col in (3, 0, 3, 0, 3, 1):  # the side to move wins in column 3
        state, _ = env.step(state, torch.tensor([col], device=device))
    oracle = solver.make_solver_evaluate_fn(7)
    probs, values = oracle(env.observe(state))
    assert probs.device == values.device == state.board.device
    assert probs.cpu().tolist() == [[0, 0, 0, 1, 0, 0, 0]]
    assert values.cpu().tolist() == [1.0]

    gen = torch.Generator(device=device).manual_seed(4)
    states = chip_smoke.random_positions(env, 3, 20, gen, device)
    cpu_states = type(states)(*(t.cpu() for t in vars(states).values()))
    mcts = MCTS(env, MCTSConfig(simulations=32))
    evaluate = chip_smoke.dyadic_evaluate(7)
    tree = mcts.search(states, evaluate, None, 32)
    cpu_tree = mcts.search(cpu_states, evaluate, None, 32)
    for game in range(3):
        assert tree_to_dot(tree, env, game) == tree_to_dot(cpu_tree, env,
                                                           game)
