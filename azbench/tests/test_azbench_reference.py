"""The plain reference against the port on the CPU at a tiny size: the
rules, the net (eval and train mode), the SGD step, the search with root
noise and the ring's decoding. The tests import both; the reference does
not import the program."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from azbench.reference import codec as ref_codec
from azbench.reference import connect4
from azbench.reference import msgpack_reader
from azbench.reference import net as ref_net
from azbench.reference import search as ref_search
from azbench.tests import fixture

torch.set_num_threads(1)


@pytest.fixture
def tiny(tmp_path_factory):
    """A fresh copy per test: the port trains its net in place."""
    from custom_alphazero_tpu_torch.config import from_json
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint
    from custom_alphazero_tpu_torch.models.convert import train_state_from_jax

    path = str(tmp_path_factory.mktemp("w") / "weights")
    cfg = fixture.tiny_config()
    fixture.write_weights(path, cfg, seed=5)
    config = from_json(json.dumps(cfg))
    tree, _ = load_checkpoint(path)
    state = train_state_from_jax(tree, 7, config.model, 4, (6, 7),
                                 device="cpu")
    raw = msgpack_reader.read_checkpoint(path)
    params = ref_net.to_device(ref_net.flatten(raw["params"]), "cpu")
    stats = ref_net.to_device(ref_net.flatten(raw["batch_stats"]), "cpu")
    sgd = raw["opt_state"]["0"] if "trace" in raw["opt_state"]["0"] else (
        raw["opt_state"]["1"]["0"])
    trace = ref_net.to_device(ref_net.flatten(sgd["trace"]), "cpu")
    return config, state, params, stats, trace


def random_obs(count, seed):
    rng = np.random.default_rng(seed)
    boards = connect4.random_positions(rng, count, 6, 7, 4, 30)
    return boards, connect4.observe(boards)


def test_rules_match_the_port_over_random_games():
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN

    env = ConnectN(ConnectNConfig())
    states = env.init(64, "cpu")
    boards = np.zeros((64, 6, 7), np.int8)
    over = np.zeros(64, bool)
    rng = np.random.default_rng(0)
    for _ in range(42):
        legal = env.legal_mask(states).numpy()
        assert (legal == (connect4.legal(boards) & ~over[:, None])).all()
        actions = np.array([rng.choice(np.nonzero(row)[0]) if row.any() else 0
                            for row in legal])
        states, reward = env.step(states, torch.from_numpy(actions))
        for b in range(64):
            if over[b]:
                continue
            boards[b], won, drawn = connect4.play(boards[b], actions[b], 4)
            assert bool(states.terminal[b]) == (won or drawn)
            assert float(reward[b]) == float(won)
            over[b] = won or drawn
        assert (states.board.numpy() == boards).all()
        assert (env.observe(states).numpy() == connect4.observe(boards)).all()


def test_net_eval_and_train_forward_match_the_port(tiny):
    config, state, params, stats, _ = tiny
    _, obs = random_obs(32, 1)
    x = torch.from_numpy(obs)
    with torch.no_grad():
        logits, value = state.net.eval()(x)
        ref_logits, ref_value, _ = ref_net.forward(params, stats, x, 1)
    assert torch.allclose(logits, ref_logits, atol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5)
    net = state.net
    with torch.no_grad():
        logits, value = net.train()(x)
        net.eval()
        ref_logits, ref_value, moved = ref_net.forward(params, stats, x, 1,
                                                       train=True)
    assert torch.allclose(logits, ref_logits, atol=1e-4)
    assert torch.allclose(value, ref_value, atol=1e-5)
    assert torch.allclose(net.stem.bn.running_mean,
                          moved["ConvBlock_0/BatchNorm_0/mean"], atol=1e-6)
    assert torch.allclose(net.stem.bn.running_var,
                          moved["ConvBlock_0/BatchNorm_0/var"], atol=1e-6)


def test_sgd_step_matches_the_ports_train_step(tiny):
    from custom_alphazero_tpu_torch.models.convert import train_state_to_jax
    from custom_alphazero_tpu_torch.runtime.train import make_train_step

    config, state, params, stats, trace = tiny
    _, obs = random_obs(64, 2)
    rng = np.random.default_rng(3)
    pi = rng.dirichlet(np.ones(7), 64).astype(np.float32)
    z = rng.choice([-1.0, 0.0, 1.0], 64).astype(np.float32)
    _, aux = random_obs(16, 4)
    aux_z = rng.choice([-1.0, 1.0], 16).astype(np.float32)
    m = config.model
    step = make_train_step(m, aux_value_weight=0.25, aux_value_batch=16)
    x, p, v = (torch.from_numpy(a) for a in (obs, pi, z))
    a_obs, a_z = torch.from_numpy(aux), torch.from_numpy(aux_z)
    _, metrics = step(state, x, p, v, None, a_obs, a_z, None,
                      torch.arange(16))
    lr = ref_net.learning_rate(m.lr_values, m.lr_boundaries, 11600)
    new_params, _, new_trace, losses, _ = ref_net.sgd_step(
        params, stats, trace, x, p, v, a_obs, a_z, 1, m.l2, 0.25, lr,
        m.momentum)
    assert abs(float(metrics.loss) - losses["loss"]) < 1e-5
    tree = train_state_to_jax(state, m)
    got = ref_net.flatten(tree["params"])
    sgd = tree["opt_state"]["0"]
    got_trace = ref_net.flatten(sgd["trace"])
    for k in new_params:
        assert np.allclose(got[k], new_params[k].numpy(), atol=1e-6), k
        assert np.allclose(got_trace[k], new_trace[k].numpy(), atol=1e-5), k


def test_search_matches_the_ports_fused_search(tiny):
    from custom_alphazero_tpu_torch.config import MCTSConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.ops import fused_mcts_v2
    from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn

    config, state, params, stats, _ = tiny
    env = ConnectN(config.connect_n)
    mcts = MCTSConfig(simulations=24, use_dirichlet=True,
                      dirichlet_alpha=1.0)
    search = fused_mcts_v2.FusedConnectNSearchV2(env, mcts, "cpu")
    boards, _ = random_obs(12, 6)
    states = env.init(12, "cpu")
    states.board = torch.from_numpy(boards)
    states.heights = torch.from_numpy((boards != 0).sum(1).astype(np.int32))
    states.fullmove = torch.from_numpy(
        (boards != 0).sum((1, 2)).astype(np.int32))
    gen = torch.Generator().manual_seed(7)
    gamma = -torch.log(torch.rand((24, 12, 7), generator=gen))
    visits, _ = search.search_root_stats(
        states, make_evaluate_fn(state.net.eval()), None, 24, gamma=gamma)

    def evaluate(obs):
        probs, values = ref_net.evaluate(params, stats, torch.from_numpy(obs),
                                         1)
        return probs.numpy(), values.numpy()

    ref = ref_search.search(boards, evaluate, 24, mcts.c_puct, 4,
                            gamma.numpy(), mcts.dirichlet_fraction)
    assert (visits.numpy() == ref).all()
    assert (ref.sum(-1) == 23).all()


def test_codec_decodes_the_ports_encoding():
    from custom_alphazero_tpu_torch.config import ConnectNConfig
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.replay.codec import codec_for_env

    codec = codec_for_env(ConnectN(ConnectNConfig()))
    _, obs = random_obs(40, 8)
    packed = codec.encode(torch.from_numpy(obs))
    out = ref_codec.decode(packed.words.numpy(), packed.scalars.numpy(),
                           (6, 7, 4), codec.binary_channels,
                           codec.scalar_channels)
    assert (out == obs).all()
