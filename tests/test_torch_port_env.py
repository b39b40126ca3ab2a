"""The port's batched Connect-N env against the JAX env, ply for ply.

Random legal trajectories (numpy seed) drive both envs; every state field
and reward must be equal after every ply, including absorbed steps of
finished games and the non-gravity action map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_alphazero_tpu.config import ConnectNConfig as JaxConnectNConfig
from custom_alphazero_tpu.envs.connect_n import ConnectN as JaxConnectN
from custom_alphazero_tpu_torch.config import ConnectNConfig
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN, has_line

GEOMETRIES = [
    dict(width=7, height=6, n=4, gravity=True),
    dict(width=5, height=4, n=3, gravity=True),
    dict(width=5, height=4, n=3, gravity=False),
]


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=["7x6n4", "5x4n3", "5x4n3-nogravity"])
def test_env_trajectories_match_jax(geometry):
    batch = 32
    jenv = JaxConnectN(JaxConnectNConfig(**geometry))
    env = ConnectN(ConnectNConfig(**geometry))
    rng = np.random.default_rng(5)

    jstep = jax.jit(jax.vmap(jenv.step))
    jlegal = jax.jit(jax.vmap(jenv.legal_mask))
    jobs = jax.jit(jax.vmap(jenv.observe))
    jstates = jax.vmap(lambda _: jenv.init())(jnp.arange(batch))
    states = env.init(batch, device="cpu")
    plies = geometry["width"] * geometry["height"] + 2
    for _ in range(plies):
        legal = np.asarray(jlegal(jstates))
        np.testing.assert_array_equal(env.legal_mask(states).numpy(), legal)
        np.testing.assert_array_equal(env.observe(states).numpy(),
                                      np.asarray(jobs(jstates)))
        # A uniform legal move; finished games get an arbitrary action.
        scores = rng.random(legal.shape) + legal
        actions = scores.argmax(axis=1).astype(np.int32)
        jstates, jreward = jstep(jstates, jnp.asarray(actions))
        states, reward = env.step(states, torch.from_numpy(actions))
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        for field in ("board", "heights", "fullmove", "terminal", "won"):
            np.testing.assert_array_equal(
                getattr(states, field).numpy(),
                np.asarray(getattr(jstates, field)), err_msg=field,
            )
        np.testing.assert_array_equal(
            env.terminal_value(states).numpy(),
            np.asarray(jax.vmap(jenv.terminal_value)(jstates)),
        )
    assert bool(states.terminal.all())


def test_step_lite_matches_step_board():
    env = ConnectN(ConnectNConfig())
    states = env.init(4, device="cpu")
    actions = torch.tensor([0, 3, 6, 3])
    full, _ = env.step(states, actions)
    lite = env.step_lite(states, actions)
    assert torch.equal(full.board, lite.board)
    assert torch.equal(full.heights, lite.heights)
    assert not bool(lite.terminal.any())


def test_has_line_all_directions():
    plane = torch.zeros((4, 6, 7), dtype=torch.bool)
    plane[0, 2, 1:5] = True                          # row
    plane[1, 0:4, 6] = True                          # column
    for i in range(4):
        plane[2, 1 + i, 2 + i] = True                # diagonal
        plane[3, 1 + i, 5 - i] = True                # anti-diagonal
    assert has_line(plane, 4).tolist() == [True] * 4
    plane[:, 2, 1] = False
    plane[:, 0, 6] = False
    plane[:, 1, 2] = False
    plane[:, 1, 5] = False
    assert has_line(plane, 4).tolist() == [False] * 4
