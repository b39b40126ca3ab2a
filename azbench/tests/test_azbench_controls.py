"""The precision controls at a size a test run holds: the reference computed
one precision below the configuration's bfloat16 (float8 with a scale per
tensor), put in the program's place, fails the c4-r5 cells' limits (the
self-play cell's, and the train cell's that is ready to be added). The
committed c4-r5 weights on the CPU, with fewer rows or roots than the
cells time."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from azbench import checks, harness
from azbench.drivers import common, train
from azbench.reference import connect4
from azbench.reference import net as ref_net
from azbench.reference import search as ref_search
from azbench.tests import fixture

torch.set_num_threads(2)


def cell_run(cell):
    bench = harness._load_json(fixture.REPO + "/BENCHMARK.json")
    bench["workloads"].append(fixture.TRAIN_CELL)
    return harness.Run(fixture.REPO, bench, cell, 5, 0.0, False, "cpu",
                       time.perf_counter())


@pytest.fixture(scope="module")
def weights():
    return common.reference_weights(cell_run("c4r5-selfplay"), "cpu")


def positions(count, seed):
    rng = np.random.default_rng(seed)
    return connect4.random_positions(rng, count, 6, 7, 4, 30)


def test_selfplay_control_fails(weights):
    run = cell_run("c4r5-selfplay")
    cfg = run.program_config()
    params, stats, _, _ = weights
    boards = positions(12, 1)
    boards = boards[(boards != 0).sum((1, 2)) < cfg.mcts.greedy_from_move]
    sims = cfg.mcts.simulations
    gamma = np.random.default_rng(2).gamma(
        cfg.mcts.dirichlet_alpha, size=(sims, len(boards), 7)).astype(
            np.float32)
    visits = {}
    for name, quantize in (("ref", None), ("low", ref_net.float8_rounding)):
        visits[name] = ref_search.search(
            boards, common.reference_evaluator(params, stats, 4, "cpu",
                                               quantize),
            sims, cfg.mcts.c_puct, 4, gamma, cfg.mcts.dirichlet_fraction)
    tv = checks.visit_distance(visits["low"], visits["ref"])
    assert tv > run.limits["search_tv_mean"], tv


def test_train_control_fails():
    run = cell_run("c4r5-train")
    cfg = run.program_config()
    rng = np.random.default_rng(3)
    batches = []
    for i in range(3):
        pi = rng.dirichlet(np.ones(7), 128).astype(np.float32)
        z = rng.choice([-1.0, 0.0, 1.0], 128).astype(np.float32)
        batches.append((connect4.observe(positions(128, 10 + i)), pi, z))
    states = [torch.Generator().manual_seed(i).get_state() for i in range(3)]
    common.strict_float32()
    ref = train.follow(run, cfg, batches, states, "cpu")
    low = train.follow(run, cfg, batches, states, "cpu",
                       quantize=ref_net.float8_rounding)
    m1 = {k: low.grads_1[k] + cfg.model.momentum * low.momentum_0[k]
          for k in low.grads_1}
    numbers = train.judge(low.losses, m1, low.end, ref, cfg.model.momentum)
    assert any(numbers[k] > run.limits[k] for k in train.COMPARED), numbers
