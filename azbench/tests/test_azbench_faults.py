"""Runs of the harness on the CPU at a tiny size (the look for a card
skipped), sound and with the timed path broken underneath: a sound run
comes out correct, and each fault that a cell can have comes out not
correct under the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from azbench import harness
from azbench.tests import fixture

torch.set_num_threads(1)
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture.tiny_root(str(tmp_path_factory.mktemp("bench")))


def run(root, cell, seconds=0.5):
    return harness.run_cell(root, cell, seed=SEED, seconds=seconds,
                            trace=False, device="cpu")


@pytest.mark.parametrize("cell", sorted(fixture.TINY_CELLS))
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_selfplay_altered_answer(root, monkeypatch):
    from custom_alphazero_tpu_torch.runtime import selfplay

    sample = selfplay._sample_move

    def altered(visits, greedy, num_actions, generator):
        actions, pi = sample(visits, greedy, num_actions, generator)
        return actions, pi.roll(1, dims=-1)

    monkeypatch.setattr(selfplay, "_sample_move", altered)
    out = run(root, "tiny-selfplay")
    assert not out["correct"]
    assert out["compared"]["selfplay_faults"]["value"] > 0


def test_train_state_left_unchanged(root, monkeypatch):
    from custom_alphazero_tpu_torch.runtime import train

    monkeypatch.setattr(train, "sgd_momentum_update",
                        lambda *args, **kwargs: None)
    out = run(root, "tiny-train")
    assert not out["correct"]
    assert out["compared"]["change_gap_median"]["value"] > 0.9


def test_train_half_batch(root, monkeypatch):
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    step = Learner.train_step

    def half(self, obs, pi, z):
        n = obs.shape[0] // 2
        return step(self, obs[:n], pi[:n], z[:n])

    monkeypatch.setattr(Learner, "train_step", half)
    out = run(root, "tiny-train")
    assert not out["correct"], out["compared"]
