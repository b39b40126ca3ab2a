"""Run directory layout (the port's copy of paths.py):

    {results_dir}/{game}/{run_id}/
        self_play/{iteration}/samples.npz
        self_play/updated_mcts/
        training/                 <- latest checkpoint
        evaluation/iteration_{N}/ <- best-so-far lineage
        tensorboard/
        config.json               <- serialized config snapshot
"""

from __future__ import annotations

import os
from datetime import datetime

SELF_PLAY_DIR = "self_play"
TRAINING_DIR = "training"
EVALUATION_DIR = "evaluation"
TENSORBOARD_DIR = "tensorboard"
UPDATED_MCTS_DIR = "updated_mcts"
SAMPLES_FILE = "samples.npz"
CONFIG_FILE = "config.json"


def new_run_id() -> str:
    """Timestamp run id."""
    return datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def run_path(results_dir: str, game: str, run_id: str) -> str:
    return os.path.join(results_dir, game, run_id)


def self_play_path(results_dir: str, game: str, run_id: str) -> str:
    return os.path.join(run_path(results_dir, game, run_id), SELF_PLAY_DIR)


def self_play_iteration_path(results_dir, game, run_id, iteration: int) -> str:
    return os.path.join(self_play_path(results_dir, game, run_id), str(iteration))


def samples_path(results_dir, game, run_id, iteration: int) -> str:
    return os.path.join(
        self_play_iteration_path(results_dir, game, run_id, iteration), SAMPLES_FILE
    )


def training_path(results_dir, game, run_id) -> str:
    return os.path.join(run_path(results_dir, game, run_id), TRAINING_DIR)


def evaluation_path(results_dir, game, run_id) -> str:
    return os.path.join(run_path(results_dir, game, run_id), EVALUATION_DIR)


def evaluation_iteration_path(results_dir, game, run_id, iteration: int) -> str:
    return os.path.join(
        evaluation_path(results_dir, game, run_id), f"iteration_{iteration}"
    )


def tensorboard_path(results_dir, game, run_id) -> str:
    return os.path.join(run_path(results_dir, game, run_id), TENSORBOARD_DIR)


def updated_mcts_path(results_dir, game, run_id) -> str:
    return os.path.join(self_play_path(results_dir, game, run_id), UPDATED_MCTS_DIR)


def create_all_directories(results_dir: str, game: str, run_id: str) -> None:
    """Pre-create the run tree."""
    for path in (
        self_play_path(results_dir, game, run_id),
        training_path(results_dir, game, run_id),
        evaluation_path(results_dir, game, run_id),
        tensorboard_path(results_dir, game, run_id),
        updated_mcts_path(results_dir, game, run_id),
    ):
        os.makedirs(path, exist_ok=True)
