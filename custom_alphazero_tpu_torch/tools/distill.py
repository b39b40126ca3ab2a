"""Supervised solver distillation: a check of the net's and the trainer's
learning capacity (the port of tools/distill.py).

Trains the policy-value net directly on exact-solver labels (one-hot best
move and game-theoretic value) over positions sampled from random
rollouts, then measures the raw policy's move accuracy against the oracle
on held-out positions. This separates the learning machinery (net
capacity, losses, optimizer, train step) from self-play data quality.

The dataset functions are numpy and solver code on the host: with the same
seed they give the JAX tool's arrays byte for byte. The training runs the
port's train step on ``device`` (the card unless asked otherwise); its
initial weights come from torch's stream, not JAX's draws.

Run:  python -m custom_alphazero_tpu_torch.tools.distill --positions=5000 \\
        [--steps=3000] [--device=cpu]
      ... --labels_out=data/eval_labels.npz [--seed=1000] [--min_ply=10]
      ... --strong_out=out.npz [--exclude=a.npz,b.npz] [--merge=c.npz]
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from custom_alphazero_tpu_torch import solver as sv
from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    ModelConfig,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)


def board_obs(board: np.ndarray) -> np.ndarray:
    """(H, W) canonical int8 board -> the env's (H, W, 4) observation
    (empty / side-to-move / opponent one-hot + constant turn plane)."""
    return np.stack(
        [
            (board == 0).astype(np.float32),
            (board == 1).astype(np.float32),
            (board == -1).astype(np.float32),
            np.ones_like(board, np.float32),
        ],
        axis=-1,
    )


def child_values(board: np.ndarray, solver: sv.ConnectFourSolver) -> dict:
    """Exact value (side-to-move view, {-1,0,1}) of each legal column."""
    vals = {}
    for col in sv.legal_columns(board):
        child, ended = sv.play_canonical(board, col)
        if ended:
            vals[col] = 1 if sv._board_has_win(-child) else 0
        else:
            vals[col] = -int(np.sign(solver.solve_board(child)))
    return vals


def _label(board: np.ndarray, vals: dict, solver: sv.ConnectFourSolver):
    """(obs, one-hot pi on the oracle's ranked-best move, z, value-optimal
    mask) of a position whose child values are ``vals``."""
    best = max(vals.values())
    opt = np.zeros(7, bool)
    for col, v in vals.items():
        opt[col] = v == best
    pi = np.zeros(7, np.float32)
    ranked, value = solver.ranked_moves_and_value(board)
    pi[sv.legal_columns(board)[ranked[0]]] = 1.0
    return board_obs(board), pi, np.float32(value), opt


def _stacked(rows) -> dict:
    obs, pis, zs, optimal = zip(*rows)
    return {
        "obs": np.stack(obs),
        "pi": np.stack(pis),
        "z": np.asarray(zs, np.float32),
        "optimal": np.stack(optimal),
    }


def labeled_dataset(
    n_positions: int,
    seed: int = 0,
    min_ply: int = 6,
    max_ply: int = 34,
    solver: Optional[sv.ConnectFourSolver] = None,
):
    """Sample distinct midgame positions from random rollouts and label them
    with the oracle.

    Returns dict of arrays: obs (N,6,7,4), pi (N,7) one-hot best move,
    z (N,) exact value, optimal (N,7) bool mask of value-optimal columns.
    """
    solver = solver or sv.ConnectFourSolver()
    rng = np.random.default_rng(seed)
    seen = set()
    rows = []
    while len(rows) < n_positions:
        board = np.zeros((6, 7), np.int8)
        target_ply = int(rng.integers(min_ply, max_ply + 1))
        ply, ended = 0, False
        while ply < target_ply and not ended:
            legal = sv.legal_columns(board)
            board, ended = sv.play_canonical(board, int(rng.choice(legal)))
            ply += 1
        if ended:
            continue
        key = board.tobytes()
        if key in seen:
            continue
        seen.add(key)
        rows.append(_label(board, child_values(board, solver), solver))
    return _stacked(rows)


def _boards_from_obs(obs: np.ndarray):
    """Invert board_obs: (N, 6, 7, 4) observation -> (N, 6, 7) int8."""
    return (obs[..., 1] - obs[..., 2]).astype(np.int8)


def strongline_dataset(
    n_positions: int,
    seed: int = 0,
    opening_plies: int = 8,
    epsilon: float = 0.15,
    max_ply: int = 34,
    solver: Optional[sv.ConnectFourSolver] = None,
    exclude: tuple = (),
):
    """Label positions along (near-)perfect-play lines: random
    ``opening_plies``-ply openings (final_eval's start distribution), then
    both sides play solver-optimal moves (uniform among value-optimal
    columns) with an ``epsilon`` chance of a uniformly random deviation per
    ply. Every distinct position along these lines gets the oracle one-hot
    policy and exact value: the positions reachable under strong play,
    which random rollouts (labeled_dataset) under-represent.

    ``exclude``: board keys (bytes) never to emit (eval-set dedup).
    """
    solver = solver or sv.ConnectFourSolver()
    rng = np.random.default_rng(seed)
    seen = set(exclude)
    rows = []
    while len(rows) < n_positions:
        board = np.zeros((6, 7), np.int8)
        ended = False
        for _ in range(opening_plies):
            legal = sv.legal_columns(board)
            board, ended = sv.play_canonical(board, int(rng.choice(legal)))
            if ended:
                break
        ply = opening_plies
        while not ended and ply < max_ply and len(rows) < n_positions:
            vals = child_values(board, solver)
            best = max(vals.values())
            key = board.tobytes()
            if key not in seen:
                seen.add(key)
                rows.append(_label(board, vals, solver))
            legal = sv.legal_columns(board)
            if rng.random() < epsilon:
                col = int(rng.choice(legal))
            else:
                best_cols = [c for c, v in vals.items() if v == best]
                col = int(rng.choice(best_cols))
            board, ended = sv.play_canonical(board, col)
            ply += 1
    return _stacked(rows)


def run_distillation(
    train_set: dict,
    test_set: dict,
    model_cfg: Optional[ModelConfig] = None,
    steps: int = 3000,
    batch_size: int = 256,
    seed: int = 0,
    log_every: int = 500,
    device=None,
) -> dict:
    """Train on solver labels on ``device`` (None = the card); return the
    raw policy's oracle accuracies, the history and the train state."""
    device = resolve_device(device)
    model_cfg = model_cfg or ModelConfig(
        depth=3, filters=64, value_hidden=128, lr_values=(0.01, 0.001, 0.0001)
    )
    env = ConnectN(ConnectNConfig())
    state = init_train_state(
        env.num_actions, model_cfg,
        torch.Generator(device=device).manual_seed(seed), env.obs_shape,
        device=device,
    )
    train_step = make_train_step(model_cfg)
    on_device = {
        name: {k: torch.from_numpy(v).to(device) for k, v in split.items()
               if k in ("obs", "pi", "z")}
        for name, split in (("train", train_set), ("test", test_set))
    }

    def evaluate(split: dict, name: str) -> dict:
        with torch.inference_mode():
            logits, value = state.net.eval()(on_device[name]["obs"])
        logits = logits.float().cpu().numpy()
        value = value.float().cpu().numpy()
        legal = split["obs"][:, 0, :, 1] + split["obs"][:, 0, :, 2] == 0
        choice = np.where(legal, logits, -np.inf).argmax(-1)
        acc = split["optimal"][np.arange(len(choice)), choice].mean()
        # Value accuracy: the tanh output binned into {-1, 0, +1} at 1/3.
        pred_cat = np.where(value > 1 / 3, 1, np.where(value < -1 / 3, -1, 0))
        value_acc = (pred_cat == np.sign(split["z"])).mean()
        return {"move_accuracy": float(acc), "value_accuracy": float(value_acc)}

    rng = np.random.default_rng(seed)
    train = on_device["train"]
    n = len(train_set["obs"])
    history = []
    for step in range(steps):
        idx = torch.from_numpy(
            rng.choice(n, size=min(batch_size, n), replace=False)).to(device)
        state, m = train_step(state, train["obs"][idx], train["pi"][idx],
                              train["z"][idx])
        if (step + 1) % log_every == 0:
            ev = evaluate(test_set, "test")
            history.append({"step": step + 1, "loss": float(m.loss), **ev})
            print(f"[distill {step + 1}] loss={float(m.loss):.3f} "
                  f"test-move-acc={ev['move_accuracy']:.3f} "
                  f"test-value-acc={ev['value_accuracy']:.3f}")
    return {
        "train": evaluate(train_set, "train"),
        "test": evaluate(test_set, "test"),
        "history": history,
        "state": state,
    }


def main(argv=None):
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None
                                          else argv))
    n = int(args.get("--positions", 5000))
    steps = int(args.get("--steps", 3000))
    t0 = time.time()
    solver = sv.ConnectFourSolver()
    if "--strong_out" in args:
        # Strong-line labels, deduplicated against the sets given with
        # --exclude (comma-separated), optionally merged into --merge's.
        exclude = set()
        for path in filter(None, args.get("--exclude", "").split(",")):
            prev = np.load(path)
            for b in _boards_from_obs(prev["obs"]):
                exclude.add(b.tobytes())
        data = strongline_dataset(
            n,
            seed=int(args.get("--seed", 2000)),
            epsilon=float(args.get("--epsilon", 0.15)),
            opening_plies=int(args.get("--opening_plies", 8)),
            max_ply=int(args.get("--max_ply", 34)),
            solver=solver,
            exclude=tuple(exclude),
        )
        if "--merge" in args:
            prev = np.load(args["--merge"])
            merged = {}
            for key in data:
                if key in prev:
                    merged[key] = np.concatenate([prev[key], data[key]])
                else:  # aux-value-only sets carry just obs/z
                    merged[key] = data[key]
            data = merged
        np.savez_compressed(args["--strong_out"], **data)
        print(
            f"Wrote {len(data['obs'])} labeled positions "
            f"({n} strong-line new) to {args['--strong_out']} in "
            f"{time.time() - t0:.0f}s"
        )
        return
    if "--labels_out" in args:
        # A labeled evaluation set (data/eval_labels.npz's generator; read
        # by strength.labeled_policy_accuracy and final_eval --labels).
        # min_ply >= 10 keeps solves under a second.
        data = labeled_dataset(
            n,
            seed=int(args.get("--seed", 1000)),
            min_ply=int(args.get("--min_ply", 10)),
            max_ply=int(args.get("--max_ply", 34)),
            solver=solver,
        )
        np.savez_compressed(args["--labels_out"], **data)
        print(
            f"Wrote {len(data['obs'])} labeled positions to "
            f"{args['--labels_out']} in {time.time() - t0:.0f}s"
        )
        return
    data = labeled_dataset(n + n // 5, seed=0, solver=solver)
    print(f"Labeled {len(data['obs'])} positions in {time.time() - t0:.0f}s")
    train_set = {k: v[:n] for k, v in data.items()}
    test_set = {k: v[n:] for k, v in data.items()}
    result = run_distillation(train_set, test_set, steps=steps,
                              device=args.get("--device"))
    print(f"train: {result['train']}  test: {result['test']}")


if __name__ == "__main__":
    main()
