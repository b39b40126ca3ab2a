"""Strength evaluation against the exact-solver oracle (the port of
tools/strength.py).

Each candidate move is scored 1 - (rank+1)/num_legal against the perfect
ranking, and "move accuracy" is the fraction of moves that are
solver-optimal (same best game-theoretic value). Positions come from games
played by the policy under test (raw network argmax or a full search at
B=1 with the general ``MCTS.search``), every move of the tested player
scored on the host through the native solver. With the same evaluator and
no root noise, the moves and the report equal the JAX package's on the
CPU (tests/test_torch_port_oracle.py).

    python -m custom_alphazero_tpu_torch.tools.strength --run_id=demo \\
        [--which=best|last] [--games=20] [--sims=250] [--opponent=random] \\
        [--raw_policy=false] [--labels=data/eval_labels.npz]
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch import solver as sv
from custom_alphazero_tpu_torch.config import (
    MCTSConfig,
    from_json,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.io.checkpoint import (
    latest_evaluation_iteration,
    load_checkpoint,
)
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.search.mcts import MCTS


def evaluate_strength(
    env: ConnectN,
    evaluate_fn: Callable,
    num_games: int = 20,
    use_mcts: bool = True,
    mcts_cfg: MCTSConfig = MCTSConfig(simulations=64),
    opponent: str = "random",
    seed: int = 0,
    max_positions: Optional[int] = None,
    solver: Optional[sv.ConnectFourSolver] = None,
    opening_plies: int = 8,
    device=None,
) -> dict:
    """Play games (tested policy as first mover vs an opponent) and score
    the tested policy's moves with the solver. ``device=None`` is the card.

    opening_plies: random opening moves played by both sides before the
    policies take over (solver queries on near-empty boards take seconds;
    even plies keep the tested policy as the nominal first mover).

    Returns {move_accuracy, mean_rank_score, blunders, positions, results,
    expected_results, ...}:
    - move_accuracy: fraction of moves whose child value equals the best
      child's game-theoretic value (value-optimal moves);
    - mean_rank_score: 1 - (rank+1)/num_legal averaged;
    - blunders: value-category drops (win->draw/loss or draw->loss);
    - results: +1/0/-1 game outcomes for the tested policy;
    - expected_results: the solver's game-theoretic outcome of each random
      opening from the tested side's view; with it converted_wins /
      expected_wins (won openings actually won) and losses_from_nonlost
      (losses from theoretically won/drawn openings: 0 for perfect play).
    """
    device = resolve_device(device)
    solver = solver or sv.ConnectFourSolver()
    mcts = MCTS(env, mcts_cfg)
    rng = np.random.default_rng(seed)

    def step(state, action: int):
        return env.step(state, torch.tensor([action], device=device))[0]

    opening_plies -= opening_plies % 2  # keep tested side on even plies
    accs, rank_scores, blunders, results = [], [], 0, []
    expected_results = []
    positions = 0
    for game in range(num_games):
        state = env.init(1, device)
        ply = 0
        while ply < opening_plies and not bool(state.terminal[0]):
            legal = np.nonzero(env.legal_mask(state)[0].cpu().numpy())[0]
            state = step(state, int(rng.choice(legal)))
            ply += 1
        # The opening's game-theoretic value from the tested side's view
        # (the board is canonical: the tested policy moves at even plies).
        if bool(state.terminal[0]):
            # Opening randomness ended the game: expected == achieved.
            won = bool(state.won[0])
            tested_last = (ply - 1) % 2 == 0
            expected_results.append(
                1 if won and tested_last else (-1 if won else 0)
            )
        else:
            expected_results.append(int(np.sign(
                solver.solve_board(state.board[0].cpu().numpy()))))
        while not bool(state.terminal[0]):
            board = state.board[0].cpu().numpy()
            if ply % 2 == 0:  # tested policy to move
                if use_mcts:
                    generator = torch.Generator(device=device).manual_seed(
                        seed * 7919 + game * 101 + ply)
                    tree = mcts.search(state, evaluate_fn, generator,
                                       mcts_cfg.simulations)
                    visits = mcts.root_child_visits(tree)[0].cpu().numpy()
                    action = int(visits.argmax())
                else:
                    probs = evaluate_fn(env.observe(state))[0][0]
                    probs = probs.float().cpu().numpy()
                    mask = env.legal_mask(state)[0].cpu().numpy()
                    probs = np.where(mask, probs, -1.0)
                    action = int(probs.argmax())
                if max_positions is None or positions < max_positions:
                    legal = sv.legal_columns(board)
                    # Child values in the mover's view: ending moves use the
                    # ending value; others negate the child's score sign.
                    child_vals = {}
                    for col in legal:
                        child, ended = sv.play_canonical(board, col)
                        if ended:
                            won = sv._board_has_win(-child)
                            child_vals[col] = 1 if won else 0
                        else:
                            child_vals[col] = -int(np.sign(
                                solver.solve_board(child)))
                    best_value = max(child_vals.values())
                    accs.append(1.0 if child_vals[action] == best_value
                                else 0.0)
                    rank_scores.append(solver.move_rank_score(board, action))
                    if child_vals[action] < best_value:
                        blunders += 1
                    positions += 1
            else:
                legal = np.nonzero(env.legal_mask(state)[0].cpu().numpy())[0]
                if opponent == "random":
                    action = int(rng.choice(legal))
                else:  # solver-perfect opponent
                    ranked, _ = solver.ranked_moves_and_value(board)
                    action = sv.legal_columns(board)[int(ranked[0])]
            state = step(state, action)
            ply += 1
        won = bool(state.won[0])
        last_mover_tested = (ply - 1) % 2 == 0
        results.append(1 if won and last_mover_tested else (-1 if won else 0))
    expected_wins = sum(e == 1 for e in expected_results)
    converted = sum(
        1 for e, r in zip(expected_results, results) if e == 1 and r == 1
    )
    losses_from_nonlost = sum(
        1 for e, r in zip(expected_results, results) if e >= 0 and r == -1
    )
    return {
        "move_accuracy": float(np.mean(accs)) if accs else 0.0,
        "mean_rank_score": float(np.mean(rank_scores)) if rank_scores else 0.0,
        "blunders": blunders,
        "positions": positions,
        "results": results,
        "expected_results": expected_results,
        "expected_wdl": (
            expected_wins,
            sum(e == 0 for e in expected_results),
            sum(e == -1 for e in expected_results),
        ),
        "converted_wins": converted,
        "expected_wins": expected_wins,
        "losses_from_nonlost": losses_from_nonlost,
        "win_rate": float(np.mean([r == 1 for r in results])),
    }


def load_run_model(run_id: str, results_dir: str = "results",
                   which: str = "best", game: str = "connect_n",
                   device=None):
    """Load a run's model, written by either package, for evaluation:
    ``which`` = "best" (newest promoted lineage under evaluation/iteration_N)
    or "last" (the training/ checkpoint).

    Returns (env, evaluate_fn, cfg, meta): evaluate_fn(obs) -> (probs,
    value) runs the port's net in the config's compute dtype on ``device``
    (None = the card)."""
    if game != "connect_n":
        raise NotImplementedError(
            f"game={game!r} is not ported yet (ROADMAP.md queue 1, "
            "'Chess engine')"
        )
    device = resolve_device(device)
    with open(os.path.join(paths.run_path(results_dir, game, run_id),
                           paths.CONFIG_FILE)) as fp:
        cfg = from_json(fp.read())
    env = ConnectN(cfg.connect_n)
    if which == "best":
        found = latest_evaluation_iteration(
            paths.evaluation_path(results_dir, game, run_id)
        )
        if found is None:
            raise FileNotFoundError(f"No promoted model in run {run_id}")
        tree, meta = load_checkpoint(found[1])
        meta["iteration"] = found[0]
    else:
        tree, meta = load_checkpoint(
            paths.training_path(results_dir, game, run_id))
    net = from_jax_variables(
        tree["params"], tree["batch_stats"], env.num_actions, cfg.model,
        env.obs_shape[-1], env.obs_shape[:2], device=device)
    return env, make_evaluate_fn(net), cfg, meta


def labeled_policy_accuracy(evaluate_fn, labels_npz: str,
                            device=None) -> dict:
    """Raw-policy oracle accuracy on a precomputed solver-labeled position
    set (arrays ``obs``, ``optimal``, ``z``): a fast strength probe that
    needs no solver calls. The positions are evaluated in one batch on
    ``device`` (None = the card)."""
    data = np.load(labels_npz)
    obs, optimal, z = data["obs"], data["optimal"], data["z"]
    probs, value = evaluate_fn(torch.from_numpy(obs).to(
        resolve_device(device)))
    probs = probs.float().cpu().numpy()
    value = value.float().cpu().numpy()
    legal = obs[:, 0, :, 1] + obs[:, 0, :, 2] == 0
    choice = np.where(legal, probs, -1.0).argmax(-1)
    pred_cat = np.where(value > 1 / 3, 1, np.where(value < -1 / 3, -1, 0))
    zs = np.sign(z)
    decisive = zs != 0
    # Beside the +-1/3 categorical accuracy (which under-reports a
    # correctly-signed but compressed head): the sign accuracy on decisive
    # positions, the correlation, and the mean prediction per true class.
    return {
        "move_accuracy": float(optimal[np.arange(len(choice)), choice].mean()),
        "value_accuracy": float((pred_cat == zs).mean()),
        "value_sign_accuracy": float(
            (np.sign(value[decisive]) == zs[decisive]).mean()
        ) if decisive.any() else 0.0,
        "value_corr": float(np.corrcoef(value, z)[0, 1]),
        "value_mean_by_class": {
            int(c): float(value[zs == c].mean())
            for c in (-1, 0, 1) if (zs == c).any()
        },
        "positions": int(len(obs)),
    }


def score_arena_log(log, min_ply: int = 8, max_positions: int = 200,
                    seed: int = 0,
                    solver: Optional[sv.ConnectFourSolver] = None) -> float:
    """Solver-score the candidate's moves of an ``ArenaGameLog`` by
    replaying the recorded actions on the host: the mean of
    ``move_rank_score`` over a random sample of at most ``max_positions``
    candidate moves from ply ``min_ply`` on (near-empty boards cost seconds
    each). The sample and the order of the sum are the JAX package's, so
    the same log gives the same float."""
    solver = solver or sv.ConnectFourSolver()
    actions, movers, active = (
        t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in (log.actions, log.movers, log.active))  # (T, B) each
    T, B = actions.shape
    candidates = []  # (game, ply) of scoreable candidate moves
    for g in range(B):
        for t in range(min_ply, T):
            if not active[t, g]:
                break
            if movers[t, g] == 0:
                candidates.append((g, t))
    rng = np.random.default_rng(seed)
    if len(candidates) > max_positions:
        picked = rng.choice(len(candidates), max_positions, replace=False)
        chosen = {candidates[i] for i in picked}
    else:
        chosen = set(candidates)
    by_game = {}
    for g, t in chosen:
        by_game.setdefault(g, set()).add(t)
    scores = []
    for g, plies in by_game.items():
        board = np.zeros((6, 7), np.int8)
        for t in range(T):
            if not active[t, g]:
                break
            col = int(actions[t, g])
            if t in plies:
                try:
                    scores.append(solver.move_rank_score(board, col))
                except ValueError:
                    pass
            board, _ = sv.play_canonical(board, col)
    return float(np.mean(scores)) if scores else 0.0


def main(argv=None):
    """CLI: oracle-score a run's model on the card (see the module doc)."""
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None
                                          else argv))
    run_id = args["--run_id"]
    env, evaluate_fn, cfg, meta = load_run_model(
        run_id, args.get("--results_dir", "results"),
        args.get("--which", "best"),
    )
    print(f"Loaded {args.get('--which', 'best')} model of run {run_id} "
          f"(steps={meta.get('steps')}, iteration={meta.get('iteration')})")
    if "--labels" in args:
        acc = labeled_policy_accuracy(evaluate_fn, args["--labels"])
        print(f"labeled-set raw policy: {acc}")
    sims = int(args.get("--sims", cfg.mcts.simulations))
    report = evaluate_strength(
        env,
        evaluate_fn,
        num_games=int(args.get("--games", 20)),
        use_mcts=args.get("--raw_policy", "false").lower() not in
        ("1", "true"),
        mcts_cfg=MCTSConfig(simulations=sims),
        opponent=args.get("--opponent", "random"),
        seed=int(args.get("--seed", 0)),
    )
    results = report.pop("results")
    wdl = (sum(r == 1 for r in results), sum(r == 0 for r in results),
           sum(r == -1 for r in results))
    print(f"strength: {report}  W/D/L={wdl}")


if __name__ == "__main__":
    main()
