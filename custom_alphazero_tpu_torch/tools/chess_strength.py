"""Chess strength against fixed baseline opponents (random,
material-greedy); the port of tools/chess_strength.py.

Chess has no exact solver, so absolute strength evidence comes from win
rates against fixed opponents. Both sides of every game run on the device
in one lockstep batch; colour balance comes from playing half the games
with the tested model as first mover and half as second. The tested side
plays the argmax of the root visits of the general ``MCTS.search`` (chess
has no fused search), with root noise off.

Opponents:
- ``random``: uniform over legal moves.
- ``greedy``: material-greedy 1-ply: the captured piece's value
  (P1/N3/B3/R5/Q9) plus a queen-promotion bonus, random among ties
  (en-passant captures score 0 material: a documented approximation).

The random opponent's draws and the greedy tie-break noise come from a
``torch.Generator`` seeded with ``--seed``, not from JAX's keys, so the
games differ from the JAX tool's; the greedy scores are its exactly.

Run: python -m custom_alphazero_tpu_torch.tools.chess_strength --run_id=chess-r3 \\
       [--which=best] [--games=128] [--sims=100] [--opponent=random,greedy] \\
       [--seed=0] [--device=cpu]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import MCTSConfig, resolve_device
from custom_alphazero_tpu_torch.envs.chess import tables as T
from custom_alphazero_tpu_torch.envs.chess.engine import Chess
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args

_PIECE_VAL = (0.0, 1.0, 3.0, 3.0, 5.0, 9.0, 0.0)


def _greedy_scores(board_flat: torch.Tensor) -> torch.Tensor:
    """(B, A) float32 material scores for the side to move of (B, 64)
    canonical boards (enemy pieces are negative, so a capture target is
    max(-piece, 0)): the value of the piece on each action's destination,
    plus 0.5 for a queen promotion."""
    dev = board_flat.device
    to = torch.as_tensor(T.TO, dtype=torch.long, device=dev)
    captured = (-board_flat.long()[:, to]).clamp(0, 6)
    value = torch.tensor(_PIECE_VAL, device=dev)[captured]
    promo_q = torch.as_tensor(T.PROMO == T.QUEEN, device=dev).float()
    return value + 0.5 * promo_q[None, :]


def play_vs_opponent(
    env: Chess,
    evaluate_fn,
    opponent: str = "random",
    games: int = 128,
    sims: int = 100,
    seed: int = 0,
    max_plies: int = 200,
    topk_actions: int = 0,
    device=None,
) -> dict:
    """W/D/L of (net + search, argmax visits) against a baseline opponent,
    on ``device`` (None = the card).

    Plays ``games`` games in two lockstep half-batches (tested model first
    mover / second mover). Returns wins/draws/losses for the tested model
    and the mean game length; a game cut at ``max_plies`` is a draw."""
    device = resolve_device(device)
    half = max(games // 2, 1)
    mcts = MCTS(env, MCTSConfig(simulations=sims, topk_actions=topk_actions))
    generator = torch.Generator(device=device).manual_seed(seed)

    def tested_move(state):
        tree = mcts.search(state, evaluate_fn, None, sims)
        return mcts.root_child_visits(tree).argmax(-1)

    def opp_move(state):
        legal = env.legal_mask(state)
        noise = torch.rand(legal.shape, generator=generator, device=device)
        if opponent == "random":
            logits = torch.where(legal, noise, -1.0)
        else:  # material-greedy 1-ply with a random tie-break
            scores = _greedy_scores(state.board.reshape(-1, 64))
            logits = torch.where(legal, scores * 100.0 + 0.1 * noise, -1e9)
        return logits.argmax(-1)

    results = []
    lengths = []
    for tested_first in (True, False):
        state = env.init(half, device)
        last_tested = torch.zeros((half,), dtype=torch.bool, device=device)
        length = np.zeros((half,), np.int32)
        for ply in range(max_plies):
            tested_now = (ply % 2 == 0) == tested_first
            action = tested_move(state) if tested_now else opp_move(state)
            frozen = state.terminal
            nxt, _ = env.step(state, action)
            state = state.where(frozen, nxt)
            newly = state.terminal & ~frozen
            last_tested = torch.where(newly, tested_now, last_tested)
            length += (~frozen).cpu().numpy().astype(np.int32)
            if bool(state.terminal.all()):
                break
        won = state.won.cpu().numpy()
        terminal = state.terminal.cpu().numpy()
        lt = last_tested.cpu().numpy()
        for g in range(half):
            if not terminal[g]:
                results.append(0)  # cut at max_plies: scored as a draw
            elif won[g]:
                results.append(1 if lt[g] else -1)
            else:
                results.append(0)
        lengths.extend(length.tolist())
    return {
        "opponent": opponent,
        "games": len(results),
        "wins": sum(r == 1 for r in results),
        "draws": sum(r == 0 for r in results),
        "losses": sum(r == -1 for r in results),
        "win_rate": float(np.mean([r == 1 for r in results])),
        "score": float(np.mean([(r + 1) / 2 for r in results])),
        "mean_game_plies": float(np.mean(lengths)),
        "sims": sims,
    }


def main(argv=None):
    from custom_alphazero_tpu_torch.tools.strength import load_run_model

    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    device = args.get("--device")
    env, evaluate_fn, cfg, meta = load_run_model(
        args["--run_id"], args.get("--results_dir", "results"),
        args.get("--which", "best"), game="chess", device=device,
    )
    report = {"run_id": args["--run_id"], "steps": meta.get("steps")}
    for opp in args.get("--opponent", "random,greedy").split(","):
        r = play_vs_opponent(
            env, evaluate_fn, opponent=opp,
            games=int(args.get("--games", 128)),
            sims=int(args.get("--sims", 100)),
            seed=int(args.get("--seed", 0)),
            device=device,
        )
        report[opp] = r
        print(f"vs {opp}: {r}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
