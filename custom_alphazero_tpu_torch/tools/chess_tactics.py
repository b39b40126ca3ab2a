"""Mate-in-1 and mate-in-2 tactics sets: generation, labeling, and model
evaluation (the port of tools/chess_tactics.py).

Chess has no exact-solver oracle, so objective (not arena-relative)
strength evidence comes from engine-labeled tactics: the engine's own
legality and terminal logic labels them exactly.

Labels are pure functions of a batch of positions:
- ``mate_in_1_labels``: every legal move of every position is stepped in
  one batched ``env.step``; the mating moves (the child is terminal and
  won by the mover; stalemates end as draws) are the labels.
- ``mate_in_2_labels``: a position with no mate-in-1 and a CHECKING move m
  such that no reply ends the game and every reply leaves the mover a
  mate-in-1; the labels are all such m. Quiet mate-in-2s (without check)
  are out of scope, as in the JAX tool.
The generators screen random self-play positions with them. The rollouts
draw their moves from a ``torch.Generator``, not JAX's keys, so a
generated set differs from the JAX tool's; the labels of given positions
are its exactly.

Metrics (higher = stronger; the random-legal baseline is about
1/num_legal):
- raw_policy: the argmax over legal moves of the net's policy is a labeled
  move;
- mcts: the argmax-visit move of the general search (root noise off;
  auto top-K) is a labeled move.

Run:
  python -m custom_alphazero_tpu_torch.tools.chess_tactics --generate=t.npz \\
      [--positions=500] [--seed=0]
  python -m custom_alphazero_tpu_torch.tools.chess_tactics --generate2=t2.npz \\
      [--positions=200] [--seed=0]
  python -m custom_alphazero_tpu_torch.tools.chess_tactics --labels=t.npz \\
      --run_id=chess-r3 [--which=best] [--sims=64] [--mcts=true]
  python -m custom_alphazero_tpu_torch.tools.chess_tactics --labels=t.npz \\
      --uniform=true --mcts=true [--sims=100]
  python -m custom_alphazero_tpu_torch.tools.chess_tactics \\
      --labels=a.npz,b.npz --export_labels=out.npz
Every form takes --device=cpu to run on the CPU.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from custom_alphazero_tpu_torch.config import (
    ChessConfig,
    MCTSConfig,
    resolve_device,
)
from custom_alphazero_tpu_torch.envs.chess.engine import Chess, ChessState
from custom_alphazero_tpu_torch.search.mcts import MCTS
from custom_alphazero_tpu_torch.tools.cli import parse_kv_args

# Rows per batched env.step when expanding moves.
CHUNK = 1024
STATE_FIELDS = ("board", "castling", "ep_file", "halfmove", "fullmove")


def _expand(env: Chess, states: ChessState, owners: torch.Tensor,
            actions: torch.Tensor) -> ChessState:
    """The children of ``states[owners[i]]`` stepped with ``actions[i]``,
    CHUNK rows per step."""
    parts = []
    for i0 in range(0, len(actions), CHUNK):
        child, _ = env.step(states.take(owners[i0:i0 + CHUNK]),
                            actions[i0:i0 + CHUNK])
        parts.append(child)
    return ChessState.cat(parts)


def mate_in_1_labels(env: Chess, states: ChessState):
    """(mate (B, A) bool: the moves that checkmate, legal (B, A) bool)."""
    legal = env.legal_mask(states)
    owners, actions = legal.nonzero(as_tuple=True)
    mate = torch.zeros_like(legal)
    if len(actions):
        child = _expand(env, states, owners, actions)
        hit = child.terminal & child.won
        mate[owners[hit], actions[hit]] = True
    return mate, legal


def mate_in_2_labels(env: Chess, states: ChessState):
    """(mate2 (B, A) bool: the checking moves that force mate next move,
    legal (B, A) bool). A position with a mate-in-1 has no labels."""
    legal = env.legal_mask(states)
    mate2 = torch.zeros_like(legal)
    own1, act1 = legal.nonzero(as_tuple=True)
    if not len(act1):
        return mate2, legal
    # L1: every legal move of every position.
    l1 = _expand(env, states, own1, act1)
    has_mate1 = torch.zeros(legal.shape[0], dtype=torch.bool,
                            device=legal.device)
    has_mate1[own1[l1.terminal & l1.won]] = True
    # Candidate first moves: checking, game not over, no mate-in-1 at all.
    cidx = (~l1.terminal & l1.in_check & ~has_mate1[own1]).nonzero()[:, 0]
    if not len(cidx):
        return mate2, legal
    # L2: every reply to every candidate; a game-ending reply refutes it.
    l1c = l1.take(cidx)
    own2, act2 = env.legal_mask(l1c).nonzero(as_tuple=True)
    l2 = _expand(env, l1c, own2, act2)
    refuted = torch.zeros(len(cidx), dtype=torch.bool, device=legal.device)
    refuted[own2[l2.terminal]] = True
    # L3: does the mover have a mate-in-1 after each surviving reply?
    kidx = (~l2.terminal & ~refuted[own2]).nonzero()[:, 0]
    mate1_ok = torch.zeros(len(own2), dtype=torch.bool, device=legal.device)
    if len(kidx):
        mate_after, _ = mate_in_1_labels(env, l2.take(kidx))
        mate1_ok[kidx[mate_after.any(-1)]] = True
    # A candidate survives when every reply leaves a mate-in-1.
    failed = torch.zeros(len(cidx), dtype=torch.bool, device=legal.device)
    failed[own2[~mate1_ok]] = True
    replies = torch.bincount(own2, minlength=len(cidx))
    ok = cidx[~failed & (replies > 0)]
    mate2[own1[ok], act1[ok]] = True
    return mate2, legal


def _random_moves(env: Chess, state: ChessState, generator) -> torch.Tensor:
    """A uniformly random legal move per game (0 where none is legal)."""
    legal = env.legal_mask(state)
    noise = torch.rand(legal.shape, generator=generator,
                       device=legal.device)
    return torch.where(legal, noise, -1.0).argmax(-1)


def _save(path: str, found: dict, masks: dict) -> dict:
    arrays = {k: np.stack(v) for k, v in found.items()}
    arrays.update({k: np.stack(v) for k, v in masks.items()})
    np.savez_compressed(path, **arrays)
    return arrays


def _screen(env, state, labels_fn, found, masks, key, limit):
    """Label the live games of ``state``; append each labeled one to
    ``found`` / ``masks`` (at most ``limit``). Returns how many."""
    live = (~state.terminal).nonzero()[:, 0]
    sub = state.take(live)
    labels, legal = labels_fn(env, sub)
    rows = labels.any(-1).nonzero()[:, 0][:limit]
    host = {k: getattr(sub, k)[rows].cpu().numpy() for k in STATE_FIELDS}
    labels, legal = labels[rows].cpu().numpy(), legal[rows].cpu().numpy()
    for j in range(len(rows)):
        for k in STATE_FIELDS:
            found[k].append(host[k][j])
        masks[key].append(labels[j])
        masks["legal_mask"].append(legal[j])
    return len(rows)


def generate_tactics(
    path: str,
    positions: int = 500,
    seed: int = 0,
    batch: int = 256,
    max_plies: int = 160,
    device=None,
) -> dict:
    """Random-play screening for mate-in-1 positions; writes ``path``.

    Saved arrays: board/castling/ep_file/halfmove/fullmove (enough for
    ``Chess.state_from_arrays``: mate-in-1 is history-independent), the
    (P, A) legal mask and the (P, A) mate-action mask."""
    device = resolve_device(device)
    env = Chess(ChessConfig())
    generator = torch.Generator(device=device).manual_seed(seed)
    init = env.init(batch, device)
    found = {k: [] for k in STATE_FIELDS}
    masks = {"mate_mask": [], "legal_mask": []}
    state = init
    total = 0
    for _ in range(max_plies):
        nxt, _ = env.step(state, _random_moves(env, state, generator))
        state = state.where(state.terminal, nxt)
        if bool(state.terminal.all()):
            state = init
            continue
        total += _screen(env, state, mate_in_1_labels, found, masks,
                         "mate_mask", None)
        if total >= positions:
            break
    arrays = _save(path, found, masks)
    print(f"tactics: {total} mate-in-1 positions -> {path} "
          f"(mean mating moves "
          f"{arrays['mate_mask'].sum(1).mean():.2f}, "
          f"mean legal {arrays['legal_mask'].sum(1).mean():.1f})")
    return {"positions": total, "path": path}


def generate_mate_in_2(
    path: str,
    positions: int = 200,
    seed: int = 0,
    batch: int = 128,
    max_plies: int = 160,
    device=None,
) -> dict:
    """Engine-labeled forced mate-in-2 set (``mate_in_2_labels`` over random
    self-play positions; finished games restart from the opening, so the
    whole batch keeps producing candidates). Saved arrays: the
    state_from_arrays fields, the (P, A) legal_mask and mate2_mask."""
    device = resolve_device(device)
    env = Chess(ChessConfig())
    generator = torch.Generator(device=device).manual_seed(seed)
    init = env.init(batch, device)
    found = {k: [] for k in STATE_FIELDS}
    masks = {"mate2_mask": [], "legal_mask": []}
    state = init
    total = 0
    for ply in range(max_plies):
        if total >= positions:
            break
        if ply % 10 == 0:
            print(f"tactics2: ply {ply}, {total}/{positions} found",
                  flush=True)
        nxt, _ = env.step(state, _random_moves(env, state, generator))
        state = init.where(nxt.terminal, nxt)
        total += _screen(env, state, mate_in_2_labels, found, masks,
                         "mate2_mask", positions - total)
    arrays = _save(path, found, masks)
    print(f"tactics2: {total} mate-in-2 positions -> {path} "
          f"(mean mating moves {arrays['mate2_mask'].sum(1).mean():.2f}, "
          f"mean legal {arrays['legal_mask'].sum(1).mean():.1f})",
          flush=True)
    return {"positions": total, "path": path}


def states_from_npz(env: Chess, data, device=None) -> ChessState:
    """Every row of a tactics set as one batch of states (one batched
    ``state_from_arrays``) on ``device`` (None = the card)."""
    return env.state_from_arrays(
        np.asarray(data["board"]), np.asarray(data["castling"]).astype(bool),
        np.asarray(data["ep_file"]), np.asarray(data["halfmove"]),
        np.asarray(data["fullmove"]), device)


def slice_states(states: ChessState, i0: int, i1: int) -> ChessState:
    """Rows ``i0:i1`` of a batch of states."""
    return states.take(torch.arange(i0, i1, device=states.board.device))


def evaluate_tactics(
    evaluate_fn,
    labels_npz: str,
    use_mcts: bool = False,
    sims: int = 64,
    batch: int = 64,
    device=None,
) -> dict:
    """Fraction of tactics positions whose chosen move is a labeled one,
    ``batch`` positions per search or forward on ``device`` (None = the
    card)."""
    device = resolve_device(device)
    env = Chess(ChessConfig())
    data = np.load(labels_npz)
    states = states_from_npz(env, data, device)
    # Mate-in-1 sets store mate_mask, mate-in-2 sets mate2_mask; the
    # scoring is the same.
    key = "mate_mask" if "mate_mask" in data else "mate2_mask"
    mate_mask = data[key]
    legal_mask = data["legal_mask"]
    n_rows = len(data["board"])
    hits = []
    mcts = MCTS(env, MCTSConfig(simulations=sims)) if use_mcts else None
    for i0 in range(0, n_rows, batch):
        stacked = slice_states(states, i0, min(i0 + batch, n_rows))
        if use_mcts:
            tree = mcts.search(stacked, evaluate_fn, None, sims)
            act = mcts.root_child_visits(tree).cpu().numpy().argmax(-1)
        else:
            probs = evaluate_fn(env.observe(stacked))[0].float().cpu().numpy()
            probs = np.where(legal_mask[i0:i0 + len(probs)], probs, -1.0)
            act = probs.argmax(axis=-1)
        for j, a in enumerate(act):
            hits.append(bool(mate_mask[i0 + j, a]))
    rand_base = [mate_mask[i].sum() / max(legal_mask[i].sum(), 1)
                 for i in range(n_rows)]
    return {
        "accuracy": float(np.mean(hits)),
        "positions": len(hits),
        "random_baseline": float(np.mean(rand_base)),
        "mode": "mcts" if use_mcts else "raw_policy",
        "sims": sims if use_mcts else None,
    }


def export_labels(sources, out: str, device=None) -> int:
    """Tactics sets -> the aux-label format the training loop reads
    (loop.solver_labels_path: obs / pi / z): pi uniform over the labeled
    moves, z = +1 (the side to move mates or forces mate). Returns the
    number of rows written."""
    device = resolve_device(device)
    env = Chess(ChessConfig())
    obs_all, pi_all, z_all = [], [], []
    for src in sources:
        data = np.load(src)
        states = states_from_npz(env, data, device)
        key = "mate_mask" if "mate_mask" in data else "mate2_mask"
        mm = data[key].astype(np.float32)
        pi = mm / np.maximum(mm.sum(-1, keepdims=True), 1e-9)
        n_rows = len(data["board"])
        for i0 in range(0, n_rows, 64):
            stacked = slice_states(states, i0, min(i0 + 64, n_rows))
            obs_all.append(env.observe(stacked).cpu().numpy())
        pi_all.append(pi)
        z_all.append(np.ones(n_rows, np.float32))
    np.savez_compressed(
        out,
        obs=np.concatenate(obs_all).astype(np.float32),
        pi=np.concatenate(pi_all),
        z=np.concatenate(z_all),
    )
    return sum(len(z) for z in z_all)


def uniform_evaluate(num_actions: int):
    """The uniform-evaluator control: a flat prior and a zero value, which
    separates "the net is weak" from "the simulation budget is too small"."""

    def evaluate_fn(obs):
        b = obs.shape[0]
        return (torch.full((b, num_actions), 1.0 / num_actions,
                           device=obs.device),
                torch.zeros((b,), device=obs.device))

    return evaluate_fn


def main(argv=None):
    args = parse_kv_args(sys.argv[1:] if argv is None else argv, __doc__)
    device = args.get("--device")
    if "--export_labels" in args:
        out = args["--export_labels"]
        n = export_labels(args["--labels"].split(","), out, device)
        print(f"Wrote {n} tactic labels to {out}")
        return
    if "--generate" in args:
        return generate_tactics(
            args["--generate"],
            positions=int(args.get("--positions", 500)),
            seed=int(args.get("--seed", 0)),
            device=device,
        )
    if "--generate2" in args:
        return generate_mate_in_2(
            args["--generate2"],
            positions=int(args.get("--positions", 200)),
            seed=int(args.get("--seed", 0)),
            device=device,
        )
    if args.get("--uniform", "false").lower() == "true":
        evaluate_fn = uniform_evaluate(Chess().num_actions)
        meta = {"steps": None}
        run_id = "uniform"
    else:
        from custom_alphazero_tpu_torch.tools.strength import load_run_model

        _, evaluate_fn, _, meta = load_run_model(
            args["--run_id"], args.get("--results_dir", "results"),
            args.get("--which", "best"), game="chess", device=device,
        )
        run_id = args["--run_id"]
    report = evaluate_tactics(
        evaluate_fn,
        args["--labels"],
        use_mcts=args.get("--mcts", "false").lower() == "true",
        sims=int(args.get("--sims", 64)),
        device=device,
    )
    report.update(run_id=run_id, steps=meta.get("steps"))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
