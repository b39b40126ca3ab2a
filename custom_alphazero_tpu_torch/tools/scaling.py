"""Data-parallel scaling benchmark: env-steps/s at 1 vs N ranks (the port of
tools/scaling.py).

Weak scaling of a self-play rollout: each rank plays its own
``per_device_games`` games with the general ``MCTS.search`` on a 2 x 32
net (search -> sample a move from the root visits -> step -> auto-reset),
so the work per rank is the same at every size; the ranks meet once per
rollout, in a barrier. The ranks are processes started by
``parallel/launch.py``, one per card (several on one card share it, and
then the figure says nothing about scaling across cards).

CLI:  python -m custom_alphazero_tpu_torch.tools.scaling \\
          [--per_device_games=256] [--sims=32] [--plies=8] [--devices=N] \\
          [--device=cpu]

Prints one JSON line per mesh size plus a final ``scaling_efficiency``
line (JAX's keys).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    ModelConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.parallel import distributed, launch
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.search.mcts import MCTS

RESULT = "SCALING "


def rollout_rank(per_device_games: int, sims: int, plies: int, iters: int,
                 device=None) -> None:
    """One rank's part of ``measure``: joins the process group, plays one
    warm-up rollout and ``iters`` timed ones; the coordinator prints the
    mean seconds per rollout (from the first barrier to the last)."""
    device = distributed.initialize(device)
    torch.set_num_threads(1)
    env = ConnectN(ConnectNConfig())
    model = ModelConfig(depth=2, filters=32, value_hidden=64,
                        compute_dtype="float32")
    state = init_train_state(env.num_actions, model,
                             torch.Generator(device=device).manual_seed(0),
                             env.obs_shape, device=device)
    evaluate = make_evaluate_fn(state.net)
    mcts = MCTS(env, MCTSConfig(simulations=sims))
    generator = torch.Generator(device=device).manual_seed(
        1 + distributed.rank())

    def rollout() -> float:
        states = fresh = env.init(per_device_games, device)
        for _ in range(plies):
            tree = mcts.search(states, evaluate, generator, sims)
            visits = mcts.root_child_visits(tree).float()
            weights = torch.where(visits.sum(-1, keepdim=True) > 0, visits,
                                  torch.ones_like(visits))
            actions = torch.multinomial(weights, 1, generator=generator)
            states, _ = env.step(states, actions[:, 0].to(torch.int32))
            states = fresh.where(env.is_terminal(states), states)
        return float(env.observe(states).sum())  # a tiny reduced output

    rollout()
    distributed.sync_hosts("warm-up")
    t0 = time.perf_counter()
    for _ in range(iters):
        rollout()
        distributed.sync_hosts("rollout")
    dt = (time.perf_counter() - t0) / iters
    if distributed.is_coordinator():
        print(RESULT + json.dumps({"seconds_per_rollout": dt}), flush=True)
    distributed.shutdown()


def measure(n_devices: int, per_device_games: int, sims: int, plies: int,
            device=None, iters: int = 3, timeout_s: float = 1800.0) -> dict:
    """Weak scaling at ``n_devices`` ranks: JAX's keys."""
    code = ("from custom_alphazero_tpu_torch.tools.scaling import "
            f"rollout_rank; rollout_rank({per_device_games}, {sims}, "
            f"{plies}, {iters}, {device!r})")
    outputs = launch.launch(n_devices, ["-c", code], timeout_s=timeout_s,
                            env={"OMP_NUM_THREADS": "1"})
    line = next(line for line in outputs[0].splitlines()
                if line.startswith(RESULT))
    dt = json.loads(line[len(RESULT):])["seconds_per_rollout"]
    games = n_devices * per_device_games
    return {
        "devices": n_devices,
        "env_steps_per_s": games * plies / dt,
        "sims_per_s": games * plies * sims / dt,
        "seconds_per_rollout": dt,
    }


def main(argv=None):
    args = dict(per_device_games=256, sims=32, plies=8, devices=0)
    device = None
    usage = ("usage: scaling " + " ".join(f"[--{k}=N]" for k in args)
             + " [--device=cpu]")
    for arg in (argv if argv is not None else sys.argv[1:]):
        key, eq, value = arg.lstrip("-").partition("=")
        if key == "device" and eq:
            device = value
            continue
        if key not in args or not eq or not value.isdigit():
            raise SystemExit(f"bad flag {arg!r} (--key=int only)\n{usage}")
        args[key] = int(value)
    n = args["devices"] or (torch.cuda.device_count() if device is None
                            else 1)
    r1 = measure(1, args["per_device_games"], args["sims"], args["plies"],
                 device)
    print(json.dumps(r1))
    if n > 1:
        rn = measure(n, args["per_device_games"], args["sims"],
                     args["plies"], device)
        print(json.dumps(rn))
        eff = rn["env_steps_per_s"] / (n * r1["env_steps_per_s"])
        print(json.dumps({
            "metric": "scaling_efficiency_env_steps",
            "value": round(eff, 4),
            "unit": f"1->{n} devices (weak scaling)",
            "vs_baseline": round(eff / 0.8, 4),
        }))


if __name__ == "__main__":
    main()
