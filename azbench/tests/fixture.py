"""A tiny benchmark root for the harness tests: the repo's BENCHMARK.json
with a tiny Connect-4 configuration (a float32 net of one block of 8
filters, 8 simulations, 8 games) and a cell of it per traffic mix, its
weights written by the port from a seeded random init. Everything runs on
the CPU in seconds."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_CELLS = {"tiny-selfplay": "selfplay", "tiny-train": "train"}

# The c4-r5 train cell, ready in files (driver, traffic, limits, readers)
# but not in BENCHMARK.json (PERF.md, section 7): its workload entry.
TRAIN_CELL = {"name": "c4r5-train", "config": "c4-r5", "traffic": "train",
              "chips": 1, "why": "replay_sample + train_step"}


def tiny_config() -> dict:
    with open(os.path.join(REPO, "azbench", "configs", "c4-r5.json")) as fp:
        cfg = json.load(fp)["config"]
    cfg["model"].update(depth=1, filters=8, value_hidden=16, batch_size=64,
                        compute_dtype="float32")
    cfg["mcts"].update(simulations=8, greedy_from_move=6)
    cfg["self_play"].update(games_per_generation=8)
    cfg["replay"].update(capacity=2000, min_size=64)
    cfg["loop"].update(solver_value_batch=16)
    cfg["loop"]["solver_labels_path"] = os.path.join(
        REPO, cfg["loop"]["solver_labels_path"])
    return cfg


def write_weights(path: str, cfg: dict, seed: int = 3) -> None:
    """A seeded random init of ``cfg``'s net, saved as a checkpoint with a
    random momentum, by the port."""
    import torch

    from custom_alphazero_tpu_torch.config import from_json
    from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
    from custom_alphazero_tpu_torch.io.checkpoint import save_checkpoint
    from custom_alphazero_tpu_torch.models.convert import train_state_to_jax
    from custom_alphazero_tpu_torch.runtime.train import init_train_state

    config = from_json(json.dumps(cfg))
    env = ConnectN(config.connect_n)
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(env.num_actions, config.model, gen,
                             env.obs_shape, device="cpu")
    with torch.no_grad():
        for t in state.trace:
            t.copy_(torch.randn(t.shape, generator=gen) * 1e-3)
        for module in state.net.modules():
            if hasattr(module, "running_var"):
                module.running_mean.copy_(
                    torch.randn(module.running_mean.shape, generator=gen)
                    * 0.1)
                module.running_var.copy_(
                    1 + torch.rand(module.running_var.shape, generator=gen))
    state.steps = 11600
    save_checkpoint(path, train_state_to_jax(state, config.model), 2.5e-4)


def tiny_root(tmp: str) -> str:
    """Lay out a benchmark root under ``tmp`` and return it."""
    root = os.path.join(tmp, "root")
    bench_dir = os.path.join(root, "azbench")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "azbench", sub),
                        os.path.join(bench_dir, sub))
    os.makedirs(os.path.join(bench_dir, "configs"))
    os.makedirs(os.path.join(bench_dir, "limits"))
    cfg = tiny_config()
    write_weights(os.path.join(root, "weights"), cfg)
    with open(os.path.join(bench_dir, "configs", "tiny-c4.json"), "w") as fp:
        json.dump({"name": "tiny-c4", "weights": "weights", "config": cfg},
                  fp)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "tiny-c4", "source": "test",
                             "file": "azbench/configs/tiny-c4.json",
                             "reduced": [], "why": "test"})
    for cell, traffic in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny-c4",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            real = "c4r5-" + cell.split("-")[1]
            if real in metric.get("workloads", ()):
                metric["workloads"].append(cell)
        with open(os.path.join(REPO, "azbench", "limits",
                               "c4r5-" + cell.split("-")[1] + ".json")) as fp:
            lim = json.load(fp)
        with open(os.path.join(bench_dir, "limits", cell + ".json"),
                  "w") as fp:
            json.dump(lim, fp)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)
    return root
