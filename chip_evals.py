#!/usr/bin/env python3
"""Run the committed evaluation batteries with the PyTorch port on the card.

    python3 chip_evals.py [c4] [chess] [--out=results/evals]

Lays out a run of its own under ``results/`` for each battery, from the
committed runs (``results/connect_n/chip-evals-c4-r5``: c4-r5's config,
``iteration_11600`` and metrics; ``results/chess/chip-evals-chess-r5``:
chess-r5's config and ``iteration_2400``), then runs
``run_c4_r4_evals.sh chip-evals-c4-r5`` and
``run_chess_r5_evals.sh chip-evals-chess-r5`` with one change: the module
path ``custom_alphazero_tpu.tools`` becomes
``custom_alphazero_tpu_torch.tools`` (each command under bash's ``time``,
which prints its wall seconds). A run directory of that name that this
script did not lay out is left alone and the script exits non-zero. Each
battery's output goes to ``<out>/<battery>.log`` as it runs, headed by the
card's ``nvidia-smi`` name and power limit. Exits non-zero without CUDA, if
a battery fails, or outside a checkout of the repository.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(REPO, "artifacts")
# battery: (script, committed run, game, its promoted checkpoint)
BATTERIES = {
    "c4": ("run_c4_r4_evals.sh", "c4-r5", "connect_n", "iteration_11600"),
    "chess": ("run_chess_r5_evals.sh", "chess-r5", "chess", "iteration_2400"),
}
MARK = "LAID_OUT_BY_CHIP_EVALS"


def lay_out(source: str, game: str, checkpoint: str) -> str:
    """results/<game>/chip-evals-<source>/: the committed run's config,
    promoted checkpoint and metrics, as its training run left them, and
    a mark file; returns the run id. Raises if the directory exists
    without the mark (a run this script did not lay out)."""
    run = f"chip-evals-{source}"
    run_dir = os.path.join(REPO, "results", game, run)
    if os.path.exists(run_dir):
        if not os.path.exists(os.path.join(run_dir, MARK)):
            raise FileExistsError(f"{run_dir} exists and was not laid out "
                                  f"by chip_evals.py; move it away first")
        shutil.rmtree(run_dir)
    os.makedirs(os.path.join(run_dir, "tensorboard"))
    open(os.path.join(run_dir, MARK), "w").close()
    shutil.copy(os.path.join(ARTIFACTS, source, "config.json"), run_dir)
    shutil.copy(os.path.join(ARTIFACTS, source, "metrics.jsonl"),
                os.path.join(run_dir, "tensorboard"))
    shutil.copytree(os.path.join(ARTIFACTS, source, checkpoint),
                    os.path.join(run_dir, "evaluation", checkpoint))
    return run


def port_script(name: str) -> str:
    """The battery's script with the port's module path, every command
    timed by bash."""
    with open(os.path.join(REPO, name)) as fp:
        text = fp.read()
    text = text.replace("custom_alphazero_tpu.tools",
                        "custom_alphazero_tpu_torch.tools")
    return "TIMEFORMAT='wall %R s'\n" + "\n".join(
        "time " + line if line.startswith("python -m ") else line
        for line in text.splitlines()) + "\n"


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_evals: CUDA is not available", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    out_dir = next((a.split("=", 1)[1] for a in argv
                    if a.startswith("--out=")),
                   os.path.join(REPO, "results", "evals"))
    chosen = [a for a in argv if not a.startswith("--")] or list(BATTERIES)
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    failed = []
    for key in chosen:
        script, source, game, checkpoint = BATTERIES[key]
        run = lay_out(source, game, checkpoint)
        path = os.path.join(out_dir, f"{key}.log")
        t0 = time.perf_counter()
        with open(path, "w") as fp:
            fp.write(f"{card}\n{script} {run}, port modules\n")
            fp.flush()
            proc = subprocess.run(["bash", "-s", run], input=port_script(
                script), cwd=REPO, stdout=fp, stderr=subprocess.STDOUT,
                text=True)
            wall = time.perf_counter() - t0
            fp.write(f"exit {proc.returncode}, {wall:.1f} s\n")
        print(f"{key}: {script} {run} exited {proc.returncode} in "
              f"{wall:.1f} s -> {path}", flush=True)
        if proc.returncode != 0:
            failed.append(key)
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
