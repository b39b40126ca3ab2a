"""Serve the best model of a run over HTTP (the port of serving/__main__.py).

    python -m custom_alphazero_tpu_torch.serving --run.run_id=<id> \
        [--serving.port=5555] [--serving.inference_batch_size=8] \
        [--serving.host=0.0.0.0] [--serving.inference_timeout=0.05] \
        [--device=cpu] [--key=value ...]

Loads the newest promoted lineage checkpoint (evaluation/iteration_N), or
else the training checkpoint, or else serves a random init with a warning;
a run written by either package loads. The net is the port's
``PolicyValueNet`` on the card (``--device=cpu`` for the CPU), in the
config's compute dtype. ``best-model/update`` builds a new net from the
newest lineage on disk and swaps it in between batches: a net that serving
threads are using is never written. ``--serving.port=0`` binds a free port;
the printed line carries the bound one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_alphazero_tpu_torch import paths
from custom_alphazero_tpu_torch.config import (
    Config,
    apply_overrides,
    parse_cli_overrides,
    resolve_device,
)
from custom_alphazero_tpu_torch.io.checkpoint import (
    checkpoint_exists,
    latest_evaluation_iteration,
    load_checkpoint,
)
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.loop import make_env
from custom_alphazero_tpu_torch.runtime.train import init_train_state
from custom_alphazero_tpu_torch.serving.server import InferenceService


def build_service(cfg: Config, host: str = "0.0.0.0", port: int = 5555,
                  batch_size: int = 1, timeout: float = 0.05,
                  device=None) -> InferenceService:
    """An unstarted service for ``cfg.run``'s best model on ``device``
    (None = the card)."""
    device = resolve_device(device)
    env = make_env(cfg)
    results_dir, game = cfg.run.results_dir, cfg.game
    run_id = cfg.run.run_id or paths.new_run_id()
    channels, board_hw = env.obs_shape[-1], tuple(env.obs_shape[:2])

    def load_best():
        """Newest lineage > training checkpoint > random init (warned)."""
        lineage = latest_evaluation_iteration(
            paths.evaluation_path(results_dir, game, run_id))
        training = paths.training_path(results_dir, game, run_id)
        tree = None
        if lineage is not None:
            tree, _ = load_checkpoint(lineage[1])
            print(f"Serving best model from iteration {lineage[0]}")
        elif checkpoint_exists(training):
            tree, _ = load_checkpoint(training)
            print("Serving last training checkpoint (no promotion yet)")
        else:
            print("WARNING: no checkpoint found — serving random weights "
                  "(reference utils.py:56-60)")
        if tree is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(cfg.run.seed)
            net = init_train_state(env.num_actions, cfg.model, generator,
                                   env.obs_shape, device=device).net
        else:
            net = from_jax_variables(tree["params"], tree["batch_stats"],
                                     env.num_actions, cfg.model, channels,
                                     board_hw, device=device)
        # Inference mode and autocast are set inside each call: serving
        # threads run forwards at the same time.
        evaluate = make_evaluate_fn(net)

        def evaluate_np(states):
            obs = torch.from_numpy(np.asarray(states, np.float32)).to(device)
            probs, values = evaluate(obs)
            return probs.cpu().numpy(), values.cpu().numpy()

        return evaluate_np

    return InferenceService(
        load_best(),
        host=host,
        port=port,
        inference_batch_size=batch_size,
        inference_timeout=timeout,
        reload_model=load_best,
        run_id=run_id,
    )


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    extras = {"serving.host": "0.0.0.0", "serving.port": "5555",
              "serving.inference_batch_size": "1",
              "serving.inference_timeout": "0.05", "device": None}
    cfg_args = []
    for arg in args:
        key, eq, value = arg.lstrip("-").partition("=")
        if key in extras:
            if not eq:
                raise SystemExit(
                    f"Expected --{key}=value (space-separated form is not "
                    f"supported), got {arg!r}"
                )
            extras[key] = value
        else:
            cfg_args.append(arg)
    cfg = apply_overrides(Config(), parse_cli_overrides(cfg_args))
    service = build_service(
        cfg,
        host=extras["serving.host"],
        port=int(extras["serving.port"]),
        batch_size=int(extras["serving.inference_batch_size"]),
        timeout=float(extras["serving.inference_timeout"]),
        device=extras["device"],
    )
    print(f"Serving run {service.run_id} on "
          f"http://{service.host}:{service.port}/api", flush=True)
    service.start()
    try:
        service._thread.join()
    except KeyboardInterrupt:
        service.stop()


if __name__ == "__main__":
    main()
