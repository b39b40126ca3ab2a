"""What the drivers share: the program's Learner with the configuration's
weights, the reference's view of the same weights, and the program state a
check follows."""

from __future__ import annotations

import numpy as np
import torch

from azbench.reference import msgpack_reader
from azbench.reference import net as ref_net


def learner(run):
    """The port's ``Learner`` for the cell's configuration on the run's
    device, with the configuration's weights (parameters, running
    statistics, momentum and step count) in the candidate, promoted to the
    best net that self-play searches with."""
    from custom_alphazero_tpu_torch.io.checkpoint import load_checkpoint
    from custom_alphazero_tpu_torch.runtime.loop import Learner

    cfg = run.program_config()
    lrn = Learner(cfg, device=run.device)
    weights = run.config.get("weights")
    if weights:
        tree, _ = load_checkpoint(run.path(weights))
        lrn.load_train_state(tree)
        lrn.promote()
    return lrn


def reference_weights(run, device):
    """(params, stats, momentum, steps) of the configuration's weights as the
    reference reads them from the checkpoint file: flat Flax-layout
    tensors on ``device``."""
    tree = msgpack_reader.read_checkpoint(run.path(run.config["weights"]))
    params = ref_net.to_device(ref_net.flatten(tree["params"]), device)
    stats = ref_net.to_device(ref_net.flatten(tree["batch_stats"]), device)
    opt = tree["opt_state"]
    sgd = opt if "trace" in opt["0"] else opt["1"]
    trace = ref_net.to_device(ref_net.flatten(sgd["0"]["trace"]), device)
    return params, stats, trace, int(np.asarray(tree["steps"]))


def reference_evaluator(params, stats, depth: int, device, quantize=None):
    """The reference net as a search's evaluator: numpy observations ->
    numpy (probabilities, values), float32 with TF32 off."""
    def evaluate(obs: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(device)
        probs, values = ref_net.evaluate(params, stats, x, depth,
                                         quantize=quantize)
        return probs.cpu().numpy(), values.cpu().numpy()
    return evaluate


def strict_float32() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fused_search(fn):
    """The fused Connect-4 search object a self-play function closes over
    (None if it has none), found through the closures: the program state
    whose last search's root-noise draws the selfplay check follows."""
    seen = set()
    stack = [fn]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if type(obj).__name__ == "FusedConnectNSearchV2":
            return obj
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                stack.append(cell.cell_contents)
            except ValueError:  # an empty cell
                pass
    return None
