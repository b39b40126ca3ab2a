"""Training step + state (the port of runtime/train.py).

One gradient step of the policy-value net: soft cross-entropy + value MSE +
L2 on the kernels, optional auxiliary terms on a labelled set, then the
clip and the SGD-momentum update of models/losses.py. (The leaf-evaluation
closure ``make_evaluate_fn`` of the JAX module lives in runtime/evaluate.py.)

Where the JAX step is a pure function of a state pytree, this one trains the
state's net **in place**: parameters, momentum and BatchNorm running
statistics keep their memory, so a CUDA graph that reads them (the arena's
search) stays valid across steps. The step count lives on the host, where
the learning-rate schedule reads it; the loss terms stay on the device.
Outside a step the net is in eval mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from custom_alphazero_tpu_torch.config import ModelConfig, resolve_device
from custom_alphazero_tpu_torch.models.losses import (
    clip_by_global_norm,
    kernel_parameters,
    l2_penalty,
    learning_rate,
    policy_loss,
    sgd_momentum_update,
    value_loss,
)
from custom_alphazero_tpu_torch.models.policy_value import PolicyValueNet
from custom_alphazero_tpu_torch.parallel.distributed import all_reduce
from custom_alphazero_tpu_torch.parallel.mesh import (
    shard_owners,
    sharded_square_sum,
)


@dataclass
class TrainState:
    net: PolicyValueNet        # parameters and BatchNorm running statistics
    trace: List[torch.Tensor]  # momentum, one per net.parameters() entry
    steps: int = 0             # cumulative optimizer steps


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    l2: torch.Tensor
    learning_rate: float  # read at the step count before the update
    steps: int            # the step count after it
    solver_value_loss: Any = 0.0   # auxiliary exact-value MSE (0 when off)
    solver_policy_loss: Any = 0.0  # auxiliary labelled-policy CE (0 when off)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in (drawn by inverting the normal CDF)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty_like(weight).uniform_(lo, 1.0 - lo, generator=generator)
    draw = torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)
    weight.copy_(draw.clamp_(-2.0 * std, 2.0 * std))


def new_train_state(net: PolicyValueNet) -> TrainState:
    """``net`` with zero momentum at step 0."""
    return TrainState(net=net.eval(),
                      trace=[torch.zeros_like(p) for p in net.parameters()])


def init_train_state(num_actions: int, cfg: ModelConfig,
                     generator: torch.Generator, obs_shape,
                     device=None) -> TrainState:
    """A freshly initialised net (Flax's initialisers: truncated-normal
    kernels of variance 1 / fan_in, zero biases, unit BatchNorm scales) with
    zero momentum. ``generator`` lives on ``device``."""
    device = resolve_device(device)
    h, w, c = obs_shape
    net = PolicyValueNet(num_actions, cfg, c, (h, w)).to(device)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
                _lecun_normal_(module.weight, generator)
                if module.bias is not None:  # a pooled bias's dense has none
                    module.bias.zero_()
    return new_train_state(net)


def _average(net, grads, terms, mesh):
    """Gradients and loss terms averaged over the mesh's ranks, as one
    program over the global batch computes them (local batches are equal):
    one flat all-reduce over the mesh for the replicated leaves and the
    terms (the ranks of a data row hold equal copies of them), one over the
    data group for a sharded layer's rows."""
    owners = shard_owners(net)
    params = list(net.parameters())
    whole = [i for i, p in enumerate(params) if id(p) not in owners]
    shards = [i for i, p in enumerate(params) if id(p) in owners]
    out = list(grads)

    def mean(indices, tail, group, ranks):
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in indices]
                                    + [tail]), group) / ranks
        pieces = flat.split([grads[i].numel() for i in indices]
                            + [tail.numel()])
        for i, piece in zip(indices, pieces):
            out[i] = piece.view_as(grads[i])
        return pieces[-1]

    terms = mean(whole, terms, mesh.group, mesh.size)
    if shards and mesh.dp > 1:
        mean(shards, terms[:0], mesh.data_group, mesh.dp)
    return out, terms


def make_train_step(
    cfg: ModelConfig, aux_value_weight: float = 0.0,
    aux_value_batch: int = 256, aux_policy_weight: float = 0.0,
    mesh=None,
) -> Callable[..., Tuple[TrainState, TrainMetrics]]:
    """Build ``train_step(state, obs, target_pi, target_z, generator=None,
    aux_obs=None, aux_z=None, aux_pi=None, aux_indices=None)``.

    With ``aux_value_weight > 0`` the step adds ``weight * MSE(value(rows),
    aux_z[rows])`` on a fresh subset of the labelled arrays, drawn uniformly
    **with** replacement from ``generator`` (``aux_indices`` overrides the
    draw); with ``aux_policy_weight > 0`` the same subset adds ``weight *
    CE(policy(rows), aux_pi[rows])``. The auxiliary forward runs in eval
    mode on the same parameters: gradients flow through it, and it leaves
    the BatchNorm running statistics alone.

    With a ``mesh`` of more than one rank (parallel/mesh.py) the step is
    the data-parallel one: ``obs`` is this rank's share of the global
    batch, the net's BatchNorm layers reduce over the data group
    (``policy_value.data_parallel``), gradients and loss terms are averaged
    over the ranks, and the returned terms are the global ones; the
    auxiliary rows must be the same on every rank. A sharded layer's part
    of the L2 term and of the clip's norm is summed over the model
    group."""
    use_aux = aux_value_weight > 0.0 or aux_policy_weight > 0.0

    def train_step(state: TrainState, obs, target_pi, target_z,
                   generator: Optional[torch.Generator] = None,
                   aux_obs=None, aux_z=None, aux_pi=None, aux_indices=None):
        net = state.net
        params = list(net.parameters())
        # The aux forward comes first: it must see the running statistics
        # as they were before this step's update of them.
        laux = laux_pi = torch.zeros((), device=obs.device)
        if use_aux:
            n = aux_obs.shape[0]
            if aux_indices is None:
                aux_indices = torch.randint(
                    0, n, (min(n, aux_value_batch),), generator=generator,
                    device=aux_obs.device)
            aux_logits, aux_value = net.eval()(aux_obs[aux_indices])
            if aux_value_weight > 0.0:
                laux = value_loss(aux_value, aux_z[aux_indices])
            if aux_policy_weight > 0.0:
                laux_pi = policy_loss(aux_logits, aux_pi[aux_indices])
        logits, value = net.train()(obs)
        net.eval()
        lp = policy_loss(logits, target_pi)
        lv = value_loss(value, target_z)
        l2 = l2_penalty(kernel_parameters(net), cfg.l2)
        shard_sq = (sharded_square_sum(net, params) if mesh is not None
                    else None)
        if shard_sq is not None:
            # The other shards' part of the value; the gradient is local.
            l2 = l2 + cfg.l2 * (all_reduce(shard_sq.detach().clone(),
                                           mesh.model_group)
                                - shard_sq.detach())
        loss = (lp + lv + l2 + aux_value_weight * laux
                + aux_policy_weight * laux_pi)
        grads = torch.autograd.grad(loss, params)
        terms = (loss, lp, lv, l2, laux, laux_pi)
        if mesh is not None and mesh.size > 1:
            grads, terms = _average(net, grads, torch.stack(terms).detach(),
                                    mesh)
            terms = terms.unbind()
        if cfg.grad_clip_norm > 0:
            norm = None
            if shard_sq is not None:
                sq = [g.square().sum() for g in grads]
                shard = sharded_square_sum(net, grads)
                norm = torch.sqrt(sum(sq) - shard + all_reduce(
                    shard.clone(), mesh.model_group))
            grads = clip_by_global_norm(grads, cfg.grad_clip_norm, norm)
        lr = learning_rate(cfg, state.steps)
        sgd_momentum_update(params, state.trace, grads, lr, cfg.momentum)
        state.steps += 1
        loss, lp, lv, l2, laux, laux_pi = (t.detach() for t in terms)
        metrics = TrainMetrics(
            loss=loss, policy_loss=lp, value_loss=lv, l2=l2,
            learning_rate=lr, steps=state.steps, solver_value_loss=laux,
            solver_policy_loss=laux_pi,
        )
        return state, metrics

    return train_step
