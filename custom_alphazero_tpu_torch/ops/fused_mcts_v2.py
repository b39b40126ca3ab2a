"""Fused Connect-N search, (games, actions, nodes) layout, on the card.

The port of custom_alphazero_tpu/ops/fused_mcts_v2.py. One search runs
``simulations + 1`` software-pipelined waves; each wave is one step and one
net forward. A step (``wave_step``: the CUDA kernel csrc/fused_mcts_v2.cu
on the card, ``wave_step_reference`` for CPU tensors)

1. builds the legal mask of the previous wave's leaf from its board's top
   row and ``leaf_terminal``, and renormalises the net's priors with it;
2. captures the root prior at wave 1 and mixes in this wave's root noise;
3. runs the wave: phase A expands and backs up the previous leaf, phase B
   selects and creates this wave's leaf;
4. observes the new leaf board for the net.

In the JAX package steps 1, 2 and 4 are XLA ops that ``jit`` fuses around
the Pallas wave kernel inside one ``fori_loop``. Here they are part of the
kernel, the wave index lives on the device, and the search replays one
captured CUDA graph (step + net) per wave, so the host does no per-wave
work. The plain version composes the separate pieces (``wave_inputs``,
``wave_plain``, ``observe_board``), which stay the CPU path and what the
tests hold against JAX.

The last (drain) wave only backs up; its net forward would be unused and
is skipped. The carry keeps the JAX kernel's float32 arrays, so every carry
array can be compared bit for bit across the three implementations.

The v1 search (ops/fused_mcts.py, kernel K2) runs this search loop, plain
step (``wave_step_plain``) and launcher (``launch``) on its own carry
layout.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from custom_alphazero_tpu_torch.config import MCTSConfig, resolve_device
from custom_alphazero_tpu_torch.envs.connect_n import (
    ConnectN,
    ConnectNState,
    has_line,
)
from custom_alphazero_tpu_torch.io import trace
from custom_alphazero_tpu_torch.ops import _build, fused_net
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn
from custom_alphazero_tpu_torch.search.mcts import (
    MCTS,
    renormalize,
    root_noisy_prior,
)

_CONTINUE = 0
_NEW = 1
_UNEXPANDED = 2
_TERMINAL = 3

_PH = 8
_PW = 8
_CELLS = _PH * _PW  # 64
# Waves run on a side stream before a capture, so that the libraries under
# the evaluator have made their one-time choices and allocations.
WARMUP_WAVES = 3


class Carry(NamedTuple):
    prior: torch.Tensor          # (B, A, N)
    children: torch.Tensor       # (B, A, N)
    visits: torch.Tensor         # (B, A, N)
    value_sum: torch.Tensor      # (B, A, N)
    parent: torch.Tensor         # (B, N)
    parent_action: torch.Tensor  # (B, N)
    expanded: torch.Tensor       # (B, N)
    is_terminal: torch.Tensor    # (B, N)
    reward: torch.Tensor         # (B, N)
    node_count: torch.Tensor     # (B, 1)
    leaf: torch.Tensor           # (B, 1)
    leaf_terminal: torch.Tensor  # (B, 1)


class WaveGeometry(NamedTuple):
    height: int
    width: int
    n_in_row: int
    c_puct: float
    simulations: int
    noise_fraction: float = 0.0  # weight of the root noise, where drawn


class StepBuffers(NamedTuple):
    """What a step reads and writes beside the carry. Boards are (B, 64)
    here and (B, 8, 8) in the v1 search: the same bytes."""

    probs: torch.Tensor       # (B, A) in: the net's priors of the last leaf
    value: torch.Tensor       # (B, 1) in: the net's value of the last leaf
    gamma: Optional[torch.Tensor]  # (S, B, A) in: root-noise draws, or None
    root_board: torch.Tensor  # in: padded root boards
    root_prior: torch.Tensor  # (B, A) in/out: captured at wave 1
    leaf_board: torch.Tensor  # in/out: the last leaf's board, then this one's
    path: torch.Tensor        # (B, P) int32 in/out: [:, 0] edges on the
    #                           leaf's path, then node * A + action of each
    counter: torch.Tensor     # (2,) int32 in/out: the wave index; the
    #                           kernel's count of finished blocks
    renormed: torch.Tensor    # (B, A) out
    mixed: torch.Tensor       # (B, A) out
    obs: torch.Tensor         # (B, H, W, 4) out: what the net reads


def path_stride(geom: WaveGeometry, num_nodes: int) -> int:
    """Row length of ``StepBuffers.path``: the count and one entry for each
    edge of the deepest possible path."""
    return 1 + min(num_nodes, geom.height * geom.width + 1)


def new_buffers(bsz: int, num_actions: int, geom: WaveGeometry, noise: bool,
                device, board_shape=(_CELLS,)) -> StepBuffers:
    """Zeroed step buffers of a search of ``geom.simulations`` waves."""

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    a, sims = num_actions, geom.simulations
    return StepBuffers(
        probs=zeros(bsz, a), value=zeros(bsz, 1),
        gamma=zeros(sims, bsz, a) if noise else None,
        root_board=zeros(bsz, *board_shape), root_prior=zeros(bsz, a),
        leaf_board=zeros(bsz, *board_shape),
        path=zeros(bsz, path_stride(geom, sims + 1), dtype=torch.int32),
        counter=zeros(2, dtype=torch.int32),
        renormed=zeros(bsz, a), mixed=zeros(bsz, a),
        obs=zeros(bsz, geom.height, geom.width, 4),
    )


def supports(env, cfg: MCTSConfig) -> bool:
    """True if the fused search can run this (env, search config)."""
    return (
        isinstance(env, ConnectN)
        and env.cfg.gravity
        and env.cfg.height <= _PH
        and env.cfg.width <= _PW
        and not cfg.max_nodes
    )


# ---------------------------------------------------------------------------
# The plain PyTorch version of the wave
# ---------------------------------------------------------------------------

def _place(board, heights, action, height: int):
    """Stone of the (B,) ``action`` columns onto (B, 64) boards: the board
    plus a one-hot cell (every cell gets + 0.0, as in the TPU kernel), and
    the column heights plus one."""
    batch = torch.arange(board.shape[0], device=board.device)
    h_col = heights[batch, action]
    row = ((height - 1.0) - h_col).clamp(0.0, height - 1.0)
    cell = (row * _PW + action).long()
    onehot = torch.zeros_like(board)
    onehot[batch, cell] = 1.0
    hot = torch.zeros_like(heights)
    hot[batch, action] = 1.0
    return board + onehot, heights + hot


def _has_line_padded(mover: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) n-in-a-row on flat padded boards: window sums E, S, SE, SW."""
    best = torch.zeros(mover.shape[0], device=mover.device)
    for d in (1, _PW, _PW + 1, _PW - 1):
        span = (k - 1) * d
        wsum = mover[:, 0:_CELLS - span]
        for i in range(1, k):
            wsum = wsum + mover[:, i * d:_CELLS - span + i * d]
        best = torch.maximum(best, wsum.max(dim=1).values)
    return best > k - 0.5


def wave_reference(wave: int, mixed, renormed, value, root_board,
                   carry: Carry, geom: WaveGeometry):
    """One wave in plain PyTorch: updates ``carry`` in place (the TPU
    kernel aliases it) and returns ``(carry, leaf_board)``."""
    leaf_board = wave_plain(wave, mixed, renormed, value, root_board, carry,
                            geom, v1_rules=False)
    return carry, leaf_board


def wave_plain(wave: int, mixed, renormed, value, root_board, carry: Carry,
               geom: WaveGeometry, v1_rules: bool,
               path: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wave of both fused searches, in plain PyTorch, on a carry whose
    edge arrays are (B, A, N) (views are fine: they are updated in place).
    Returns the (B, 64) leaf board.

    path: optional (B, P) int32 record of the descent, updated in place:
    ``path[:, 0]`` the number of edges from the root to the new leaf, then
    ``node * A + action`` of each edge, the created one last. The kernel
    backs the next wave up along it; here the backup follows the parent
    chain, which visits the same edges.

    v1_rules: the v1 kernel's two differences. Its argmax runs over the
    whole (N*A) edge range, so a node row with every action masked reads
    the child of edge 0 (node 0, action 0), not of the node's action 0.
    And it counts lines on the H x W board, where the v2 kernel counts them
    in flat windows of the padded 64 cells. Neither changes a search: a
    masked row is only met at a terminal or unexpanded node, whose child is
    never followed, and on a board narrower than 8 columns no flat window
    crosses a row edge without crossing the empty padding column."""
    (prior, children, visits, value_sum, parent, parent_action, expanded,
     is_terminal, reward, node_count, leaf, leaf_terminal) = carry
    bsz, a, n = prior.shape
    dev = prior.device
    batch = torch.arange(bsz, device=dev)

    # ---- phase A: expand + backup previous leaf ----------------------------
    if wave > 0:
        li = leaf[:, 0].long()
        leaf_term = leaf_terminal[:, 0] > 0.0
        do = ~(expanded[batch, li] > 0.0) & ~leaf_term
        rows, cols = batch[do], li[do]
        prior[rows, :, cols] = renormed[do]
        expanded[rows, cols] = 1.0
        bvalue = torch.where(leaf_term, reward[batch, li], -value[:, 0])
        bnode = li
        for _ in range(n):
            active = bnode > 0
            if not bool(active.any()):
                break
            p = parent[batch, bnode].long()
            pa = parent_action[batch, bnode].long()
            rows = batch[active]
            visits[rows, pa[active], p[active]] += 1.0
            value_sum[rows, pa[active], p[active]] += bvalue[active]
            bnode = torch.where(active, p, bnode)
            bvalue = -bvalue

    if wave >= geom.simulations:  # drain wave: no select
        return torch.zeros_like(root_board)

    # ---- phase B: select + create ------------------------------------------
    board = root_board.clone()
    heights = board.abs().view(bsz, _PH, _PW).sum(dim=1)  # (B, 8)
    full = heights.sum(dim=1)

    # Per-wave PUCT argmax of every node (stats are frozen within a wave).
    prior_eff = prior.clone()
    prior_eff[:, :, 0] = mixed
    q = value_sum / visits.clamp_min(1.0)
    sum_nv = visits.sum(dim=1, keepdim=True)
    u = geom.c_puct * prior_eff * torch.sqrt(sum_nv) / (1.0 + visits)
    neg_inf = torch.finfo(torch.float32).min
    score = torch.where(prior_eff > 0.0, q + u, neg_inf)
    best_a = score.argmax(dim=1)  # (B, N), first maximum
    child_best = children.gather(1, best_a[:, None, :])[:, 0, :]
    if v1_rules:
        masked = score.max(dim=1).values == neg_inf
        child_best = torch.where(masked, children[:, :1, 0], child_best)

    node = torch.zeros(bsz, dtype=torch.long, device=dev)
    action = torch.zeros(bsz, dtype=torch.long, device=dev)
    code = torch.full((bsz,), _CONTINUE, dtype=torch.long, device=dev)
    depth = torch.zeros(bsz, dtype=torch.long, device=dev)
    for _ in range(n):
        cont = code == _CONTINUE
        if not bool(cont.any()):
            break
        best = best_a[batch, node]
        child = child_best[batch, node]
        node_term = is_terminal[batch, node] > 0.0
        node_exp = expanded[batch, node] > 0.0
        new_code = torch.where(
            ~cont, code,
            torch.where(
                node_term, _TERMINAL,
                torch.where(~node_exp, _UNEXPANDED,
                            torch.where(child == -1.0, _NEW, _CONTINUE)),
            ),
        )
        action = torch.where(cont, best, action)
        descend = new_code == _CONTINUE
        placed, new_heights = _place(board, heights, action, geom.height)
        board = torch.where(descend[:, None], -placed, board)
        heights = torch.where(descend[:, None], new_heights, heights)
        full = torch.where(descend, full + 1.0, full)
        if path is not None:
            rows = batch[descend]
            path[rows, 1 + depth[descend]] = (
                node[descend] * a + action[descend]).int()
        depth = depth + descend.long()
        node = torch.where(descend, child.long(), node)
        code = new_code

    # CREATE
    slot = node_count[:, 0].clone()
    new = (code == _NEW) & (slot < float(n))
    placed, _ = _place(board, heights, action, geom.height)
    if v1_rules:
        core = placed.view(bsz, _PH, _PW)[:, :geom.height, :geom.width]
        win = has_line(core == 1.0, geom.n_in_row)
    else:
        win = _has_line_padded((placed == 1.0).float(), geom.n_in_row)
    filled = full + 1.0 >= float(geom.height * geom.width)
    child_term = win | filled

    rows, slots = batch[new], slot[new].long()
    parent[rows, slots] = node[new].float()
    parent_action[rows, slots] = action[new].float()
    children[rows, action[new], node[new]] = slot[new]
    is_terminal[rows, slots] = child_term[new].float()
    reward[rows, slots] = win[new].float()
    node_count += new.float()[:, None]
    if path is not None:
        path[rows, 1 + depth[new]] = (node[new] * a + action[new]).int()
        path[:, 0] = (depth + new.long()).int()

    node_term = is_terminal[batch, node] > 0.0
    leaf[:, 0] = torch.where(new, slot, node.float())
    leaf_terminal[:, 0] = torch.where(new, child_term, node_term).float()
    return torch.where(new[:, None], -placed, board)


# ---------------------------------------------------------------------------
# The step: wave inputs + wave + observation
# ---------------------------------------------------------------------------

def padded_board(board: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int boards -> (B, 64) float32, 8x8 zero padded."""
    bsz, h, w = board.shape
    out = torch.zeros((bsz, _PH, _PW), dtype=torch.float32,
                      device=board.device)
    out[:, :h, :w] = board.float()
    return out.view(bsz, _CELLS)


def observe_board(leaf_board: torch.Tensor, height: int,
                  width: int) -> torch.Tensor:
    """(B, 64) padded boards -> (B, H, W, 4) observations."""
    core = leaf_board.view(-1, _PH, _PW)[:, :height, :width]
    return torch.stack(
        [(core == 0).float(), (core == 1).float(), (core == -1).float(),
         torch.ones_like(core)],
        dim=-1,
    )


def wave_inputs(mcts_wave: int, geom: WaveGeometry, leaf_board,
                leaf_terminal, probs, root_prior, root_live, gamma):
    """(renormed, mixed, root_prior) for one wave: the legal mask of the
    previous leaf, renormalised priors, the root prior captured at wave 1,
    and the root mix with this wave's (B, A) gamma draw (None: no noise;
    the drain wave selects nothing, so its root mix is never read)."""
    legal = (leaf_board[:, :geom.width] == 0) & (leaf_terminal == 0)
    renormed = renormalize(probs, legal)
    if mcts_wave == 1:
        root_prior = torch.where(root_live[:, None], renormed, root_prior)
    if gamma is not None and mcts_wave < geom.simulations:
        mixed = root_noisy_prior(root_prior, gamma, geom.noise_fraction)
    else:
        mixed = root_prior
    return renormed, mixed, root_prior


def wave_step_plain(buffers: StepBuffers, carry: Carry, geom: WaveGeometry,
                    v1_rules: bool) -> None:
    """One step of both fused searches in plain PyTorch: ``wave_inputs``,
    ``wave_plain`` and ``observe_board`` on the buffers of the kernel,
    updated in place like the carry ((B, A, N) edge arrays or views)."""
    wave = int(buffers.counter[0])
    bsz = buffers.probs.shape[0]
    leaf_board = buffers.leaf_board.view(bsz, _CELLS)
    noisy = buffers.gamma is not None and wave < geom.simulations
    renormed, mixed, root_prior = wave_inputs(
        wave, geom, leaf_board, carry.leaf_terminal, buffers.probs,
        buffers.root_prior, ~(carry.is_terminal[:, 0] > 0.0),
        buffers.gamma[wave] if noisy else None,
    )
    new_leaf_board = wave_plain(
        wave, mixed, renormed, buffers.value,
        buffers.root_board.view(bsz, _CELLS), carry, geom, v1_rules,
        path=buffers.path,
    )
    buffers.renormed.copy_(renormed)
    buffers.mixed.copy_(mixed)
    buffers.root_prior.copy_(root_prior)
    leaf_board.copy_(new_leaf_board)
    buffers.obs.copy_(observe_board(new_leaf_board, geom.height, geom.width))
    buffers.counter[0] += 1


def wave_step_reference(buffers: StepBuffers, carry: Carry,
                        geom: WaveGeometry) -> None:
    """The plain PyTorch version of kernel K1's step."""
    wave_step_reference.calls += 1
    wave_step_plain(buffers, carry, geom, v1_rules=False)


wave_step_reference.calls = 0


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_KERNELS = {}


def _kernel(name: str):
    """The C entry point ``<name>_wave`` of csrc/<name>.cu, built and loaded
    on first use."""
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_wave")
        fn.argtypes = (
            [ctypes.c_void_p] * (len(StepBuffers._fields) + len(Carry._fields))
            + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(name: str, buffers: StepBuffers, carry, geom: WaveGeometry,
           edge_shape) -> None:
    """Check the step's tensors and launch kernel ``name`` on CUDA tensors
    (any other device raises). The buffers and the carry, with edge arrays
    of ``edge_shape``, are updated in place."""
    device = buffers.root_board.device
    if device.type != "cuda":
        raise ValueError(f"no wave kernel for device {device}")
    bsz, n = carry.parent.shape
    a = buffers.probs.shape[-1]
    if a > _PW or a != geom.width:
        raise ValueError(f"the wave kernel takes one action per column, at "
                         f"most {_PW}; got {a} actions, width {geom.width}")
    # The boards are (B, 64) or (B, 8, 8): the same bytes, row-major.
    board_shape = ((bsz, _CELLS) if buffers.root_board.dim() == 2
                   else (bsz, _PH, _PW))
    stride = path_stride(geom, n)
    shapes = dict(
        probs=(bsz, a), value=(bsz, 1), gamma=(geom.simulations, bsz, a),
        root_board=board_shape, root_prior=(bsz, a), leaf_board=board_shape,
        path=(bsz, stride), counter=(2,), renormed=(bsz, a), mixed=(bsz, a),
        obs=(bsz, geom.height, geom.width, 4),
    )
    ptrs = []
    for label, t in zip(StepBuffers._fields, buffers):
        if t is None:  # gamma: no root noise
            ptrs.append(None)
            continue
        dtype = torch.int32 if label in ("path", "counter") else torch.float32
        _check(label, t, shapes[label], device, dtype)
        ptrs.append(t.data_ptr())
    carry_shapes = [edge_shape] * 4 + [(bsz, n)] * 5 + [(bsz, 1)] * 3
    for label, t, shape in zip(Carry._fields, carry, carry_shapes):
        _check(label, t, shape, device)
        ptrs.append(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(name)(
            *ptrs, bsz, a, n, geom.height, geom.width, geom.n_in_row,
            geom.simulations, stride, geom.c_puct, geom.noise_fraction,
            1.0 - geom.noise_fraction, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} wave kernel launch failed: cudaError {rc}")


def wave_step(buffers: StepBuffers, carry: Carry, geom: WaveGeometry,
              record: bool = False) -> None:
    """One step: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Updates ``buffers`` and ``carry`` in place.

    record: the call is made inside a CUDA graph capture, where the launch
    is recorded and nothing runs: it is not counted. Who replays the graph
    counts each replay."""
    if buffers.root_board.device.type == "cpu":
        return wave_step_reference(buffers, carry, geom)
    bsz, n = carry.parent.shape
    launch("fused_mcts_v2", buffers, carry, geom,
           (bsz, buffers.probs.shape[-1], n))
    if not record:
        wave_step.launches += 1


# Kernel launches: eager ones and, in the search, replays of a captured one.
wave_step.launches = 0


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def empty_carry(bsz: int, num_actions: int, num_nodes: int, device) -> Carry:
    """An unfilled carry; ``fill_carry`` makes it a fresh tree."""
    a, n = num_actions, num_nodes

    def empty(*shape):
        return torch.empty((bsz,) + shape, dtype=torch.float32, device=device)

    return Carry(*(empty(a, n) for _ in range(4)),
                 *(empty(n) for _ in range(5)),
                 *(empty(1) for _ in range(3)))


def fill_carry(carry, env: ConnectN, root_states: ConnectNState) -> None:
    """Make ``carry`` (either layout) the fresh-tree carry, in place: the
    root in slot 0, terminal roots marked."""
    root_terminal = env.is_terminal(root_states).float()
    for t in (carry.prior, carry.visits, carry.value_sum, carry.parent,
              carry.parent_action, carry.expanded, carry.is_terminal,
              carry.reward, carry.leaf):
        t.zero_()
    carry.children.fill_(-1.0)
    carry.parent[:, 0] = -1.0
    carry.is_terminal[:, 0] = root_terminal
    carry.reward[:, 0] = -env.terminal_value(root_states)
    carry.node_count.fill_(1.0)
    carry.leaf_terminal[:, 0] = root_terminal


def init_carry(env: ConnectN, root_states: ConnectNState,
               num_nodes: int) -> Carry:
    """A new fresh-tree carry: the root in slot 0, terminal roots marked."""
    carry = empty_carry(root_states.board.shape[0], env.num_actions,
                        num_nodes, root_states.board.device)
    fill_carry(carry, env, root_states)
    return carry


class _Static:
    """The device memory of searches of one (batch, simulations): the carry,
    the step buffers, the captured wave per evaluator, and the fused
    forwards recorded into that wave, whose weights a search packs before
    its replays."""

    def __init__(self, carry, buffers: StepBuffers):
        self.carry = carry
        self.buffers = buffers
        self.graphs: Dict[EvaluateFn, "torch.cuda.CUDAGraph"] = {}
        self.packs: Dict[EvaluateFn, List[fused_net.FusedForward]] = {}


class FusedConnectNSearchV2:
    """Fresh-tree PUCT search of gravity Connect-N boards up to 8x8.

    The search owns its device memory per (batch, simulations), refills it
    in place at the start of a search, and returns copies."""

    # CUDA graph captures made by all searches of the process: one per
    # (search, batch, simulations, evaluator object).
    captures = 0

    def __init__(self, env: ConnectN, cfg: MCTSConfig = MCTSConfig(),
                 device=None):
        if not env.cfg.gravity:
            raise ValueError("fused search supports gravity Connect-N only")
        if env.cfg.height > _PH or env.cfg.width > _PW:
            raise ValueError("fused search supports boards up to 8x8")
        if cfg.max_nodes:
            raise ValueError("fused search uses fresh trees (max_nodes=0)")
        self.env = env
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mcts = MCTS(env, cfg)
        self._static: Dict[Tuple[int, int], _Static] = {}

    def geometry(self, simulations: int) -> WaveGeometry:
        c = self.env.cfg
        fraction = self.cfg.dirichlet_fraction if self.cfg.use_dirichlet else 0.0
        return WaveGeometry(c.height, c.width, c.n, self.cfg.c_puct,
                            simulations, fraction)

    def wave_inputs(self, mcts_wave: int, simulations: int, leaf_board,
                    leaf_terminal, probs, root_prior, root_live, gamma):
        """``wave_inputs`` of this search's geometry."""
        return wave_inputs(mcts_wave, self.geometry(simulations), leaf_board,
                           leaf_terminal, probs, root_prior, root_live, gamma)

    # The layout of the carry and the kernel: the v1 search overrides these.

    _wave_step = staticmethod(wave_step)
    _board_shape = (_CELLS,)

    def _empty_carry(self, bsz: int, num_nodes: int):
        return empty_carry(bsz, self.env.num_actions, num_nodes, self.device)

    def _root_stats(self, carry) -> Tuple[torch.Tensor, torch.Tensor]:
        return (carry.visits[:, :, 0].to(torch.int32),
                carry.value_sum[:, :, 0].clone())

    # The search's device memory.

    def static(self, bsz: int, simulations: int) -> _Static:
        """The carry and step buffers of (bsz, simulations) searches, made
        on first use."""
        static = self._static.get((bsz, simulations))
        if static is None:
            static = _Static(
                self._empty_carry(bsz, simulations + 1),
                new_buffers(bsz, self.env.num_actions,
                            self.geometry(simulations),
                            self.cfg.use_dirichlet, self.device,
                            self._board_shape),
            )
            self._static[(bsz, simulations)] = static
        return static

    def reset(self, static: _Static, root_states: ConnectNState) -> None:
        """A fresh tree at wave 0 from ``root_states``, in place. The root
        noise (``buffers.gamma``) stays: it is input, drawn per search."""
        fill_carry(static.carry, self.env, root_states)
        buffers = static.buffers
        for t in (buffers.probs, buffers.value, buffers.root_prior,
                  buffers.leaf_board, buffers.path, buffers.counter):
            t.zero_()
        buffers.root_board.copy_(
            padded_board(root_states.board).view_as(buffers.root_board))

    def _evaluate(self, static: _Static, evaluate_fn: EvaluateFn) -> None:
        """The net on the step's observation, into the next step's input."""
        probs, value = evaluate_fn(static.buffers.obs)
        static.buffers.probs.copy_(probs)
        static.buffers.value.copy_(value.reshape(-1, 1))

    def _captured_wave(self, static: _Static, evaluate_fn: EvaluateFn,
                       geom: WaveGeometry, root_states: ConnectNState):
        """The CUDA graph of one wave (the step kernel, then the evaluator
        into the step's inputs) on ``static``'s memory, captured on first
        use per evaluator. A capture runs real waves first, so the tree is
        reset after it. The fused forwards recorded into the graph go to
        ``static.packs``. An evaluator that cannot be captured (it waits for
        the device, or computes on the host) makes the capture raise."""
        graph = static.graphs.get(evaluate_fn)
        if graph is not None:
            return graph
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_WAVES):
                self._wave_step(static.buffers, static.carry, geom)
                self._evaluate(static, evaluate_fn)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with fused_net.recording() as recorded, torch.cuda.graph(graph):
            self._wave_step(static.buffers, static.carry, geom, record=True)
            self._evaluate(static, evaluate_fn)
        self.reset(static, root_states)
        static.graphs[evaluate_fn] = graph
        static.packs[evaluate_fn] = recorded
        FusedConnectNSearchV2.captures += 1
        return graph

    def search_root_stats(
        self, root_states: ConnectNState, evaluate_fn: EvaluateFn,
        generator: Optional[torch.Generator], simulations: int,
        gamma: Optional[torch.Tensor] = None, graph: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Root child visits (B, A) int32 and value sums (B, A) float32.

        generator: draws the root noise when ``cfg.use_dirichlet``: all
            the waves' Gamma draws as one (S, B, A) block (one
            ``safe_gamma`` call, stream order "block", not "per wave")
            straight into ``buffers.gamma``, before the waves.
        gamma: optional (S, B, A) per-wave Gamma draws used instead of the
            generator, copied whole (tests feed JAX's draws through it).
        graph: on the card, replay one captured CUDA graph per wave (the
            default, None or True) or launch every wave from the host
            (False: for an evaluator that cannot be captured, and for
            comparison). CPU searches have no graph; True raises there."""
        bsz = root_states.board.shape[0]
        dev = root_states.board.device
        if dev != self.device:
            raise ValueError(f"root states on {dev}, search on {self.device}")
        if graph is None:
            graph = dev.type == "cuda"
        elif graph and dev.type != "cuda":
            raise ValueError(f"no CUDA graph on device {dev}")
        geom = self.geometry(simulations)
        static = self.static(bsz, simulations)
        self.reset(static, root_states)
        if self.cfg.use_dirichlet:
            # The whole search's noise in one go, outside the captured wave
            # graph: a replay reads it, never redraws it.
            with trace.span("search.noise"):
                if gamma is not None:
                    static.buffers.gamma.copy_(gamma)
                else:
                    self._mcts.noise_plan(generator, simulations, bsz, dev,
                                          out=static.buffers.gamma)

        if graph:
            # The first search of a (batch, simulations) captures the graph
            # here, outside the span of the waves. The fused forwards
            # recorded into it read weights packed once a search, here.
            wave = self._captured_wave(static, evaluate_fn, geom, root_states)
            for forward in static.packs[evaluate_fn]:
                forward.pack_weights()
        with trace.span("search.waves"):
            if graph:
                for _ in range(simulations):
                    wave.replay()
                    self._wave_step.launches += 1
            else:
                for _ in range(simulations):
                    self._wave_step(static.buffers, static.carry, geom)
                    self._evaluate(static, evaluate_fn)
            # The drain wave: back up the last leaf; no net.
            self._wave_step(static.buffers, static.carry, geom)
        return self._root_stats(static.carry)
