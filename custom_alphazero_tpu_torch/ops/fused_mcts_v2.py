"""Fused Connect-N search, (games, actions, nodes) layout, on the card.

The port of custom_alphazero_tpu/ops/fused_mcts_v2.py. One search runs
``simulations + 1`` software-pipelined waves; each wave

1. builds the legal mask of the previous wave's leaf from its board's top
   row and ``leaf_terminal``, and renormalises the net's priors with it;
2. captures the root prior at wave 1 and mixes in this wave's root noise;
3. runs the wave (``wave``: the CUDA kernel csrc/fused_mcts_v2.cu on the
   card, ``wave_reference`` for CPU tensors): phase A expands and backs up
   the previous leaf, phase B selects and creates this wave's leaf;
4. observes the new leaf board and evaluates it with the net.

The last (drain) wave only backs up; its net forward would be unused and
is skipped. The carry keeps the JAX kernel's float32 arrays, so every carry
array can be compared bit for bit across the three implementations.

The v1 search (ops/fused_mcts.py, kernel K2) runs this search loop, plain
wave (``wave_plain``) and launcher (``launch``) on its own carry layout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from custom_alphazero_tpu_torch.config import MCTSConfig, resolve_device
from custom_alphazero_tpu_torch.envs.connect_n import (
    ConnectN,
    ConnectNState,
    has_line,
)
from custom_alphazero_tpu_torch.ops import _build
from custom_alphazero_tpu_torch.runtime.evaluate import EvaluateFn
from custom_alphazero_tpu_torch.search.mcts import MCTS

_CONTINUE = 0
_NEW = 1
_UNEXPANDED = 2
_TERMINAL = 3

_PH = 8
_PW = 8
_CELLS = _PH * _PW  # 64


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
    wave_reference.calls += 1
    leaf_board = wave_plain(wave, mixed, renormed, value, root_board, carry,
                            geom, v1_rules=False)
    return carry, leaf_board


wave_reference.calls = 0


def wave_plain(wave: int, mixed, renormed, value, root_board, carry: Carry,
               geom: WaveGeometry, v1_rules: bool) -> torch.Tensor:
    """The wave of both fused searches, in plain PyTorch, on a carry whose
    edge arrays are (B, A, N) (views are fine: they are updated in place).
    Returns the (B, 64) leaf board.

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

    node_term = is_terminal[batch, node] > 0.0
    leaf[:, 0] = torch.where(new, slot, node.float())
    leaf_terminal[:, 0] = torch.where(new, child_term, node_term).float()
    return torch.where(new[:, None], -placed, board)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_POINTER_ARGS = 17  # 4 inputs, 12 carry arrays, the leaf board
_KERNELS = {}


def _kernel(name: str):
    """The C entry point ``<name>_wave`` of csrc/<name>.cu, built and loaded
    on first use."""
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_wave")
        fn.argtypes = (
            [ctypes.c_void_p] * _POINTER_ARGS
            + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(name: str, wave_idx: int, mixed, renormed, value, root_board,
           carry, geom: WaveGeometry, edge_shape) -> torch.Tensor:
    """Check the wave's tensors and launch kernel ``name`` on CUDA tensors
    (any other device raises). The carry, with edge arrays of
    ``edge_shape``, is updated in place; returns the leaf board, shaped
    like ``root_board``."""
    device = root_board.device
    if device.type != "cuda":
        raise ValueError(f"no wave kernel for device {device}")
    bsz, n = carry.parent.shape
    a = mixed.shape[-1]
    if a > _PW:
        raise ValueError(f"the wave kernel takes at most {_PW} actions")
    # The board is (B, 64) or (B, 8, 8): the same bytes, row-major.
    board_shape = (bsz, _CELLS) if root_board.dim() == 2 else (bsz, _PH, _PW)
    inputs = (("mixed", mixed, (bsz, a)), ("renormed", renormed, (bsz, a)),
              ("value", value, (bsz, 1)),
              ("root_board", root_board, board_shape))
    shapes = [edge_shape] * 4 + [(bsz, n)] * 5 + [(bsz, 1)] * 3
    for label, t, shape in inputs:
        _check(label, t, shape, device)
    for label, t, shape in zip(Carry._fields, carry, shapes):
        _check(label, t, shape, device)
    leaf_board = torch.empty_like(root_board)
    ptrs = [t.data_ptr() for _, t, _ in inputs]
    ptrs += [t.data_ptr() for t in carry] + [leaf_board.data_ptr()]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel(name)(
            *ptrs, bsz, a, n, geom.height, geom.width, geom.n_in_row,
            geom.c_puct, geom.simulations, wave_idx, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} wave kernel launch failed: cudaError {rc}")
    return leaf_board


def wave(wave_idx: int, mixed, renormed, value, root_board, carry: Carry,
         geom: WaveGeometry):
    """One wave: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Updates ``carry`` in place; returns (carry, leaf_board)."""
    if root_board.device.type == "cpu":
        return wave_reference(wave_idx, mixed, renormed, value, root_board,
                              carry, geom)
    bsz, a, n = carry.prior.shape
    leaf_board = launch("fused_mcts_v2", wave_idx, mixed, renormed, value,
                        root_board, carry, geom, (bsz, a, n))
    wave.launches += 1
    return carry, leaf_board


wave.launches = 0


# ---------------------------------------------------------------------------
# The search
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


def init_carry(env: ConnectN, root_states: ConnectNState,
               num_nodes: int) -> Carry:
    """The fresh-tree carry: the root in slot 0, terminal roots marked."""
    bsz = root_states.board.shape[0]
    a, n = env.num_actions, num_nodes
    dev = root_states.board.device
    root_terminal = env.is_terminal(root_states).float()
    root_value = env.terminal_value(root_states)

    def zeros(*shape):
        return torch.zeros((bsz,) + shape, dtype=torch.float32, device=dev)

    parent = zeros(n)
    parent[:, 0] = -1.0
    is_terminal = zeros(n)
    is_terminal[:, 0] = root_terminal
    reward = zeros(n)
    reward[:, 0] = -root_value
    return Carry(
        prior=zeros(a, n),
        children=torch.full((bsz, a, n), -1.0, device=dev),
        visits=zeros(a, n),
        value_sum=zeros(a, n),
        parent=parent,
        parent_action=zeros(n),
        expanded=zeros(n),
        is_terminal=is_terminal,
        reward=reward,
        node_count=torch.ones((bsz, 1), device=dev),
        leaf=zeros(1),
        leaf_terminal=root_terminal[:, None].clone(),
    )


class FusedConnectNSearchV2:
    """Fresh-tree PUCT search of gravity Connect-N boards up to 8x8."""

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

    def geometry(self, simulations: int) -> WaveGeometry:
        c = self.env.cfg
        return WaveGeometry(c.height, c.width, c.n, self.cfg.c_puct,
                            simulations)

    def wave_inputs(self, mcts_wave: int, simulations: int, leaf_board,
                    leaf_terminal, probs, root_prior, root_live, gamma):
        """(renormed, mixed, root_prior) for one wave: the legal mask of
        the previous leaf, renormalised priors, the root prior captured at
        wave 1, and the root mix with this wave's (B, A) gamma draw."""
        legal = (leaf_board[:, :self.env.cfg.width] == 0) & (
            leaf_terminal == 0
        )
        renormed = self._mcts._renormalize(probs, legal)
        if mcts_wave == 1:
            root_prior = torch.where(root_live[:, None], renormed,
                                     root_prior)
        # The drain wave selects nothing, so its root mix is never read.
        if mcts_wave < simulations:
            mixed = self._mcts._root_noisy_prior(root_prior, gamma)
        else:
            mixed = root_prior
        return renormed, mixed, root_prior

    # The layout of the carry: the v1 search overrides these three.

    def _init_carry(self, root_states: ConnectNState, num_nodes: int):
        return init_carry(self.env, root_states, num_nodes)

    def _wave(self, wave_idx: int, mixed, renormed, value, root_board,
              carry, geom: WaveGeometry):
        return wave(wave_idx, mixed, renormed, value, root_board, carry, geom)

    def _root_stats(self, carry) -> Tuple[torch.Tensor, torch.Tensor]:
        return (carry.visits[:, :, 0].to(torch.int32),
                carry.value_sum[:, :, 0].clone())

    def search_root_stats(
        self, root_states: ConnectNState, evaluate_fn: EvaluateFn,
        generator: Optional[torch.Generator], simulations: int,
        gamma: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Root child visits (B, A) int32 and value sums (B, A) float32.

        generator: draws the root noise when ``cfg.use_dirichlet``.
        gamma: optional (S, B, A) per-wave Gamma draws used instead of the
            generator (tests feed JAX's draws through it)."""
        env = self.env
        bsz = root_states.board.shape[0]
        a = env.num_actions
        dev = root_states.board.device
        if dev != self.device:
            raise ValueError(f"root states on {dev}, search on {self.device}")
        geom = self.geometry(simulations)
        root_board = padded_board(root_states.board)
        carry = self._init_carry(root_states, simulations + 1)
        root_live = ~env.is_terminal(root_states)
        plan = None if gamma is not None else self._mcts.noise_plan(generator)

        leaf_board = torch.zeros((bsz, _CELLS), device=dev)
        probs = torch.zeros((bsz, a), device=dev)
        value = torch.zeros((bsz, 1), device=dev)
        root_prior = torch.zeros((bsz, a), device=dev)
        for w in range(simulations + 1):
            # The drain wave selects nothing and draws no noise.
            gamma_w = (None if w >= simulations
                       else self._mcts.root_gamma(plan, gamma, w, bsz, dev))
            renormed, mixed, root_prior = self.wave_inputs(
                w, simulations, leaf_board, carry.leaf_terminal, probs,
                root_prior, root_live, gamma_w,
            )
            carry, leaf_board = self._wave(w, mixed.contiguous(), renormed,
                                           value, root_board, carry, geom)
            if w < simulations:
                probs, v = evaluate_fn(
                    observe_board(leaf_board, env.cfg.height, env.cfg.width)
                )
                probs = probs.float()
                value = v.float().reshape(bsz, 1).contiguous()
        return self._root_stats(carry)
