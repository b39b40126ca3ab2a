"""The policy-value net's inference forward as hand-written kernels.

``FusedForward(net)(obs)`` computes ``net(obs)`` for an eval-mode bf16
``PolicyValueNet`` (models/policy_value.py) whose filters are a multiple
of K_STEP, with one kernel per convolution of the trunk and one for both
head convolutions, each with the layer's conv bias, eval-mode BatchNorm,
residual skip and ReLU in its epilogue, and in a net with
squeeze-excitation gates one more kernel a block (csrc/fused_net.cu, built
with nvcc by ``ops/_build.py`` on first use and bound through ctypes):

- ``pack``: rounds every trunk conv weight, from the live float32
  parameters, to bf16 (as autocast rounds them) into one buffer of C_out
  rows of (tap, C_in), the GEMM's K-major N x K operand: one launch a search
  for a replayed forward, one a call for an eager one;
- ``conv``: an implicit GEMM on NHWC activations. One GEMM row is one board
  cell: M = B x H x W, N = filters, K = taps x C_in. No im2col tensor is
  written. A block conv (bf16 input, C_in and filters multiples of K_STEP)
  takes the pipelined kernel: a producer thread streams each K step's
  shifted cells (TMA's im2col mode, zeros past the board's edges) and
  weight box into a ring of shared-memory stages that consumer warpgroups
  read with wgmma, paced by mbarriers; ``conv_tile`` picks its tile by the
  GEMM's shape. The stem reads the float32 observations, rounds them to
  bf16 on load and gathers both operands with masked loads in every
  thread. The epilogue, in float32 from the live parameters and running
  statistics, applies the conv bias and the BatchNorm as one scale and
  offset a channel and, in a residual block's second conv, adds the
  block's skip: its 1x1 projection (a second accumulator over the block
  input, its own BatchNorm) or, in a block without one
  (``residual_projection=False``), the block input's bf16 tile itself;
  then ReLU, and writes bf16: one rounding a layer, where the module path
  rounds after the conv, the BatchNorm and the add. In a block with a
  squeeze-excitation gate (``se_ratio`` > 0) the second conv's epilogue
  stops after the BatchNorm (no skip, no ReLU) and writes bf16;
- ``se``: such a block's gate and the rest of the block, once a block: the
  mean of the second conv's output over each position's cells (summed in a
  fixed order, so a forward repeats bit for bit), the gate's two dense
  layers from their live float32 weights, then relu(x + sigmoid(g) * y + o)
  in float32 over the block input x, written bf16. A position's cells
  straddle the conv's tiles, so the conv's epilogue cannot take the mean;
- ``heads``: the policy conv (2 filters) and the value conv (1 filter) over
  the trunk's output with their BatchNorm and ReLU, written in float32.

A nested bottleneck tower (``mid_filters`` > 0, KataGo's b18c384nbt
blocks; ``nested``) is pre-activation: each conv reads relu(n(y)) of the
tensor y before it, n that conv's own BatchNorm. So a conv's epilogue
applies the next conv's norm: it adds the conv's bias (and a skip from two
or four convs back: the inner stream to an inner block's second conv, the
block input to the 1x1 conv up, as the identity tile), rounds the sum once
to bf16 as the skip stream and writes relu(n_next) of that rounded value
as the next conv's input: two outputs from one launch (``conv_pre``, the
pipelined kernel's pre-activation modes; the stem writes its second output
the same way). A conv whose raw output nothing reads (an inner block's
first) folds its bias into the next norm as a classic epilogue. The 1x1
convs down (384 -> 192) and up (192 -> 384) are whole layers of one tap,
and C_in and C_out differ along the block (``trunk_convs``); an output of
192 filters takes 96-filter tiles (``conv_tile``). In a pooled block
(``gpool_blocks``) the first inner conv writes its regular channels raw,
the pooled branch's conv its rectified pooled channels, and ``gpool``:
- ``gpool``: the board mean, the scaled mean and the max of the pooled
  channels over each position's cells (summed in a fixed order, so a
  forward repeats bit for bit), the dense layer from its live float32
  weight to a channel bias of the regular channels, then relu(n(r + bias))
  with the second inner conv's norm n, written bf16: the pooled means
  straddle the conv's tiles, as the squeeze-excitation gate's do.
After the last block the trunk's own norm and ReLU (``trunk_norm``) come
from the last conv's second output.

The dense layers, ``tanh`` and the softmax stay plain matrix products in
float32: the policy logits and the value as the module path computes them,
except that the value's hidden layer reads the heads' float32 output in
float32 where autocast runs it in bf16 (one rounding fewer, no per-forward
weight cast).

No weight value is kept on the host: every launch reads the parameters
and running statistics where they live, and an eager forward packs the
conv weights anew into a buffer of its own. A forward recorded into a CUDA
graph packs nothing: it reads the packed buffer that its ``FusedForward``
owns (allocated at the first eager call, at a fixed address, which the
graph keeps) and registers itself with the open ``recording()``. The
search that captured the graph calls ``pack_weights`` of each forward
recorded in it once a search, before the replays. So an in-place
``load_state_dict`` (``Learner.promote``) or a train step reaches the next
search and every eager forward; it does not reach a replay later in the
same search, and no caller changes weights there. A bare replay outside a
search reads the weights of the last search or ``pack_weights``. The
search keeps the recorded forwards beside its graphs (``_Static.packs`` in
ops/fused_mcts_v2.py), not in them: ``_Static.graphs`` still maps an
evaluator to its ``torch.cuda.CUDAGraph``, which a caller that replays a
search's graph itself reads and replays. What the object keeps besides is
the table of the conv weights' addresses that ``pack`` reads; it is
rebuilt when an address changes. The pipelined kernel's TMA descriptors
(of the packed weights and the activations, whose addresses a captured
graph keeps) are encoded at each launch and passed by value, so a graph
replay does no host work.

These kernels replace no TPU kernel: the JAX package leaves the net to XLA,
which fuses each layer's BatchNorm, bias, add and ReLU into the convolution
on the TPU. On the card the module path ran each of those as a separate
pass over the 11 MB activation: about 160 kernels a self-play wave, 57% of
the device's busy time in element-wise passes. What bounds them on an H100,
and what the design does about it, is in the source's head comment.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from types import SimpleNamespace
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from custom_alphazero_tpu_torch.models.policy_value import (
    ConvBlock,
    PolicyValueNet,
)
from custom_alphazero_tpu_torch.ops import _build

# The conv kernels' K stage (csrc/fused_net.cu's kBK): each packed weight
# row is padded with zeros to a multiple of it, and the pipelined kernel
# takes C_in and filters that are multiples of it.
K_STEP = 64
# The conv kernels' tile width in filters (csrc/fused_net.cu's kBN).
TILE_FILTERS = 128
# The pipelined kernel's narrower tile, for outputs that are a multiple of
# it and not of TILE_FILTERS (a nested bottleneck tower's 192 filters),
# in its modes without a projection.
NARROW_FILTERS = 96
# The pack kernel's tile of (C_out, K) elements.
PACK_TILE = 32
# The widest net whose gates the se kernel takes: 128 threads a position,
# one 16-byte chunk of 8 channels each (csrc/fused_net.cu's kSeHalf); the
# filters divide it.
SE_MAX_FILTERS = 1024
# The widest pooled branch the gpool kernel takes: 128 threads a position,
# one 16-byte chunk of 8 pooled channels each (csrc/fused_net.cu's kGpHalf);
# the pooled channels divide it.
GPOOL_MAX_FILTERS = 1024
# The shared memory an H100's SM gives one CTA, which holds both of a
# gate's dense weights and its sums (``se_smem_bytes``).
SE_SMEM_LIMIT = 227 * 1024


def se_smem_bytes(filters: int, hidden: int) -> int:
    """The se kernel's shared memory (csrc/fused_net.cu's
    ``se_smem_floats``): the weights' copy barrier (16 bytes), W1 and W2,
    3 x hidden x filters floats, their biases, then two positions' partial
    sums, means, scales, offsets and hidden units."""
    rows = 128 // (filters // 8)
    return 4 * (4 + 3 * hidden * filters + hidden + 2 * filters
                + 2 * (rows * filters + 3 * filters + hidden))


def se_fits(net: PolicyValueNet) -> bool:
    """Whether the se kernel takes ``net``'s gates (a net without gates:
    True): filters that divide SE_MAX_FILTERS, hidden units a multiple of 4
    (its dense layers read 16-byte vectors), weights within
    SE_SMEM_LIMIT."""
    filters, ratio = net.cfg.filters, net.cfg.se_ratio
    if not ratio:
        return True
    hidden = filters // ratio
    return (SE_MAX_FILTERS % filters == 0 and hidden % 4 == 0
            and se_smem_bytes(filters, hidden) <= SE_SMEM_LIMIT)


def nested(net: PolicyValueNet) -> bool:
    """Whether ``net``'s blocks are nested bottlenecks (``mid_filters``)."""
    return net.trunk_norm is not None


def nested_fits(net: PolicyValueNet) -> bool:
    """Whether N1 takes a nested bottleneck tower (a net of classic blocks:
    True): the mid width and, in a pooled block, the regular and the pooled
    channels multiples of K_STEP, as every conv's C_in and C_out must be,
    and pooled channels that divide GPOOL_MAX_FILTERS (the gpool kernel's
    threads each take a 16-byte chunk of a cell's pooled channels)."""
    if not nested(net):
        return True
    cfg = net.cfg
    widths = [cfg.mid_filters]
    if cfg.gpool_blocks:
        widths += [cfg.gpool_filters, cfg.mid_filters - cfg.gpool_filters]
        if GPOOL_MAX_FILTERS % cfg.gpool_filters:
            return False
    return all(width % K_STEP == 0 for width in widths)


def applies(net: PolicyValueNet, obs: torch.Tensor) -> bool:
    """Whether ``make_evaluate_fn`` takes the fused forward: CUDA
    observations and a bf16 net in eval mode (its ``evaluate`` runs under
    ``torch.inference_mode``, so grad is off) whose filters are a multiple
    of K_STEP (the pipelined kernel's K steps are one tap's whole 64-channel
    slice) and, in a net with squeeze-excitation gates, fit the ``se``
    kernel (``se_fits``: its threads each take a 16-byte chunk of a cell's
    channels, and an SM's shared memory holds the gate's dense weights).
    A nested bottleneck tower also needs its mid width and, where a block
    pools, its regular and pooled channels to be multiples of K_STEP, the
    pooled ones dividing GPOOL_MAX_FILTERS (``nested_fits``): b18c384nbt's
    192, 128 and 64 fit; a mid width of 96, 32 or 192 pooled channels run
    the module path. Anything else (the
    training forward, float32 nets, CPU tensors, other widths) runs
    ``net(obs)``. The gates' and the pooled biases' dense weights are read
    where they live, at each launch, like the convs' parameters."""
    return (obs.device.type == "cuda"
            and net.cfg.compute_dtype == "bfloat16" and not net.training
            and net.cfg.filters % K_STEP == 0 and se_fits(net)
            and nested_fits(net))


def trunk_convs(net: PolicyValueNet):
    """The trunk's convs (modules with ``conv``) in the order ``pack`` lays
    them out: the stem, then conv1, conv2 and (where the block has one)
    proj of each residual block. A squeeze-excitation gate (``block.se``)
    has no row: the ``se`` kernel reads its dense weights from the live
    parameters. A nested bottleneck block's rows, in forward order: the 1x1
    conv down (``pre``), each inner block's conv1, in a pooled one its
    pooled branch's conv (``gpool``, its C_out the pooled channels where
    conv1's is the regular ones), and conv2, then the 1x1 conv up
    (``post``); C_in and C_out differ along it (384 -> 192 -> 128 and 64 ->
    192 -> 384 in b18c384nbt). The pooled bias's dense weight has no row."""
    convs = [net.stem]
    if nested(net):
        for block in net.blocks:
            convs.append(block.pre)
            for inner in block.inner:
                convs.append(inner.conv1)
                if inner.gpool is not None:
                    convs.append(inner.gpool)
                convs.append(inner.conv2)
            convs.append(block.post)
        return convs
    for block in net.blocks:
        convs += [block.conv1, block.conv2]
        if block.proj is not None:
            convs.append(block.proj)
    return convs


# The pipelined kernel's cost model on an H100 (PERF.md, section 6), fitted
# to its measured times at the benchmark's and the arenas' shapes: a round
# of CTAs (one to an SM) costs ROUND_US (the pipeline's fill, the epilogue,
# the launch) plus UNIT_US[tile cells] for each million cell x filter x K
# of its tile. Once both operands are TMA loads the unit cost hardly
# depends on the tile's shape: the rounds decide.
ROUND_US = 5.0
UNIT_US = {128: 0.38, 192: 0.38}


def conv_grid(bm: int, m: int, n: int) -> Tuple[int, int]:
    """The pipelined kernel's grid for an (m, n) output on tiles of ``bm``
    cells by TILE_FILTERS: M tiles, N tiles."""
    return -(-m // bm), -(-n // TILE_FILTERS)


def conv_tile(m: int, n: int, cin: int, taps: int, sms: int,
              projection: bool = False) -> Tuple[int, int]:
    """The pipelined kernel's tile, (board cells, filters), for a block conv
    with an (m, n) output and K = taps x ``cin`` on ``sms`` SMs.

    A conv with a projection's second accumulator takes 128 x TILE_FILTERS
    (two warpgroups: one alone on an SM ran it at half the rate). Else, of
    128 and 192 cells (two and three warpgroups sharing each weight stage)
    by TILE_FILTERS filters, and by NARROW_FILTERS too where ``n`` is a
    multiple of NARROW_FILTERS and not of TILE_FILTERS, the tile whose last
    round of CTAs ends first by the cost model above (the first such in that
    order). At c4-r5's self-play shape (43,008 x 128, K 1,152) 192-cell
    tiles take 2 rounds where 128 take 3; at the 19 x 256 net's B=256
    (10,752 x 256, K 2,304) 112 tiles of 192 take one round where 168 of 128
    take two; at c4-r5's arena batch (10,752 x 128) both take one round, and
    84 tiles of 128 finish before 56 of 192. The nested bottleneck tower's
    convs take the same model with their own C_in, C_out and taps: its 1x1
    convs (K 384 or 192) and its 3x3 convs of 192 or 128 inputs; at
    b18c384nbt's B=256 (10,752 x 192, K 1,728) 112 tiles of 192 x 96 take
    one round, each a quarter less work than a half-empty 192 x 128
    tile."""
    if projection:
        return 128, TILE_FILTERS
    widths = ((TILE_FILTERS, NARROW_FILTERS)
              if n % TILE_FILTERS and n % NARROW_FILTERS == 0
              else (TILE_FILTERS,))
    best = None
    for bn in widths:
        for bm, unit in UNIT_US.items():
            gx, gy = -(-m // bm), -(-n // bn)
            rounds = -(-gx * gy // sms)
            time = rounds * (ROUND_US + unit * bm * bn * taps * cin / 1e6)
            if best is None or time < best[0]:
                best = (time, (bm, bn))
    return best[1]


def padded_depth(cin: int, taps: int) -> int:
    """The length of a packed weight row: taps x C_in, rounded up to a
    multiple of K_STEP."""
    return -(-cin * taps // K_STEP) * K_STEP


def pack_layout(net: PolicyValueNet):
    """Rows (weight address, offset, C_out, C_in, taps) of the pack table
    and the packed buffer's length in elements. A layer's packed weight is
    C_out rows of ``padded_depth`` bf16, (tap, C_in) order, then zeros."""
    rows, offset = [], 0
    for block in trunk_convs(net):
        w = block.conv.weight
        if w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("the fused forward reads contiguous float32 "
                             f"conv weights; got {w.dtype}")
        cout, cin, kh, kw = w.shape
        rows.append((w.data_ptr(), offset, cout, cin, kh * kw))
        offset += cout * padded_depth(cin, kh * kw)
    return rows, offset


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _epilogue_plain(z: torch.Tensor, block: ConvBlock) -> torch.Tensor:
    """Conv bias and eval-mode BatchNorm on float32 NCHW conv sums, as the
    kernel folds them: z * scale + offset, scale = gamma / sqrt(var + eps),
    offset = (bias - mean) * scale + beta."""
    bn = block.bn
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    offset = (block.conv.bias - bn.running_mean) * scale + bn.bias
    return z * scale[:, None, None] + offset[:, None, None]


def _conv_plain(x: torch.Tensor, block: ConvBlock,
                dtype: torch.dtype) -> torch.Tensor:
    """Float32 sums of the conv of ``x`` (NCHW) over operands rounded to
    ``dtype``: bf16 products are exact in float32, as in the tensor cores."""
    w = block.conv.weight
    return F.conv2d(x.to(dtype).float(), w.to(dtype).float(), None,
                    padding=w.shape[-1] // 2)


def _dense_heads(net: PolicyValueNet, p: torch.Tensor, v: torch.Tensor):
    """(B, H*W*P) and (B, H*W*V) float32 head features, NHWC order ->
    (logits (B, A), value (B,)), all float32. The logits are computed
    transposed, (W p^T)^T: for p W^T, with its few columns, cuBLAS takes a
    split-K kernel, a memset and a scaling pass (4 launches, 17 us on an
    H100 at B=1,024, against 2 launches and 4 us)."""
    logits = torch.addmm(net.policy_dense.bias[:, None],
                         net.policy_dense.weight, p.t()).t()
    v = torch.relu(F.linear(v, net.value_dense1.weight,
                            net.value_dense1.bias))
    value = torch.tanh(F.linear(v, net.value_dense2.weight,
                                net.value_dense2.bias))[:, 0]
    return logits, value


def _gate_plain(x: torch.Tensor, y: torch.Tensor, se) -> torch.Tensor:
    """A block's squeeze-excitation and skip before the ReLU, in float32 as
    the ``se`` kernel computes it: x + sigmoid(g) * y + o over NCHW x and y,
    [g | o] = dense2(relu(dense1(the mean of y over the board)))."""
    y = y.float()
    hidden = torch.relu(F.linear(y.mean(dim=(2, 3)), se.dense1.weight,
                                 se.dense1.bias))
    g, o = F.linear(hidden, se.dense2.weight, se.dense2.bias).chunk(2, dim=1)
    return (x.float() + torch.sigmoid(g)[:, :, None, None] * y
            + o[:, :, None, None])


def _norm_plain(x: torch.Tensor, bn) -> torch.Tensor:
    """A pre-activation conv's eval-mode BatchNorm and ReLU on float32 NCHW
    ``x``, as the kernels fold it: relu(x * scale + offset), scale = gamma /
    sqrt(var + eps), offset = (-mean) * scale + beta."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    offset = (-bn.running_mean) * scale + bn.bias
    return torch.relu(x * scale[:, None, None] + offset[:, None, None])


def pool_scale(cells: int) -> float:
    """KataGPool's factor of the scaled mean, (sqrt(cells) - 14) / 10,
    rounded to float32 as the ``gpool`` kernel takes it."""
    return float(torch.tensor((math.sqrt(cells) - 14.0) / 10.0,
                              dtype=torch.float32))


def _gpool_plain(r: torch.Tensor, g: torch.Tensor, inner) -> torch.Tensor:
    """A pooled inner block's pooled bias and conv2's norm, in float32 as
    the ``gpool`` kernel computes them: relu(n(r + W [mean(g), mean(g) x
    pool_scale, max(g)])) over NCHW r (the regular channels) and g (the
    pooled ones, rectified), n conv2's BatchNorm."""
    g = g.float()
    cells = g.shape[2] * g.shape[3]
    mean = g.sum(dim=(2, 3)) / cells
    pooled = torch.cat([mean, mean * pool_scale(cells), g.amax(dim=(2, 3))],
                       dim=1)
    bias = pooled @ inner.gpool.dense.weight.t()
    return _norm_plain(r.float() + bias[:, :, None, None], inner.conv2.bn)


def _nested_plain(net: PolicyValueNet, x: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The nested bottleneck tower after the stem, as its launches compute
    it: each conv's float32 sums plus its bias (and a skip two or four
    convs back), rounded once; where the next conv reads it, the rounded
    tensor's norm and ReLU, rounded again (the dual-output epilogue). An
    inner block's first conv, whose raw output nothing else reads, folds its
    bias into the next norm as a classic conv's epilogue does. Returns the
    rounded relu(n(x)) of the last block's output, which the heads read."""
    def bias(z, block):
        return z + block.conv.bias[:, None, None]

    def act(z, bn):
        return _norm_plain(z.to(dtype).float(), bn).to(dtype)

    raw = x
    xa = act(x.float(), net.blocks[0].pre.bn)
    for i, block in enumerate(net.blocks):
        after = (net.blocks[i + 1].pre.bn if i + 1 < len(net.blocks)
                 else net.trunk_norm)
        a = bias(_conv_plain(xa, block.pre, dtype), block.pre).to(dtype)
        u = act(a.float(), block.inner[0].conv1.bn)
        for j, inner in enumerate(block.inner):
            if inner.gpool is not None:
                r = bias(_conv_plain(u, inner.conv1, dtype),
                         inner.conv1).to(dtype)
                g = torch.relu(_epilogue_plain(_conv_plain(
                    u, inner.gpool, dtype), inner.gpool)).to(dtype)
                t = _gpool_plain(r, g, inner).to(dtype)
            else:
                t = torch.relu(_epilogue_plain(
                    _conv_plain(u, inner.conv1, dtype),
                    SimpleNamespace(conv=inner.conv1.conv,
                                    bn=inner.conv2.bn))).to(dtype)
            z = bias(_conv_plain(t, inner.conv2, dtype), inner.conv2) + (
                a.float())
            if j + 1 < len(block.inner):
                a = z.to(dtype)
                u = act(a.float(), block.inner[j + 1].conv1.bn)
            else:
                u = act(z, block.post.bn)
        z = bias(_conv_plain(u, block.post, dtype), block.post) + raw.float()
        raw = z.to(dtype)
        xa = act(z, after)
    return xa


def forward_plain(net: PolicyValueNet, obs: torch.Tensor):
    """The fused forward in plain PyTorch, with the kernels' arithmetic:
    operands rounded to the net's compute dtype, float32 sums and
    epilogues, one rounding of each trunk layer's output (and of a gated
    block's second conv). A float32 net rounds nothing, so its result is
    the module's up to float32 order."""
    forward_plain.calls += 1
    dtype = (torch.bfloat16 if net.cfg.compute_dtype == "bfloat16"
             else torch.float32)
    x = obs.permute(0, 3, 1, 2)
    x = torch.relu(_epilogue_plain(_conv_plain(x, net.stem, dtype),
                                   net.stem)).to(dtype)
    if nested(net):
        x = _nested_plain(net, x, dtype)
    for block in net.blocks if not nested(net) else ():
        y = torch.relu(_epilogue_plain(_conv_plain(x, block.conv1, dtype),
                                       block.conv1)).to(dtype)
        if block.se is not None:
            y = _epilogue_plain(_conv_plain(y, block.conv2, dtype),
                                block.conv2).to(dtype)
            x = torch.relu(_gate_plain(x, y, block.se)).to(dtype)
            continue
        skip = (x.float() if block.proj is None else _epilogue_plain(
            _conv_plain(x, block.proj, dtype), block.proj))
        z = _epilogue_plain(_conv_plain(y, block.conv2, dtype),
                            block.conv2) + skip
        x = torch.relu(z).to(dtype)
    p, v = (torch.relu(_epilogue_plain(_conv_plain(x, head, dtype), head))
            .permute(0, 2, 3, 1).flatten(1)
            for head in (net.policy_conv, net.value_conv))
    return _dense_heads(net, p, v)


forward_plain.calls = 0


# ---------------------------------------------------------------------------
# The kernels (csrc/fused_net.cu)
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    """csrc/fused_net.cu's entry points, built and loaded on first use."""
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_net")
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_net_pack.argtypes = [ptr, i, i, ptr, ptr]
        lib.fused_net_conv.argtypes = ([ptr, ptr, i, i] + [ptr] * 12
                                       + [i, i, i, i, f, ptr])
        lib.fused_net_conv_pipelined.argtypes = (
            [ptr, ptr, i, i] + [ptr] * 12
            + [i, ptr, ptr, i, i, i, i, f, i, i, ptr])
        lib.fused_net_heads.argtypes = ([ptr, i, i] + [ptr] * 6 + [i]
                                        + [ptr] * 6 + [i, f, ptr, ptr, ptr])
        lib.fused_net_se.argtypes = [ptr, ptr, i, i, i, i] + [ptr] * 6
        lib.fused_net_gpool.argtypes = ([ptr, ptr, i, i, i, i, ptr, f]
                                        + [ptr] * 4 + [f, ptr, ptr])
        for fn in (lib.fused_net_pack, lib.fused_net_conv,
                   lib.fused_net_conv_pipelined, lib.fused_net_heads,
                   lib.fused_net_se, lib.fused_net_gpool):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SMS = {}


def _sm_count(device: torch.device) -> int:
    """The card's SMs (read once a device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"fused net {name} launch failed: cudaError {rc}")


def _bn_args(block: ConvBlock):
    bn = block.bn
    return tuple(t.data_ptr() for t in (block.conv.bias, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var))


def _norm_args(bn):
    """A following BatchNorm as the kernels' BatchNormArgs (its ``bias``
    slot unread: the conv's own bias is added before the norm)."""
    return tuple(t.data_ptr() for t in (bn.bias, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var))


def pack(table: torch.Tensor, out: torch.Tensor, rows) -> None:
    """Launch ``pack`` over the layers of the table (one launch), whose
    rows on the host are ``rows``: a block a (PACK_TILE x PACK_TILE) tile of
    a layer's output channels and padded K."""
    tiles = max(-(-cout // PACK_TILE) * (padded_depth(cin, taps) // PACK_TILE)
                for _, _, cout, cin, taps in rows)
    _launched("pack", _lib().fused_net_pack(
        table.data_ptr(), table.shape[0], tiles, out.data_ptr(),
        _stream(out.device)))
    pack.launches += 1


def conv(x: torch.Tensor, w: torch.Tensor, block: ConvBlock, hw, out,
         residual: Union[None, torch.Tensor,
                         Tuple[torch.Tensor, torch.Tensor, ConvBlock]] = None,
         relu: bool = True, act=None) -> None:
    """Launch one conv layer on NHWC ``x``, (B, H, W, C_in) or its
    (M, C_in) rows, into (M, N) bf16 ``out``; ``w`` is the layer's packed
    weight (``pack_layout``). The stem (float32 ``x``, no ``residual``)
    takes its own kernel; a block conv (bf16 ``x``) the pipelined kernel on
    ``conv_tile``'s tile. ``residual``, added before the ReLU: the block
    input ((M, N) bf16) of an identity block, or (block input, its packed
    1x1 weight, the proj ConvBlock) of a block with a projection.
    ``relu`` False (a block conv without ``residual``): the output stops
    after the BatchNorm, a gated block's second conv. ``act`` (the stem
    only): (an (M, N) bf16 tensor, a BatchNorm) that also gets relu(n(out))
    of the rounded output, a nested bottleneck tower's first input."""
    h, w_ = hw
    cin = x.shape[-1]
    k = block.conv.kernel_size[0]
    n = block.conv.out_channels
    m = out.shape[0]
    if x.dtype == torch.float32:
        bn = _bn_args(block)
        _launched("conv", _lib().fused_net_conv(
            x.data_ptr(), w.data_ptr(), cin, k, *bn,
            *(bn if act is None else _norm_args(act[1])), out.data_ptr(),
            None if act is None else act[0].data_ptr(), m, h, w_, n,
            block.bn.eps, _stream(out.device)))
        conv.launches += 1
        conv.preact_launches += int(act is not None)
        return
    bm, bn = conv_tile(m, n, cin, k * k, _sm_count(out.device),
                       projection=isinstance(residual, tuple))
    launch_conv(x, w, block, hw, out, residual, bm, relu, bn)


def launch_conv(x, w, block: ConvBlock, hw, out, residual, bm: int,
                relu: bool = True, bn_tile: int = TILE_FILTERS) -> None:
    """``conv``'s launch of a block conv on the pipelined kernel's tile of
    ``bm`` cells by ``bn_tile`` filters."""
    h, w_ = hw
    bn = _bn_args(block)
    if residual is None:
        r, wr, rbn, skip = x, w, bn, 0 if relu else 3
    elif isinstance(residual, torch.Tensor):
        r, wr, rbn, skip = residual, w, bn, 2
    else:
        r, wr, rblock = residual
        rbn, skip = _bn_args(rblock), 1
    _launched("conv", _lib().fused_net_conv_pipelined(
        x.data_ptr(), w.data_ptr(), x.shape[-1], block.conv.kernel_size[0],
        *bn, r.data_ptr(), wr.data_ptr(), *rbn, skip, out.data_ptr(), None,
        out.shape[0], h, w_, block.conv.out_channels, block.bn.eps, bm,
        bn_tile, _stream(out.device)))
    conv.launches += 1
    conv.identity_launches += int(skip == 2)


def conv_pre(x: torch.Tensor, w: torch.Tensor, block, hw,
             raw: Optional[torch.Tensor] = None, act=None,
             skip: Optional[torch.Tensor] = None) -> None:
    """Launch a conv of a nested bottleneck tower with the pre-activation
    epilogue, on ``conv_tile``'s tile: the conv of ``block`` (a NormConv:
    its ``conv``, whose bias is added; its own norm is the one its input
    already went through) over NHWC ``x`` ((M, C_in) bf16, activated), plus
    ``skip`` ((M, N) bf16, the block's or the inner block's input: the
    identity tile), rounded to bf16 into ``raw`` and, given ``act`` = (an
    (M, N) bf16 tensor, the next conv's BatchNorm), relu(n(raw)) of the
    rounded value into that tensor: the skip stream and the next conv's
    input from one launch. Either output may be absent (None), not
    both. A 1x1 conv is a whole layer here (taps 1, K = C_in)."""
    h, w_ = hw
    first = raw if raw is not None else act[0]
    m, cin, k = first.shape[0], x.shape[-1], block.conv.kernel_size[0]
    n = block.conv.out_channels
    bn = (block.conv.bias.data_ptr(),) * 5
    rbn = bn if act is None else _norm_args(act[1])
    r = x if skip is None else skip
    bm, bn_tile = conv_tile(m, n, cin, k * k, _sm_count(first.device))
    _launched("conv", _lib().fused_net_conv_pipelined(
        x.data_ptr(), w.data_ptr(), cin, k, *bn, r.data_ptr(), w.data_ptr(),
        *rbn, 4 if skip is None else 5,
        None if raw is None else raw.data_ptr(),
        None if act is None else act[0].data_ptr(), m, h, w_, n,
        0.0 if act is None else act[1].eps, bm, bn_tile,
        _stream(first.device)))
    conv.launches += 1
    conv.pointwise_launches += int(k == 1)
    conv.preact_launches += int(raw is not None and act is not None)


def gpool(r: torch.Tensor, g: torch.Tensor, inner, hw, out) -> None:
    """Launch a pooled inner block's pooled bias and conv2's norm: (M, R)
    bf16 ``out`` gets relu(n(r + W p)) of the regular channels ``r`` ((M,
    R) bf16, conv1's raw output), p the mean, the scaled mean
    (``pool_scale``) and the max over each position's cells of the pooled
    channels ``g`` ((M, G) bf16, rectified), W the dense weight ((R, 3G)
    float32, read where it lives), n conv2's BatchNorm."""
    weight = inner.gpool.dense.weight
    if (weight.dtype != torch.float32 or not weight.is_contiguous()
            or weight.data_ptr() % 16):
        raise ValueError("the fused forward reads a contiguous, 16-byte "
                         "aligned float32 pooled-bias weight")
    m, regular = r.shape
    cells = hw[0] * hw[1]
    bn = inner.conv2.bn
    _launched("gpool", _lib().fused_net_gpool(
        g.data_ptr(), r.data_ptr(), m // cells, cells, g.shape[1], regular,
        weight.data_ptr(), pool_scale(cells),
        *(t.data_ptr() for t in (bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var)),
        bn.eps, out.data_ptr(), _stream(r.device)))
    gpool.launches += 1


def se(x: torch.Tensor, y: torch.Tensor, block, hw, out) -> None:
    """Launch a residual block's squeeze-excitation gate (``block.se``) and
    the rest of the block: (M, C) bf16 ``out`` gets relu(x + sigmoid(g) *
    y + o) of the block input ``x`` and its second conv's output ``y``,
    both (M, C) bf16, M = B x H x W. The dense weights are read where they
    live."""
    gate = block.se
    layers = (gate.dense1.weight, gate.dense1.bias, gate.dense2.weight,
              gate.dense2.bias)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.data_ptr() % 16 for t in layers):
        raise ValueError("the fused forward reads contiguous, 16-byte "
                         "aligned float32 squeeze-excitation weights")
    m, c = x.shape
    cells = hw[0] * hw[1]
    _launched("se", _lib().fused_net_se(
        x.data_ptr(), y.data_ptr(), m // cells, cells, c,
        gate.dense1.out_features, *(t.data_ptr() for t in layers),
        out.data_ptr(), _stream(x.device)))
    se.launches += 1


def heads(x: torch.Tensor, net: PolicyValueNet, p_out, v_out) -> None:
    """Launch the policy and value head convs on the (M, C) bf16 trunk
    output into (M, P) and (M, V) float32."""
    m, c = x.shape
    pc, vc = net.policy_conv, net.value_conv
    _launched("heads", _lib().fused_net_heads(
        x.data_ptr(), m, c, pc.conv.weight.data_ptr(), *_bn_args(pc),
        pc.conv.out_channels, vc.conv.weight.data_ptr(), *_bn_args(vc),
        vc.conv.out_channels, pc.bn.eps, p_out.data_ptr(), v_out.data_ptr(),
        _stream(x.device)))
    heads.launches += 1


# Launches made from the host. A launch recorded into a CUDA graph counts
# once, when recorded; its replays are not counted. ``identity_launches``:
# the conv launches that added an identity block's input.
# ``pointwise_launches``: the 1x1 convs launched as whole layers (a nested
# bottleneck's convs down and up). ``preact_launches``: the conv launches
# that wrote both a skip stream and its norm and ReLU (the dual-output
# epilogue, the nested tower's stem included).
# ``search_launches``: the packs that a search launched before its replays
# (``FusedForward.pack_weights``), also counted in ``launches``.
pack.launches = 0
pack.search_launches = 0
conv.launches = 0
conv.identity_launches = 0
conv.pointwise_launches = 0
conv.preact_launches = 0
se.launches = 0
gpool.launches = 0
heads.launches = 0


def _nested_cuda(net: PolicyValueNet, x: torch.Tensor, xa: torch.Tensor,
                 weights, hw) -> torch.Tensor:
    """The nested bottleneck tower's launches after the stem, whose raw
    output ``x`` and its first block's activated input ``xa`` ((M, C) bf16)
    are given; ``weights`` yields each conv's packed weight in
    ``trunk_convs`` order. Per block: the 1x1 conv down writes the inner
    stream a and its activation; each inner block's conv1 writes only its
    activation (folded as a classic epilogue), or in a pooled one conv1's
    raw regular channels, the pooled branch's conv its rectified channels
    and ``gpool`` conv2's input; conv2 adds a and writes the next inner
    stream and its activation (the second: its activation alone); the 1x1
    conv up adds x and writes the next x and its activation (the last
    block: the activation alone, the trunk norm's, for the heads). Returns
    that activation."""
    m = x.shape[0]

    def new(channels):
        return torch.empty(m, channels, dtype=torch.bfloat16,
                           device=x.device)

    for i, block in enumerate(net.blocks):
        last = i + 1 == len(net.blocks)
        after = net.trunk_norm if last else net.blocks[i + 1].pre.bn
        a, u = new(block.pre.conv.out_channels), new(
            block.pre.conv.out_channels)
        conv_pre(xa, next(weights), block.pre, hw, raw=a,
                 act=(u, block.inner[0].conv1.bn))
        for j, inner in enumerate(block.inner):
            w1 = next(weights)
            if inner.gpool is not None:
                r = new(inner.conv1.conv.out_channels)
                g = new(inner.gpool.conv.out_channels)
                conv_pre(u, w1, inner.conv1, hw, raw=r)
                conv(u, next(weights), inner.gpool, hw, g)
                t = new(inner.conv1.conv.out_channels)
                gpool(r, g, inner, hw, t)
            else:
                t = new(inner.conv1.conv.out_channels)
                conv(u, w1, SimpleNamespace(conv=inner.conv1.conv,
                                            bn=inner.conv2.bn), hw, t)
            w2 = next(weights)
            if j + 1 < len(block.inner):
                b, u = new(a.shape[1]), new(a.shape[1])
                conv_pre(t, w2, inner.conv2, hw, raw=b,
                         act=(u, block.inner[j + 1].conv1.bn), skip=a)
                a = b
            else:
                u = new(a.shape[1])
                conv_pre(t, w2, inner.conv2, hw, act=(u, block.post.bn),
                         skip=a)
        out, xa = (None if last else new(x.shape[1])), new(x.shape[1])
        conv_pre(u, next(weights), block.post, hw, raw=out, act=(xa, after),
                 skip=x)
        x = out
    return xa


# The forwards recorded into the CUDA graph being captured, while a
# ``recording()`` is open.
_RECORDING: Optional[List["FusedForward"]] = None


@contextlib.contextmanager
def recording():
    """Open around a CUDA graph capture: yields the list of the
    ``FusedForward``s whose forward was recorded into the graph, each once.
    Whoever replays the graph calls their ``pack_weights`` before its
    replays."""
    global _RECORDING
    outer, _RECORDING = _RECORDING, []
    try:
        yield _RECORDING
    finally:
        _RECORDING = outer


class FusedForward:
    """``net``'s eval-mode forward: the kernels for CUDA observations, the
    plain version for CPU ones (any other device raises). Observations are
    (B, H, W, C_in) float32 NHWC; returns (logits (B, A), value (B,)),
    float32.

    ``packed``: the bf16 buffer of ``pack_layout``'s length that a forward
    recorded into a CUDA graph reads and ``pack_weights`` fills."""

    def __init__(self, net: PolicyValueNet):
        self.net = net
        self._layout = None  # (weight addresses, pack table)
        self.packed: Optional[torch.Tensor] = None

    def __call__(self, obs: torch.Tensor):
        if obs.device.type == "cpu":
            return forward_plain(self.net, obs)
        if obs.device.type != "cuda":
            raise ValueError(f"no fused forward for device {obs.device}")
        return self._forward_cuda(obs)

    def _table(self, device, capturing: bool = False):
        """The pack table on ``device`` and its rows, rebuilt when a weight's
        address changed, and ``packed``, allocated when its length changed;
        neither while ``capturing`` (a host copy cannot be captured, and the
        buffer lives outside any graph's memory)."""
        rows, length = pack_layout(self.net)
        addresses = tuple(row[0] for row in rows)
        sized = self.packed is not None and self.packed.numel() == length
        if self._layout is None or self._layout[0] != addresses or not sized:
            if capturing:
                raise RuntimeError("the fused forward's first call for a net "
                                   "must run outside a CUDA graph capture")
            table = torch.tensor(rows, dtype=torch.int64, device=device)
            self._layout = (addresses, table)
            if not sized:
                self.packed = torch.empty(length, dtype=torch.bfloat16,
                                          device=device)
        return self._layout[1], rows, length

    def pack_weights(self) -> None:
        """One ``pack`` launch, on the current stream, of the live conv
        weights into ``packed``: what the forwards recorded into a graph
        read on its replays."""
        table, rows, _ = self._table(self.net.stem.conv.weight.device)
        pack(table, self.packed, rows)
        pack.search_launches += 1

    def _forward_cuda(self, obs: torch.Tensor):
        net = self.net
        stem = net.stem.conv
        if obs.dtype != torch.float32 or obs.dim() != 4:
            raise ValueError(f"observations must be (B, H, W, C) float32; got "
                             f"{tuple(obs.shape)} {obs.dtype}")
        bsz, h, w, cin = obs.shape
        p_out = net.policy_conv.conv.out_channels
        v_out = net.value_conv.conv.out_channels
        if (cin != stem.in_channels
                or net.policy_dense.in_features != h * w * p_out):
            raise ValueError(f"observations {tuple(obs.shape)} do not fit the "
                             f"net (C_in {stem.in_channels}, policy features "
                             f"{net.policy_dense.in_features})")
        if stem.weight.device != obs.device:
            raise ValueError(f"net on {stem.weight.device}, observations on "
                             f"{obs.device}")
        if net.cfg.filters % K_STEP:
            raise ValueError(f"the fused forward takes filters that are a "
                             f"multiple of {K_STEP}; got {net.cfg.filters}")
        if not se_fits(net):
            raise ValueError(f"the se kernel does not take gates of "
                             f"{net.cfg.filters} filters at ratio "
                             f"{net.cfg.se_ratio}")
        if not nested_fits(net):
            raise ValueError(
                f"the fused forward takes nested bottleneck widths that are "
                f"multiples of {K_STEP}; got mid {net.cfg.mid_filters}, "
                f"pooled {net.cfg.gpool_filters}")
        obs = obs.contiguous()
        capturing = torch.cuda.is_current_stream_capturing()
        table, rows, length = self._table(obs.device, capturing)
        if capturing:
            if _RECORDING is None:
                raise RuntimeError("a fused forward recorded into a CUDA "
                                   "graph needs an open fused_net.recording()"
                                   ": nothing would pack its weights")
            if self not in _RECORDING:
                _RECORDING.append(self)
            packed = self.packed
        else:
            packed = torch.empty(length, dtype=torch.bfloat16,
                                 device=obs.device)
            pack(table, packed, rows)
        weights = iter(packed[offset:offset + cout * padded_depth(cin, taps)]
                       for _, offset, cout, cin, taps in rows)

        m = bsz * h * w
        filters = net.cfg.filters
        x = torch.empty(m, filters, dtype=torch.bfloat16, device=obs.device)
        if nested(net):
            xa = torch.empty_like(x)
            conv(obs, next(weights), net.stem, (h, w), x,
                 act=(xa, net.blocks[0].pre.bn))
            x = _nested_cuda(net, x, xa, weights, (h, w))
        else:
            conv(obs, next(weights), net.stem, (h, w), x)
        for block in net.blocks if not nested(net) else ():
            y = torch.empty_like(x)
            conv(x, next(weights), block.conv1, (h, w), y)
            out = torch.empty_like(x)
            w2 = next(weights)
            if block.se is not None:
                conv(y, w2, block.conv2, (h, w), out, relu=False)
                se(x, out, block, (h, w), y)  # conv1's output is spent
                x = y
                continue
            skip = (x if block.proj is None
                    else (x, next(weights), block.proj))
            conv(y, w2, block.conv2, (h, w), out, residual=skip)
            x = out
        p = torch.empty(bsz, h * w * p_out, device=obs.device)
        v = torch.empty(bsz, h * w * v_out, device=obs.device)
        heads(x, net, p, v)
        return _dense_heads(net, p, v)
