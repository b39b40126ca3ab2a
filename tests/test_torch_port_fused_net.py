"""The fused inference forward of the policy-value net (ops/fused_net.py)
on the CPU: its plain version against the Flax net and the module path at
Connect-4 and chess shapes, which evaluations take it, and the wrapper's
CUDA launches driven through stand-ins of csrc/fused_net.cu's entry points
written in PyTorch, which read and write the memory at the pointers the
wrapper passes: their result against the Flax net, and the live weights
reaching every forward."""

import copy
import ctypes
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from custom_alphazero_tpu.config import ModelConfig as JaxModelConfig
from custom_alphazero_tpu.models.policy_value import (
    PolicyValueNet as JaxPolicyValueNet,
)
from custom_alphazero_tpu_torch.config import ModelConfig
from custom_alphazero_tpu_torch.models.convert import from_jax_variables
from custom_alphazero_tpu_torch.models.policy_value import PolicyValueNet
from custom_alphazero_tpu_torch.ops import fused_net
from custom_alphazero_tpu_torch.runtime.evaluate import make_evaluate_fn
from custom_alphazero_tpu_torch.runtime.train import (
    init_train_state,
    make_train_step,
)

# (actions, board (H, W), input channels): Connect-4, a 5x4 Connect-N and
# chess.
SHAPES = {"c4": (7, (6, 7), 4), "chess": (1968, (8, 8), 118),
          "c5x4": (5, (4, 5), 4)}
SMALL = dict(depth=2, filters=16, value_hidden=32)
# The width of the nets that drive the kernels' launches: the fused forward
# takes filters that are a multiple of ``fused_net.K_STEP``.
WIDE = 64


def _net(shape: str, dtype: str = "bfloat16", seed: int = 0,
         projection: bool = True, depth: int = SMALL["depth"],
         filters: int = SMALL["filters"], se_ratio: int = 0):
    """An eval-mode net whose every parameter and running statistic is
    drawn, so each term of the epilogues matters; ``projection`` False:
    identity skips; ``se_ratio``: squeeze-excitation gates."""
    actions, hw, channels = SHAPES[shape]
    cfg = ModelConfig(**dict(SMALL, depth=depth, filters=filters),
                      compute_dtype=dtype, residual_projection=projection,
                      se_ratio=se_ratio)
    net = PolicyValueNet(actions, cfg, channels, hw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(net.named_parameters()) + list(
                net.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.25)
            elif name.endswith("bn.weight"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.dim() > 1:
                t.copy_(torch.randn(t.shape, generator=gen)
                        / t[0].numel() ** 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    return net.eval()


def _obs(shape: str, batch: int, seed: int = 1):
    _, (h, w), channels = SHAPES[shape]
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((batch, h, w, channels), generator=gen) < 0.3).float()


def _gap(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("batch", [1, 3, 1024])
@pytest.mark.parametrize("shape", ["c4", "chess"])
def test_plain_fused_forward_matches_module(shape, batch):
    obs = _obs(shape, batch)
    with torch.inference_mode():
        # float32: the same function up to the order of float32 sums and
        # BatchNorm's arithmetic (observed at most 5.4e-7).
        net = _net(shape, "float32")
        want = net(obs)
        assert _gap(fused_net.forward_plain(net, obs), want) < 1e-5
        # bf16: both paths round operands to bf16 (2**-9 relative); the
        # module also rounds each conv's output, its BatchNorm's and the
        # residual add's, the fused path each layer's output once. Each
        # sits a few bf16 steps from float32 over 5 layers (observed at
        # most 0.011 from float32 and 0.013 from each other, on logits up
        # to 0.7): held at 0.05.
        bf16 = _net(shape, "bfloat16")
        module = bf16(obs)
        fused = fused_net.forward_plain(bf16, obs)
    assert all(t.dtype == torch.float32 for t in fused)
    assert fused[0].shape == want[0].shape and fused[1].shape == want[1].shape
    assert _gap(module, want) < 0.05
    assert _gap(fused, want) < 0.05
    assert _gap(fused, module) < 0.05


def _flax_case(shape: str, batch: int, dtype: str,
               filters: int = SMALL["filters"]):
    """(Flax's logits and value in float32 and in bf16, the port's net in
    ``dtype`` built from the same variables, the observations). The
    variables are Flax's init after three train-mode updates of the batch
    statistics, with every bias and BatchNorm scale and offset then drawn,
    so each term of the epilogues matters."""
    actions, hw, channels = SHAPES[shape]
    obs = _obs(shape, batch).numpy()
    widths = dict(SMALL, filters=filters)
    jcfg = JaxModelConfig(**widths, compute_dtype="float32")
    flax_net = JaxPolicyValueNet(actions, jcfg)
    variables = flax_net.init(jax.random.PRNGKey(7), jnp.asarray(obs[:1]),
                              train=False)
    for _ in range(3):
        _, mutated = flax_net.apply(variables, jnp.asarray(obs[:16]),
                                    train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": mutated["batch_stats"]}
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.2, a.shape).astype(
            np.float32)) if a.ndim == 1 else np.asarray(a),
        jax.device_get(variables["params"]))
    variables = {"params": params,
                 "batch_stats": jax.device_get(variables["batch_stats"])}
    refs = {d: jax.device_get(JaxPolicyValueNet(
        actions, dataclasses.replace(jcfg, compute_dtype=d)).apply(
            variables, jnp.asarray(obs), train=False))
        for d in ("float32", "bfloat16")}
    net = from_jax_variables(
        variables["params"], variables["batch_stats"], actions,
        ModelConfig(**widths, compute_dtype=dtype), channels, hw,
        device="cpu")
    return refs, net, torch.from_numpy(obs)


# Tolerances against Flax. float32: as the module path's parity test holds
# it (tests/test_torch_port_net.py), the order of float32 sums only. bf16:
# within 1e-2 of Flax's float32 forward (observed at most 0.009, on logits
# up to 3.2), and within 2e-2 of Flax's bf16 forward. That is looser than
# the module path's 1e-2 there, on 16 Connect-4 rows with zero biases: here,
# with drawn biases and BatchNorm offsets and up to 1,024 rows, Flax's bf16
# forward itself lies up to 0.016 from its float32 forward, the module
# path up to 0.016 from Flax's bf16 and the fused forward up to 0.016.
FLAX_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
            "bfloat16": dict(rtol=0.0, atol=2e-2)}
BF16_FROM_FLOAT32 = dict(rtol=0.0, atol=1e-2)


def _assert_matches_flax(got, refs, dtype):
    for t, want in zip(got, refs[dtype]):
        np.testing.assert_allclose(t.numpy(), want, **FLAX_TOL[dtype])
    if dtype == "bfloat16":
        for t, want in zip(got, refs["float32"]):
            np.testing.assert_allclose(t.numpy(), want, **BF16_FROM_FLOAT32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 1024])
@pytest.mark.parametrize("shape", ["c4", "chess"])
def test_plain_fused_forward_matches_flax(shape, batch, dtype):
    refs, net, obs = _flax_case(shape, batch, dtype)
    with torch.inference_mode():
        got = fused_net.forward_plain(net, obs)
        module = net(obs)
    _assert_matches_flax(got, refs, dtype)
    # The module path, held to the same bounds on the same inputs.
    for t, want in zip(module, refs[dtype]):
        np.testing.assert_allclose(t.numpy(), want, **FLAX_TOL[dtype])


def _evaluations(net, obs):
    """(evaluate's probabilities and value, plain-version calls in it)."""
    calls = fused_net.forward_plain.calls
    out = make_evaluate_fn(net)(obs)
    return out, fused_net.forward_plain.calls - calls


class _CudaObservations:
    """What ``applies`` reads of a CUDA tensor: its device."""
    device = torch.device("cuda")


# The nets' filters by case: only multiples of K_STEP take the fused forward.
APPLIES_FILTERS = {"filters": 12, "16 filters": 16, "96 filters": 96}


@pytest.mark.parametrize("case", ["eval bf16", "training", "float32",
                                  "cpu", "filters", "16 filters",
                                  "96 filters"])
def test_applies_to_eval_bf16_nets_on_cuda_only(case):
    """An eval-mode bf16 net of 64 filters on CUDA observations takes the
    fused forward; a training or float32 net, CPU observations, and 12, 16
    or 96 filters (not multiples of K_STEP) take the module path."""
    net = _net("c4", "float32" if case == "float32" else "bfloat16",
               filters=APPLIES_FILTERS.get(case, WIDE))
    obs = _obs("c4", 2) if case == "cpu" else _CudaObservations()
    if case == "training":
        net.train()
    assert fused_net.applies(net, obs) == (case == "eval bf16")


def test_cpu_tensors_take_the_module_path():
    net, obs = _net("c4"), _obs("c4", 8)
    (probs, value), calls = _evaluations(net, obs)
    with torch.inference_mode():
        logits, want_value = net(obs)
    assert calls == 0
    assert torch.equal(probs, torch.softmax(logits, dim=-1))
    assert torch.equal(value, want_value)


@pytest.mark.parametrize("case", ["training", "float32"])
def test_training_and_float32_nets_take_the_module_path(case):
    obs = _obs("c4", 8)
    net = _net("c4", "float32" if case == "float32" else "bfloat16")
    if case == "training":
        net.train()
    twin = copy.deepcopy(net)  # a training forward moves the statistics
    (probs, value), calls = _evaluations(net, obs)
    with torch.inference_mode():
        logits, want_value = twin(obs)
    assert calls == 0
    assert torch.equal(probs, torch.softmax(logits, dim=-1))
    assert torch.equal(value, want_value)


def test_evaluate_takes_the_fused_forward_where_it_applies(monkeypatch):
    """Where ``applies`` holds, ``evaluate`` is the softmax of the fused
    forward (here its CPU route, the plain version)."""
    monkeypatch.setattr(fused_net, "applies", lambda net, obs: True)
    net, obs = _net("c4"), _obs("c4", 8)
    (probs, value), calls = _evaluations(net, obs)
    logits, want_value = fused_net.forward_plain(net, obs)
    assert calls == 1
    assert torch.equal(probs, torch.softmax(logits, dim=-1))
    assert torch.equal(value, want_value)


# ---------------------------------------------------------------------------
# The wrapper's CUDA launches, through PyTorch stand-ins of the entry points
# ---------------------------------------------------------------------------


def _at(address: int, shape, dtype) -> torch.Tensor:
    """The CPU tensor of ``shape`` at ``address`` (sharing its memory)."""
    size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buffer = (ctypes.c_char * size).from_address(address)
    return torch.frombuffer(buffer, dtype=dtype).view(shape)


def _epilogue(z, bn, n, eps):
    bias, gamma, beta, mean, var = (_at(a, (n,), torch.float32) for a in bn)
    scale = gamma / torch.sqrt(var + eps)
    return z * scale + ((bias - mean) * scale + beta)


def _activated(y, bn, n, eps):
    """relu(n(y)) of rounded (M, n) rows ``y``, the norm's pointers as the
    entry points take them (its bias slot unread)."""
    _, gamma, beta, mean, var = (_at(a, (n,), torch.float32) for a in bn)
    scale = gamma / torch.sqrt(var + eps)
    return torch.relu(y.float() * scale + ((-mean) * scale + beta))


class _StandIns:
    """csrc/fused_net.cu's six entry points in PyTorch, with the same
    arguments: pointers as integers, read and written in place. Each call
    is recorded with its shape arguments."""

    def __init__(self):
        self.calls = []
        self.packed_into = []  # each pack's output address
        self.weights = []  # each conv launch's packed weight address

    def fused_net_pack(self, table, layers, tiles, out, stream):
        self.calls.append(("pack", layers, tiles))
        self.packed_into.append(out)
        for address, offset, cout, cin, taps in _at(
                table, (layers, 5), torch.int64).tolist():
            w = _at(address, (cout, cin, taps), torch.float32)
            rows = _at(out + 2 * offset,
                       (cout, fused_net.padded_depth(cin, taps)),
                       torch.bfloat16)
            rows.zero_()
            rows[:, :cin * taps] = w.permute(0, 2, 1).reshape(cout, -1)
        return 0

    def fused_net_conv(self, x, w, C, ks, *args):
        # The stem: float32 observations, no skip (the entry point takes
        # neither a dtype, a skip nor a tile); with out2, its output's next
        # norm and ReLU too.
        bn, nbn = args[:5], args[5:10]
        out, out2, M, H, W, N, eps, stream = args[10:]
        self.calls.append(("conv", C, ks) if out2 is None
                          else ("conv", C, ks, "act"))
        self.weights.append(w)
        y = _epilogue(self._sums(_at(x, (M, C), torch.float32), w, C, ks, H,
                                 W, N), bn, N, eps)
        raw = _at(out, (M, N), torch.bfloat16)
        raw.copy_(torch.relu(y))
        if out2 is not None:
            _at(out2, (M, N), torch.bfloat16).copy_(
                _activated(raw, nbn, N, eps))
        return 0

    def fused_net_conv_pipelined(self, x, w, C, ks, *args):
        bn, (r, wr), rbn = args[:5], args[5:7], args[7:12]
        residual, out, out2, M, H, W, N, eps, bm, width, stream = args[12:]
        self.calls.append(("conv_pipelined", C, ks, residual, bm))
        self.weights.append(w)
        # The tile ``conv_tile`` gives the shape on an H100's 132 SMs: for
        # outputs that are a multiple of 128 filters, 128 filters wide.
        assert (bm, width) == fused_net.conv_tile(M, N, C, ks * ks, 132,
                                                  projection=residual == 1)
        if N % fused_net.TILE_FILTERS == 0:
            assert width == fused_net.TILE_FILTERS
        if residual >= 4:
            # The pre-activation epilogue: the conv's bias, the identity
            # tile (5), the rounded sum and its next norm and ReLU.
            assert out is not None or out2 is not None
            y = self._sums(_at(x, (M, C), torch.bfloat16), w, C, ks, H, W,
                           N) + _at(bn[0], (N,), torch.float32)
            if residual == 5:
                y = y + _at(r, (M, N), torch.bfloat16).float()
            raw = y.to(torch.bfloat16)
            if out is not None:
                _at(out, (M, N), torch.bfloat16).copy_(raw)
            if out2 is not None:
                _at(out2, (M, N), torch.bfloat16).copy_(
                    _activated(raw, rbn, N, eps))
            return 0
        assert out2 is None
        y = _epilogue(self._sums(_at(x, (M, C), torch.bfloat16), w, C, ks, H,
                                 W, N), bn, N, eps)
        if residual == 1:
            rt = _at(r, (M, N), torch.bfloat16)
            y = y + _epilogue(self._sums(rt, wr, N, 1, H, W, N), rbn, N, eps)
        elif residual == 2:
            y = y + _at(r, (M, N), torch.bfloat16).float()
        _at(out, (M, N), torch.bfloat16).copy_(
            y if residual == 3 else torch.relu(y))
        return 0

    def fused_net_se(self, x, y, B, HW, C, R, w1, b1, w2, b2, out, stream):
        self.calls.append(("se", B, HW, C, R))
        xt = _at(x, (B, HW, C), torch.bfloat16).float()
        yt = _at(y, (B, HW, C), torch.bfloat16).float()
        hidden = torch.relu(yt.mean(dim=1) @ _at(w1, (R, C), torch.float32).T
                            + _at(b1, (R,), torch.float32))
        g, o = (hidden @ _at(w2, (2 * C, R), torch.float32).T
                + _at(b2, (2 * C,), torch.float32)).chunk(2, dim=1)
        _at(out, (B, HW, C), torch.bfloat16).copy_(torch.relu(
            xt + torch.sigmoid(g)[:, None] * yt + o[:, None]))
        return 0

    def fused_net_gpool(self, g, r, B, HW, G, R, wg, scale, gamma, beta,
                        mean, var, eps, out, stream):
        self.calls.append(("gpool", B, HW, G, R))
        gt = _at(g, (B, HW, G), torch.bfloat16).float()
        mean_g = gt.sum(dim=1) / HW
        pooled = torch.cat([mean_g, mean_g * scale, gt.amax(dim=1)], dim=1)
        bias = pooled @ _at(wg, (R, 3 * G), torch.float32).T
        y = _at(r, (B, HW, R), torch.bfloat16).float() + bias[:, None]
        _at(out, (B, HW, R), torch.bfloat16).copy_(_activated(
            y.view(B * HW, R), (gamma, gamma, beta, mean, var), R,
            eps).view(B, HW, R))
        return 0

    @staticmethod
    def _sums(inp, packed, width, k, H, W, N):
        """Float32 sums of the conv of the (M, width) NHWC rows ``inp``,
        rounded to bf16, with the packed weight at ``packed``."""
        nchw = inp.view(-1, H, W, width).permute(0, 3, 1, 2)
        rows = _at(packed, (N, fused_net.padded_depth(width, k * k)),
                   torch.bfloat16)
        kernel = rows[:, :k * k * width].reshape(N, k, k, width)
        z = F.conv2d(nchw.to(torch.bfloat16).float(),
                     kernel.permute(0, 3, 1, 2).float(), padding=k // 2)
        return z.permute(0, 2, 3, 1).reshape(-1, N)

    def fused_net_heads(self, x, M, C, wp, *args):
        pbn, P, wv, vbn, V = args[:5], args[5], args[6], args[7:12], args[12]
        eps, p, v, stream = args[13:]
        self.calls.append(("heads", C, P, V))
        xt = _at(x, (M, C), torch.bfloat16).float()
        for w, bn, n, dst in ((wp, pbn, P, p), (wv, vbn, V, v)):
            wk = _at(w, (n, C), torch.float32).to(torch.bfloat16).float()
            _at(dst, (M, n), torch.float32).copy_(
                torch.relu(_epilogue(xt @ wk.T, bn, n, eps)))
        return 0


@pytest.fixture
def stand_ins(monkeypatch):
    lib = _StandIns()
    monkeypatch.setattr(fused_net, "_LIB", lib)
    monkeypatch.setattr(fused_net, "_stream", lambda device: None)
    monkeypatch.setattr(fused_net, "_sm_count", lambda device: 132)
    # No CUDA graph is being captured, unless a test says so.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return lib


def _block_calls(m: int, depth: int, skip: int):
    """The stand-ins' records of a WIDE net's block convs at M = ``m``: each
    block's conv1, then its conv2 with the skip (1 projection, 2 identity),
    on ``conv_tile``'s tiles."""
    plain = fused_net.conv_tile(m, WIDE, WIDE, 9, 132)[0]
    with_skip = fused_net.conv_tile(m, WIDE, WIDE, 9, 132,
                                    projection=skip == 1)[0]
    return [call for _ in range(depth) for call in (
        ("conv_pipelined", WIDE, 3, 0, plain),
        ("conv_pipelined", WIDE, 3, skip, with_skip))]


@pytest.mark.parametrize("projection", [True, False])
@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("shape", ["c4", "chess"])
def test_launch_sequence_and_counters(stand_ins, shape, batch, projection):
    """The wrapper's launches for CUDA tensors, run on the CPU through the
    stand-ins, for a net of 64 filters with projections or identity skips:
    the stem on its kernel, every block conv on the pipelined kernel with
    ``conv_tile``'s tile (the stand-in holds each to it). The result is the
    plain version's and, with projections, the Flax net's within the bf16
    bounds above; each counter counts its launches."""
    if projection:
        refs, net, obs = _flax_case(shape, batch, "bfloat16", filters=WIDE)
    else:
        net = _net(shape, projection=False, filters=WIDE)
        obs = _obs(shape, batch)
    counts = (fused_net.pack.launches, fused_net.conv.launches,
              fused_net.conv.identity_launches, fused_net.heads.launches)
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        got = forward._forward_cuda(obs)
        got_again = forward._forward_cuda(obs)
        want = fused_net.forward_plain(net, obs)
    depth = len(net.blocks)
    assert (fused_net.pack.launches - counts[0],
            fused_net.conv.launches - counts[1],
            fused_net.conv.identity_launches - counts[2],
            fused_net.heads.launches - counts[3]) == (
                2, 2 * (1 + 2 * depth), 0 if projection else 2 * depth, 2)
    rows = fused_net.pack_layout(net)[0]
    channels = SHAPES[shape][2]
    tile = fused_net.PACK_TILE
    tiles = max(-(-cout // tile) * (fused_net.padded_depth(cin, taps) // tile)
                for _, _, cout, cin, taps in rows)
    one = ([("pack", len(rows), tiles), ("conv", channels, 3)]
           + _block_calls(obs.shape[0] * obs.shape[1] * obs.shape[2], depth,
                          1 if projection else 2)
           + [("heads", WIDE, 2, 1)])
    assert stand_ins.calls == one + one
    if projection:
        _assert_matches_flax(got, refs, "bfloat16")
    # The plain version's arithmetic: float32 sums of one conv in another
    # order may move a layer's bf16 rounding by one step (2**-8 relative).
    assert _gap(got, want) < 1e-2
    assert _gap(got_again, got) == 0.0


def _nested_net(shape: str, seed: int = 0):
    """An eval-mode bf16 nested bottleneck net whose widths take N1 (128
    filters, mid 128, 64 of them pooled in block 1 of 2), every parameter
    and running statistic drawn as ``_net`` draws them."""
    actions, hw, channels = SHAPES[shape]
    cfg = ModelConfig(depth=2, filters=128, value_hidden=32,
                      residual_projection=False, mid_filters=128,
                      gpool_filters=64, gpool_blocks=(1,))
    net = PolicyValueNet(actions, cfg, channels, hw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(net.named_parameters()) + list(
                net.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.25)
            elif name.endswith(("bn.weight", "norm.weight")):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.dim() > 1:
                t.copy_(torch.randn(t.shape, generator=gen)
                        / t[0].numel() ** 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    return net.eval()


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("shape", ["c4", "chess"])
def test_nested_launch_sequence_and_counters(stand_ins, shape, batch):
    """A nested bottleneck net's launches through the stand-ins: the stem
    with its second output, then per block the 1x1 conv down (raw and
    activation), each inner block's conv1 (in the pooled block: its
    regular channels raw, the pooled branch's conv, the gpool launch), its
    conv2 adding the inner stream, the 1x1 conv up adding the block input
    (the last block: its activation alone), each on ``conv_tile``'s tile;
    the result the plain version's, two forwards equal, each counter
    counting its launches."""
    net, obs = _nested_net(shape), _obs(shape, batch)
    counters = (fused_net.conv.launches, fused_net.conv.pointwise_launches,
                fused_net.conv.preact_launches, fused_net.gpool.launches,
                fused_net.conv.identity_launches, fused_net.heads.launches)
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        got = forward._forward_cuda(obs)
        got_again = forward._forward_cuda(obs)
        want = fused_net.forward_plain(net, obs)
    counts = tuple(c - before for c, before in zip(
        (fused_net.conv.launches, fused_net.conv.pointwise_launches,
         fused_net.conv.preact_launches, fused_net.gpool.launches,
         fused_net.conv.identity_launches, fused_net.heads.launches),
        counters))
    # Per forward: 1 + 6 x 2 + 1 convs, 2 x 2 pointwise, 1 + 2 + 2 + 1
    # dual outputs, one gpool.
    assert counts == (2 * 14, 2 * 4, 2 * 6, 2, 0, 2)
    m = obs.shape[0] * obs.shape[1] * obs.shape[2]

    def tile(n, cin, taps):
        return fused_net.conv_tile(m, n, cin, taps, 132)[0]

    channels = SHAPES[shape][2]
    block1 = [("conv_pipelined", 128, 1, 4, tile(128, 128, 1)),
              ("conv_pipelined", 128, 3, 4, tile(64, 128, 9)),
              ("conv_pipelined", 128, 3, 0, tile(64, 128, 9)),
              ("gpool", obs.shape[0], m // obs.shape[0], 64, 64),
              ("conv_pipelined", 64, 3, 5, tile(128, 64, 9)),
              ("conv_pipelined", 128, 3, 0, tile(128, 128, 9)),
              ("conv_pipelined", 128, 3, 5, tile(128, 128, 9)),
              ("conv_pipelined", 128, 1, 5, tile(128, 128, 1))]
    block2 = [block1[0], block1[5], block1[6], block1[5], block1[6],
              block1[7]]
    rows = fused_net.pack_layout(net)[0]
    size = fused_net.PACK_TILE
    tiles = max(-(-cout // size) * (fused_net.padded_depth(cin, taps) // size)
                for _, _, cout, cin, taps in rows)
    one = ([("pack", len(rows), tiles), ("conv", channels, 3, "act")]
           + block1 + block2 + [("heads", 128, 2, 1)])
    assert stand_ins.calls == one + one
    assert _gap(got, want) < 1e-2
    assert _gap(got_again, got) == 0.0


def test_inplace_load_and_train_step_reach_the_next_fused_forward(
        stand_ins):
    """``promote``'s in-place ``load_state_dict`` and a train step change
    the next forward of the wrapper's CUDA route, which equals the plain
    version of the changed net; both keep every conv weight's address
    (what a captured graph and the pack table read); replacing a weight
    moves it."""
    obs = _obs("c4", 16)
    cfg = ModelConfig(**dict(SMALL, filters=WIDE))
    gen = torch.Generator().manual_seed(3)
    state = init_train_state(7, cfg, gen, (6, 7, 4), device="cpu")
    net = state.net
    forward = fused_net.FusedForward(net)
    addresses = [row[0] for row in fused_net.pack_layout(net)[0]]

    def fused():
        with torch.inference_mode():
            return forward._forward_cuda(obs)

    def plain():
        with torch.inference_mode():
            return fused_net.forward_plain(net, obs)

    before = fused()
    other = _net("c4", seed=5, filters=WIDE)
    net.load_state_dict(other.state_dict())
    promoted = fused()
    assert _gap(promoted, before) > 1e-3
    assert _gap(promoted, plain()) < 1e-2

    step = make_train_step(cfg)
    target_pi = torch.softmax(torch.randn(16, 7, generator=gen), dim=-1)
    target_z = torch.randint(-1, 2, (16,), generator=gen).float()
    state, _ = step(state, obs, target_pi, target_z)
    assert not net.training
    trained = fused()
    assert _gap(trained, promoted) > 1e-6
    assert _gap(trained, plain()) < 1e-2
    assert [row[0] for row in fused_net.pack_layout(net)[0]] == addresses

    net.stem.conv.weight = torch.nn.Parameter(net.stem.conv.weight.clone())
    assert fused_net.pack_layout(net)[0][0][0] != addresses[0]


def _recorded_forward(monkeypatch, forward, obs):
    """``forward``'s CUDA route as recorded into a CUDA graph (the stream
    reads as capturing) inside an open ``recording()``: (its output, the
    forwards the recording collected)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    try:
        with fused_net.recording() as recorded, torch.inference_mode():
            out = forward._forward_cuda(obs)
    finally:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
    return out, recorded


def _inside(address: int, buffer: torch.Tensor) -> bool:
    return (buffer.data_ptr() <= address
            < buffer.data_ptr() + buffer.numel() * buffer.element_size())


def test_recorded_forward_reads_the_packed_buffer_and_registers(
        stand_ins, monkeypatch):
    """A forward made while the stream is being captured launches no pack,
    reads every conv weight from its ``FusedForward``'s persistent buffer
    (as ``pack_weights`` left it: the eager forward's result bit for bit)
    and registers itself, once, with the open recording. Without an open
    recording, or before any eager call allocated the buffer, it raises."""
    net, obs = _net("c4", filters=WIDE), _obs("c4", 16)
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        eager = forward._forward_cuda(obs)
    forward.pack_weights()
    stand_ins.calls.clear()
    stand_ins.weights.clear()
    launches = fused_net.pack.launches
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with fused_net.recording() as recorded, torch.inference_mode():
        got = forward._forward_cuda(obs)
        again = forward._forward_cuda(obs)
    assert recorded == [forward]
    assert fused_net.pack.launches == launches
    assert all(call[0] != "pack" for call in stand_ins.calls)
    assert stand_ins.weights[0] == forward.packed.data_ptr()
    assert all(_inside(w, forward.packed) for w in stand_ins.weights)
    for x, y, z in zip(got, again, eager):
        assert torch.equal(x, z) and torch.equal(y, z)
    with pytest.raises(RuntimeError), torch.inference_mode():
        forward._forward_cuda(obs)  # no recording open
    with pytest.raises(RuntimeError), fused_net.recording(), \
            torch.inference_mode():
        fused_net.FusedForward(net)._forward_cuda(obs)  # never called eagerly


def test_eager_forward_packs_once_a_call_into_a_fresh_buffer(stand_ins):
    """Outside a capture every forward launches one pack, into a buffer of
    its own (not the persistent one) that its convs read; no search pack
    is counted."""
    net, obs = _net("c4", filters=WIDE), _obs("c4", 8)
    forward = fused_net.FusedForward(net)
    launches = fused_net.pack.launches
    search_launches = fused_net.pack.search_launches
    convs = 1 + 2 * len(net.blocks)
    with torch.inference_mode():
        for call in range(3):
            forward._forward_cuda(obs)
            out = stand_ins.packed_into[-1]
            assert out != forward.packed.data_ptr()
            assert stand_ins.weights[-convs] == out
            assert len(stand_ins.packed_into) == call + 1
    assert fused_net.pack.launches == launches + 3
    assert fused_net.pack.search_launches == search_launches


def test_pack_weights_keeps_the_buffer_address(stand_ins):
    """``pack_weights`` packs into the same buffer every call (its address
    is what a captured graph keeps), one launch each, counted as a search
    pack; eager forwards between them do not move it."""
    net, obs = _net("c4", filters=WIDE), _obs("c4", 4)
    forward = fused_net.FusedForward(net)
    forward.pack_weights()
    address = forward.packed.data_ptr()
    launches = fused_net.pack.launches
    search_launches = fused_net.pack.search_launches
    for _ in range(3):
        with torch.inference_mode():
            forward._forward_cuda(obs)
        forward.pack_weights()
        assert forward.packed.data_ptr() == address
        assert stand_ins.packed_into[-1] == address
    assert fused_net.pack.launches == launches + 6
    assert fused_net.pack.search_launches == search_launches + 3


def test_pack_weights_reaches_the_recorded_forward_after_load_and_train(
        stand_ins, monkeypatch):
    """A recorded forward reads the conv weights of the last
    ``pack_weights``: after ``promote``'s in-place ``load_state_dict`` and
    after a train step it differs from the eager forward until
    ``pack_weights`` runs, then equals the plain version of the changed
    net and, bit for bit, the eager forward."""
    obs = _obs("c4", 16)
    cfg = ModelConfig(**dict(SMALL, filters=WIDE))
    gen = torch.Generator().manual_seed(3)
    state = init_train_state(7, cfg, gen, (6, 7, 4), device="cpu")
    net = state.net
    forward = fused_net.FusedForward(net)

    def eager():
        with torch.inference_mode():
            return forward._forward_cuda(obs)

    def plain():
        with torch.inference_mode():
            return fused_net.forward_plain(net, obs)

    def recorded():
        out, forwards = _recorded_forward(monkeypatch, forward, obs)
        assert forwards == [forward]
        return out

    def equal(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    eager()
    forward.pack_weights()
    address = forward.packed.data_ptr()
    before = recorded()
    assert equal(before, eager())

    net.load_state_dict(_net("c4", seed=5, filters=WIDE).state_dict())
    assert not equal(recorded(), eager())  # the old conv weights
    forward.pack_weights()
    promoted = recorded()
    assert _gap(promoted, before) > 1e-3
    assert _gap(promoted, plain()) < 1e-2
    assert equal(promoted, eager())

    step = make_train_step(cfg)
    target_pi = torch.softmax(torch.randn(16, 7, generator=gen), dim=-1)
    target_z = torch.randint(-1, 2, (16,), generator=gen).float()
    state, _ = step(state, obs, target_pi, target_z)
    assert not equal(recorded(), eager())
    forward.pack_weights()
    trained = recorded()
    assert _gap(trained, promoted) > 1e-6
    assert _gap(trained, plain()) < 1e-2
    assert equal(trained, eager())
    assert forward.packed.data_ptr() == address


def test_wrapper_refuses_what_the_kernels_do_not_take():
    forward = fused_net.FusedForward(_net("c4", filters=WIDE))
    with pytest.raises(ValueError):
        forward._forward_cuda(_obs("chess", 2))
    with pytest.raises(ValueError):
        forward._forward_cuda(_obs("c4", 2).double())
    with pytest.raises(ValueError):
        forward(_obs("c4", 2).to("meta"))
    # 16 filters: not a multiple of the pipelined kernel's K step.
    with pytest.raises(ValueError):
        fused_net.FusedForward(_net("c4"))._forward_cuda(_obs("c4", 2))


def test_cpu_call_runs_the_plain_version():
    net, obs = _net("chess"), _obs("chess", 3)
    calls = fused_net.forward_plain.calls
    with torch.inference_mode():
        got = fused_net.FusedForward(net)(obs)
        want = fused_net.forward_plain(net, obs)
    assert fused_net.forward_plain.calls - calls == 2
    assert _gap(got, want) == 0.0


# ---------------------------------------------------------------------------
# Identity skips (``residual_projection=False``)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [3, 256])
@pytest.mark.parametrize("shape", ["c4", "c5x4", "chess"])
def test_plain_fused_forward_matches_module_identity(shape, batch):
    """The plain version of an identity-skip net against its module at the
    bounds of ``test_plain_fused_forward_matches_module``: float32 the same
    function up to the order of sums, bf16 within 0.05 (depth 3)."""
    obs = _obs(shape, batch)
    with torch.inference_mode():
        net = _net(shape, "float32", projection=False, depth=3)
        want = net(obs)
        assert _gap(fused_net.forward_plain(net, obs), want) < 1e-5
        bf16 = _net(shape, "bfloat16", projection=False, depth=3)
        module = bf16(obs)
        fused = fused_net.forward_plain(bf16, obs)
    assert all(t.dtype == torch.float32 for t in fused)
    assert _gap(module, want) < 0.05
    assert _gap(fused, want) < 0.05
    assert _gap(fused, module) < 0.05


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("shape", ["c4", "c5x4"])
def test_launch_sequence_and_counters_identity(stand_ins, shape, batch):
    """A 64-filter identity-skip net's launches through the stand-ins: one
    conv a layer (no projection in the pack), each block's second conv on
    the pipelined kernel adding the block input (residual 2, counted by
    ``conv.identity_launches``); the result is the plain version's and,
    within the bf16 bound, the module's in float32."""
    net = _net(shape, projection=False, depth=3, filters=WIDE)
    twin = _net(shape, "float32", projection=False, depth=3, filters=WIDE)
    obs = _obs(shape, batch)
    counts = (fused_net.conv.launches, fused_net.conv.identity_launches)
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        got = forward._forward_cuda(obs)
        want = fused_net.forward_plain(net, obs)
        want32 = twin(obs)
    depth = len(net.blocks)
    assert (fused_net.conv.launches - counts[0],
            fused_net.conv.identity_launches - counts[1]) == (
                1 + 2 * depth, depth)
    rows = fused_net.pack_layout(net)[0]
    assert len(rows) == 1 + 2 * depth
    assert [r[0] for r in rows] == [b.conv.weight.data_ptr() for b in
                                    fused_net.trunk_convs(net)]
    assert stand_ins.calls[1:-1] == (
        [("conv", 4, 3)] + _block_calls(batch * math.prod(SHAPES[shape][1]),
                                        depth, 2))
    assert _gap(got, want) < 1e-2
    assert _gap(got, want32) < 0.05


# (label, M, N, C_in, taps, projection, expected tile cells): the
# benchmark's self-play shapes, the arenas' and serving's batches, a 19 x 256
# net at B=1,024 and at 3 boards, and chess-r5's self-play batch (B=128 on
# 8 x 8).
PLAN_CASES = [
    ("c4-r5 self-play", 1024 * 42, 128, 128, 9, False, 192),
    ("c4-r5 self-play, projection", 1024 * 42, 128, 128, 9, True, 128),
    ("c4az self-play", 256 * 42, 256, 256, 9, False, 192),
    ("c4-r5 arena", 256 * 42, 128, 128, 9, False, 128),
    ("c4-r5 serving batch", 16 * 42, 128, 128, 9, True, 128),
    ("19 x 256 at B=1024", 1024 * 42, 256, 256, 9, False, 192),
    ("19 x 256, 3 boards", 3 * 42, 256, 256, 9, False, 128),
    ("chess B=128", 128 * 64, 128, 128, 9, False, 128),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_conv_plan_by_shape(case):
    """The pipelined kernel's tile by shape, and its grid: every output
    cell x filter in exactly one CTA's tile, and no CTA without cells."""
    _, m, n, cin, taps, projection, want = case
    bm, bn = fused_net.conv_tile(m, n, cin, taps, 132, projection=projection)
    assert (bm, bn) == (want, fused_net.TILE_FILTERS)
    gx, gy = fused_net.conv_grid(bm, m, n)
    covered = np.zeros((gx * bm, gy * bn), dtype=np.int8)
    for bx in range(gx):
        for by in range(gy):
            covered[bx * bm:(bx + 1) * bm, by * bn:(by + 1) * bn] += 1
    assert (covered[:m, :n] == 1).all()
    assert (gx - 1) * bm < m and (gy - 1) * bn < n


# ---------------------------------------------------------------------------
# Squeeze-excitation gates (``se_ratio`` > 0)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [3, 256])
@pytest.mark.parametrize("shape", ["c4", "c5x4", "chess"])
def test_plain_fused_forward_matches_module_se(shape, batch):
    """The plain version of a net with squeeze-excitation gates against its
    module at the bounds of ``test_plain_fused_forward_matches_module``:
    float32 the same function up to the order of sums, bf16 within 0.05
    (depth 3)."""
    obs = _obs(shape, batch)
    with torch.inference_mode():
        net = _net(shape, "float32", projection=False, depth=3, se_ratio=4)
        want = net(obs)
        assert _gap(fused_net.forward_plain(net, obs), want) < 1e-5
        bf16 = _net(shape, "bfloat16", projection=False, depth=3, se_ratio=4)
        module = bf16(obs)
        fused = fused_net.forward_plain(bf16, obs)
    assert all(t.dtype == torch.float32 for t in fused)
    assert _gap(module, want) < 0.05
    assert _gap(fused, want) < 0.05
    assert _gap(fused, module) < 0.05


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("shape", ["c4", "c5x4"])
def test_launch_sequence_and_counters_se(stand_ins, shape, batch):
    """A 64-filter net with squeeze-excitation gates through the stand-ins:
    each block's second conv on the pipelined kernel without skip or ReLU
    (residual 3), then one ``se`` launch a block (``se.launches``); no
    gate weight in the pack; the result is the plain version's and, within
    the bf16 bound, the module's in float32; a second forward repeats it."""
    net = _net(shape, projection=False, depth=3, filters=WIDE, se_ratio=8)
    twin = _net(shape, "float32", projection=False, depth=3, filters=WIDE,
                se_ratio=8)
    obs = _obs(shape, batch)
    counts = (fused_net.conv.launches, fused_net.conv.identity_launches,
              fused_net.se.launches)
    forward = fused_net.FusedForward(net)
    with torch.inference_mode():
        got = forward._forward_cuda(obs)
        want = fused_net.forward_plain(net, obs)
        want32 = twin(obs)
    depth = len(net.blocks)
    assert (fused_net.conv.launches - counts[0],
            fused_net.conv.identity_launches - counts[1],
            fused_net.se.launches - counts[2]) == (1 + 2 * depth, 0, depth)
    rows = fused_net.pack_layout(net)[0]
    assert [r[0] for r in rows] == [b.conv.weight.data_ptr() for b in
                                    fused_net.trunk_convs(net)]
    assert len(rows) == 1 + 2 * depth
    cells = math.prod(SHAPES[shape][1])
    m = batch * cells
    plain = fused_net.conv_tile(m, WIDE, WIDE, 9, 132)[0]
    assert stand_ins.calls[1:-1] == [("conv", 4, 3)] + [
        call for _ in range(depth) for call in (
            ("conv_pipelined", WIDE, 3, 0, plain),
            ("conv_pipelined", WIDE, 3, 3, plain),
            ("se", batch, cells, WIDE, WIDE // 8))]
    assert _gap(got, want) < 1e-2
    assert _gap(got, want32) < 0.05
    with torch.inference_mode():
        assert _gap(forward._forward_cuda(obs), got) == 0.0


@pytest.mark.parametrize("filters, ratio, taken", [
    (64, 8, True), (128, 1, True), (192, 8, False), (256, 8, True),
    (256, 4, True), (512, 8, False), (512, 32, True), (64, 32, False)])
def test_applies_to_se_nets_the_se_kernel_takes(filters, ratio, taken):
    """The ``se`` kernel takes a gated net whose filters divide
    SE_MAX_FILTERS (a 16-byte chunk of channels a thread), whose hidden
    units are a multiple of 4 (16-byte vectors of the dense layers) and
    whose gate's dense weights fit an SM's shared memory with the sums (512
    filters at ratio 8: 384 KB); 192 filters, a multiple of K_STEP, 512 at
    ratio 8 and 64 at ratio 32 (2 hidden units) run the module path when
    gated and the fused forward when not."""
    net = PolicyValueNet(7, ModelConfig(depth=1, filters=filters,
                                        residual_projection=False,
                                        se_ratio=ratio)).eval()
    assert (fused_net.se_smem_bytes(filters, filters // ratio)
            <= fused_net.SE_SMEM_LIMIT) == (filters != 512 or ratio != 8)
    assert fused_net.applies(net, _CudaObservations()) == taken
    plain = PolicyValueNet(7, ModelConfig(depth=1, filters=filters,
                                          residual_projection=False)).eval()
    assert fused_net.applies(plain, _CudaObservations())
