"""The port's Gamma sampler in distribution, its import boundary, and its
entry points' refusal to fall back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from custom_alphazero_tpu_torch.config import (
    ConnectNConfig,
    MCTSConfig,
    ModelConfig,
    SelfPlayConfig,
)
from custom_alphazero_tpu_torch.envs.connect_n import ConnectN
from custom_alphazero_tpu_torch.ops import _build
from custom_alphazero_tpu_torch.ops.fused_mcts import FusedConnectNSearch
from custom_alphazero_tpu_torch.ops.fused_mcts_v2 import FusedConnectNSearchV2
from custom_alphazero_tpu_torch.ops.rng import safe_gamma
from custom_alphazero_tpu_torch.runtime.selfplay import make_selfplay_fn

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "custom_alphazero_tpu")


@pytest.mark.parametrize("alpha", [1.0, 2.5, 0.3])
def test_safe_gamma_moments(alpha):
    """Gamma(alpha): mean alpha, variance alpha (5-sigma bounds at 2e5)."""
    n = 200_000
    g = safe_gamma(torch.Generator().manual_seed(3), alpha, (n,), "cpu")
    assert g.dtype == torch.float32 and bool((g > 0).all())
    x = g.double().numpy()
    se_mean = np.sqrt(alpha / n)
    assert abs(x.mean() - alpha) < 5 * se_mean
    # Var of the sample variance: (mu4 - var^2)/n, mu4 = 3a^2 + 6a.
    se_var = np.sqrt((2 * alpha**2 + 6 * alpha) / n)
    assert abs(x.var() - alpha) < 5 * se_var


def test_safe_gamma_rejects_bad_alpha():
    with pytest.raises(ValueError):
        safe_gamma(torch.Generator(), 0.0, (3,), "cpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """The port package and chip_smoke.py import nothing of JAX, Flax,
    Optax, msgpack or the JAX package. An AST scan: the test process itself
    has JAX loaded, so sys.modules proves nothing."""
    files = sorted((REPO / "custom_alphazero_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    learner_side = {"codec.py", "buffer.py", "losses.py", "train.py",
                    "arena.py", "loop.py", "metrics.py", "watchdog.py",
                    "paths.py", "checkpoint.py", "convert.py"}
    assert learner_side <= {path.name for path in files}
    for path in files:
        for module in _imported_modules(path):
            root = module.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {module}"


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means the card; without CUDA the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = ConnectN(ConnectNConfig())
    from custom_alphazero_tpu_torch.models.convert import from_jax_variables

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedConnectNSearchV2(env, MCTSConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedConnectNSearch(env, MCTSConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_selfplay_fn(env, MCTSConfig(), SelfPlayConfig(), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.init(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_variables({}, {}, 7, ModelConfig(depth=1, filters=4))


def test_kernel_digest_covers_headers(tmp_path, monkeypatch):
    """Editing a kernel's source or any header in csrc/ changes the library
    path, so a stale build is never loaded."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    third = _build.library_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR

