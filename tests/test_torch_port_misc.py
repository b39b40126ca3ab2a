"""The port's Gamma sampler in distribution, its import boundary, and its
entry points' refusal to fall back to the CPU."""

import ast
import pathlib
import re

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

# One intra-op thread per test process. The suite runs in several xdist
# workers at once, each of which imports every test module (so this line
# holds for all of a worker's tests); with torch's default of one thread
# per core, six workers' threads contend for the same cores, and the
# port's tiny loop runs took 30-50 times as long as alone.
torch.set_num_threads(1)

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


def _value_strings(path: pathlib.Path):
    """The string literals of a file that are values (f-string parts
    included), not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef))
        and ast.get_docstring(node, clean=False) is not None
    }
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node.value


# A path into the JAX package: its directory name as a path component.
JAX_PACKAGE_PATH = re.compile(r"(^|[^\w])custom_alphazero_tpu([/\\]|$)")
# What chip_smoke.py's kernels line must name: the TPU kernel's file:line.
CITATION = re.compile(r"custom_alphazero_tpu/[\w/]+\.py:\d+")


def test_port_imports_no_jax():
    """The port package and chip_smoke.py import nothing of JAX, Flax,
    Optax, msgpack or the JAX package, and read no file of the JAX package
    by path (its solver source or opening book, say): no string value names
    a path into it, but for the file:line citations of the kernels line. An
    AST scan: the test process itself has JAX loaded, so sys.modules proves
    nothing."""
    package = REPO / "custom_alphazero_tpu_torch"
    files = sorted(package.rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    learner_side = {"replay/codec.py", "replay/buffer.py", "models/losses.py",
                    "runtime/train.py", "runtime/arena.py", "runtime/loop.py",
                    "io/metrics.py", "runtime/watchdog.py", "paths.py",
                    "io/checkpoint.py", "models/convert.py",
                    "solver/__init__.py", "tools/strength.py",
                    "tools/visualize.py", "runtime/supervisor.py",
                    "envs/chess/tables.py", "envs/chess/engine.py",
                    "envs/chess/__init__.py", "tools/perft.py",
                    "search/gumbel.py", "tools/cli.py", "tools/run_report.py",
                    "tools/book_from_cache.py", "tools/final_eval.py",
                    "tools/lineage.py", "tools/distill.py",
                    "tools/chess_strength.py", "tools/chess_tactics.py",
                    "tools/bench_chess.py", "tools/profile_chess.py",
                    "tools/chess_inloop_bench.py", "serving/__init__.py",
                    "serving/server.py", "serving/client.py",
                    "serving/__main__.py", "tools/profile.py",
                    "tools/inloop_bench.py", "tools/gumbel_probe.py",
                    "parallel/__init__.py", "parallel/distributed.py",
                    "parallel/mesh.py", "parallel/sharded.py",
                    "parallel/launch.py", "tools/scaling.py",
                    "tools/multihost_proxy.py", "tools/dryrun_multigpu.py"}
    assert learner_side <= {path.relative_to(package).as_posix()
                            for path in files[:-1]}
    for path in files:
        for module in _imported_modules(path):
            root = module.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {module}"
        for text in _value_strings(path):
            if JAX_PACKAGE_PATH.search(text):
                assert CITATION.fullmatch(text), (
                    f"{path.name} names a path in the JAX package: {text!r}")
    # The scan sees both spellings of a path into the JAX package.
    for text in ("custom_alphazero_tpu/solver/native/7x6.book",
                 "custom_alphazero_tpu"):
        assert JAX_PACKAGE_PATH.search(text) and not CITATION.fullmatch(text)
    assert not JAX_PACKAGE_PATH.search("custom_alphazero_tpu_torch/solver")


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
    from custom_alphazero_tpu_torch.envs.chess.engine import Chess
    from custom_alphazero_tpu_torch.tools import perft

    chess = Chess()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chess.init(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chess.from_fen("4k3/8/8/8/8/8/8/4K3 w - - 0 1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        perft.main(["start", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_selfplay_fn(chess, MCTSConfig(use_gumbel=True),
                         SelfPlayConfig(), 4)
    # Subtree reuse: search_tree runs where its tree lives, and the tree
    # and the reuse generation start on the card.
    from custom_alphazero_tpu_torch.search.mcts import MCTS

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_selfplay_fn(env, MCTSConfig(reuse_tree=True), SelfPlayConfig(),
                         4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MCTS(env).search_tree(MCTS(env).init_tree(env.init(2), 8),
                              None, None, None, 4)
    from custom_alphazero_tpu_torch.config import Config
    from custom_alphazero_tpu_torch.serving.__main__ import build_service
    from custom_alphazero_tpu_torch.tools import profile

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_service(Config(), port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.phase_timings()


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

