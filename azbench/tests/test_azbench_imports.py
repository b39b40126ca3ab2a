"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os

import pytest

from azbench.tests import fixture

BENCH = os.path.join(fixture.REPO, "azbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "custom_alphazero_tpu"}


def modules():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def imported(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    bad = [n for n in imported(path) if top(n) in FORBIDDEN]
    assert not bad, bad
    if os.sep + "reference" + os.sep in path:
        program = [n for n in imported(path)
                   if top(n) == "custom_alphazero_tpu_torch"]
        assert not program, program


def test_the_scan_compares_whole_names():
    assert top("custom_alphazero_tpu_torch.runtime") not in FORBIDDEN
    assert top("custom_alphazero_tpu.runtime") in FORBIDDEN
    assert top("jax.numpy") in FORBIDDEN
