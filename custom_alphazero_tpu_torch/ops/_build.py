"""Build the port's CUDA kernels from the repo's sources and load them.

Each ``csrc/<name>.cu`` exports plain C functions. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<digest>.so`` at the
repo root (a directory ``.gitignore`` lists) on first use, and loaded with
``ctypes``; the digest covers the source, every header in ``csrc/`` (a
kernel may include any of them) and the flags, so an edited kernel or
header is rebuilt. Nothing is built at import time.

``-fmad=false`` keeps nvcc from contracting a*b+c into one fused
multiply-add: the search kernel's PUCT arithmetic must round like the plain
PyTorch version's separate operations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p for pattern in ("*.cuh", "*.h")
                     for p in CSRC_DIR.glob(pattern))
    for path in [CSRC_DIR / f"{name}.cu", *headers]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels, one nvcc process each, all started
    together. Returns each kernel's compiler messages (ptxas's register and
    spill report); raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if its digest is new."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
