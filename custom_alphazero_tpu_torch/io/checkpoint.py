"""Read side of the JAX package's checkpoint protocol, without JAX or msgpack.

A checkpoint directory (custom_alphazero_tpu/io/checkpoint.py) holds
``train_state.msgpack`` (the Flax train state, serialized with
``flax.serialization.to_bytes``), ``meta.json`` with its sha256 ``hash``, and
the ``MODEL_SAVED_SUCCESSFULLY`` sentinel written last.

Flax's layout is plain msgpack: nested maps with string keys, tuples turned
into maps keyed "0", "1", ..., arrays as ext type 1 and numpy scalars as ext
type 3, both wrapping a msgpack array ``(shape, dtype_name, C-order bytes)``.
The decoder below covers the msgpack formats that layout uses (and the rest
of the spec's non-ext formats), so the card's machine needs no ``msgpack``
package.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Any, Tuple

import numpy as np

MODEL_FILE = "train_state.msgpack"
META_FILE = "meta.json"
SENTINEL = "MODEL_SAVED_SUCCESSFULLY"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = _decode(_Reader(payload))
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader) -> Any:
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _array(r, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        return bytes(r.take(tag & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if tag in simple:
        return simple[tag]
    sized = {
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    }
    if tag in sized:
        fmt, kind = sized[tag]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "array":
            return _array(r, n)
        if kind == "map":
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if tag in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[tag])))
    numbers = {
        0xCA: ">f", 0xCB: ">d",
        0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
        0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    }
    if tag in numbers:
        return r.unpack(numbers[tag])
    raise ValueError(f"invalid msgpack tag 0x{tag:02x}")


def _array(r: _Reader, n: int) -> list:
    return [_decode(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def msgpack_restore(data: bytes) -> Any:
    """Decode a Flax msgpack payload into nested dicts of numpy arrays
    (the result ``flax.serialization.msgpack_restore`` gives)."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack payload")
    return out


def load_jax_checkpoint(path: str) -> Tuple[dict, dict, dict]:
    """(params, batch_stats, meta) of a JAX checkpoint directory, after the
    sentinel and sha256 checks of the JAX loader."""
    if not os.path.exists(os.path.join(path, SENTINEL)):
        raise FileNotFoundError(
            f"No completed checkpoint at {path} (missing sentinel)"
        )
    with open(os.path.join(path, MODEL_FILE), "rb") as fp:
        payload = fp.read()
    with open(os.path.join(path, META_FILE)) as fp:
        meta = json.load(fp)
    if hashlib.sha256(payload).hexdigest() != meta["hash"]:
        raise ValueError(f"Checkpoint hash mismatch at {path}")
    state = msgpack_restore(payload)
    return state["params"], state["batch_stats"], meta
