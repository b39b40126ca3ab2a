"""A minimal msgpack decoder for Flax checkpoints (``train_state.msgpack``).

Flax writes nested maps of arrays; an array is ext type 1 holding a
msgpack list ``[shape, dtype name, raw bytes]``, a numpy scalar ext type 3
of the same form. Only the formats such files use are read.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np


class _Cursor:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack payload ends early")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def number(self, fmt: str):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]


_LENGTHS = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("list", ">H"), 0xDD: ("list", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ext(code: int, payload: bytes):
    if code not in (1, 3):
        raise ValueError(f"msgpack ext type {code} is not an array")
    shape, dtype, raw = _value(_Cursor(payload))
    array = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return array[()] if code == 3 else array


def _value(cur: _Cursor) -> Any:
    tag = cur.number(">B")
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag < 0x90:
        return {_value(cur): _value(cur) for _ in range(tag & 0x0F)}
    if tag < 0xA0:
        return [_value(cur) for _ in range(tag & 0x0F)]
    if tag < 0xC0:
        return cur.read(tag & 0x1F).decode()
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag]
    if tag in _NUMBERS:
        return cur.number(_NUMBERS[tag])
    if tag in _FIXEXT:
        code = cur.number(">b")
        return _ext(code, cur.read(_FIXEXT[tag]))
    if tag in _LENGTHS:
        kind, fmt = _LENGTHS[tag]
        n = cur.number(fmt)
        if kind == "bin":
            return cur.read(n)
        if kind == "str":
            return cur.read(n).decode()
        if kind == "list":
            return [_value(cur) for _ in range(n)]
        if kind == "map":
            return {_value(cur): _value(cur) for _ in range(n)}
        code = cur.number(">b")
        return _ext(code, cur.read(n))
    raise ValueError(f"msgpack tag 0x{tag:02x} not read here")


def read_checkpoint(directory: str) -> dict:
    """The nested dict of a checkpoint directory's ``train_state.msgpack``:
    ``params``, ``batch_stats``, ``opt_state``, ``steps``."""
    with open(os.path.join(directory, "train_state.msgpack"), "rb") as fp:
        return _value(_Cursor(fp.read()))
