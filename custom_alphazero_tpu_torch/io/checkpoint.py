"""The JAX package's checkpoint protocol, read and written without JAX or
msgpack: a checkpoint written by either package restores in the other.

A checkpoint directory (custom_alphazero_tpu/io/checkpoint.py) holds
``train_state.msgpack`` (the Flax train state, serialized with
``flax.serialization.to_bytes``), optionally ``replay.msgpack`` (the replay
ring, likewise), ``meta.json`` with ``steps``, ``learning_rate`` and the
payload's sha256 ``hash``, and the ``MODEL_SAVED_SUCCESSFULLY`` sentinel
written last. A save retires the old directory by rename, then puts the new
one in its place; one save runs at a time.

Both sides work on state dicts: nested dicts of numpy arrays in Flax's names
and layouts (models/convert.py makes them from a TrainState and back,
replay/buffer.py from a ring and back).

Flax's layout is plain msgpack: nested maps with string keys, tuples turned
into maps keyed "0", "1", ..., arrays as ext type 1 and numpy scalars as ext
type 3, both wrapping a msgpack array ``(shape, dtype_name, C-order bytes)``.
The decoder below covers the msgpack formats that layout uses (and the rest
of the spec's non-ext formats), and the encoder is its inverse on state
dicts, so no ``msgpack`` package is needed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import tempfile
import threading
from typing import Any, Optional, Tuple

import numpy as np

MODEL_FILE = "train_state.msgpack"
META_FILE = "meta.json"
SENTINEL = "MODEL_SAVED_SUCCESSFULLY"
REPLAY_FILE = "replay.msgpack"

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


def _sized(n: int, fix, tag8, tag16, tag32) -> bytes:
    """The header of a sized format: ``fix`` is (base tag, limit) of the
    short form or None; ``tag8`` may be None too."""
    if fix is not None and n < fix[1]:
        return struct.pack(">B", fix[0] | n)
    if tag8 is not None and n < 1 << 8:
        return struct.pack(">BB", tag8, n)
    if n < 1 << 16:
        return struct.pack(">BH", tag16, n)
    return struct.pack(">BI", tag32, n)


# (tag, struct code, lowest, one past the highest) of the sized integers.
_INT_FORMATS = (
    (0xCC, "B", 0, 1 << 8), (0xCD, "H", 0, 1 << 16),
    (0xCE, "I", 0, 1 << 32), (0xCF, "Q", 0, 1 << 64),
    (0xD0, "b", -(1 << 7), 0), (0xD1, "h", -(1 << 15), 0),
    (0xD2, "i", -(1 << 31), 0), (0xD3, "q", -(1 << 63), 0),
)


def _encode_int(x: int) -> bytes:
    if -0x20 <= x < 0x80:  # the one-byte fixints
        return struct.pack(">b", x)
    for tag, code, lowest, end in _INT_FORMATS:
        if lowest <= x < end:
            return struct.pack(">B" + code, tag, x)
    raise ValueError(f"integer {x} out of msgpack's range")


def _encode_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = (struct.pack(">B", fixext[n]) if n in fixext
            else _sized(n, None, 0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _encode(x: Any) -> bytes:
    if isinstance(x, dict):
        # Keys in sorted order, as Flax writes them.
        return _sized(len(x), (0x80, 16), None, 0xDE, 0xDF) + b"".join(
            _encode(key) + _encode(value) for key, value in sorted(x.items()))
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        payload = _encode((arr.shape, arr.dtype.name, arr.tobytes("C")))
        return _encode_ext(
            _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR,
            payload)
    if isinstance(x, (list, tuple)):
        return _sized(len(x), (0x90, 16), None, 0xDC, 0xDD) + b"".join(
            _encode(item) for item in x)
    if isinstance(x, str):
        data = x.encode("utf-8")
        return _sized(len(data), (0xA0, 32), 0xD9, 0xDA, 0xDB) + data
    if isinstance(x, bytes):
        return _sized(len(x), None, 0xC4, 0xC5, 0xC6) + x
    if x is None or isinstance(x, bool):
        return {None: b"\xc0", False: b"\xc2", True: b"\xc3"}[x]
    if isinstance(x, int):
        return _encode_int(x)
    if isinstance(x, float):
        return struct.pack(">Bd", 0xCB, x)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def msgpack_serialize(state: Any) -> bytes:
    """Encode a state dict (nested dicts with string keys over numpy arrays,
    numpy scalars and plain numbers) as ``flax.serialization`` does: the
    inverse of ``msgpack_restore``."""
    return _encode(state)


def _hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def save_checkpoint(path: str, train_state: dict, learning_rate: float,
                    replay_state: Optional[dict] = None,
                    extra_meta: Optional[dict] = None) -> dict:
    """Atomically write a checkpoint directory with integrity metadata.
    ``train_state`` and ``replay_state`` are state dicts on the host."""
    payload = msgpack_serialize(train_state)
    meta = {
        "steps": int(train_state["steps"]),
        "learning_rate": float(learning_rate),
        "hash": _hash(payload),
        **(extra_meta or {}),
    }
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent)
    try:
        with open(os.path.join(tmp, MODEL_FILE), "wb") as fp:
            fp.write(payload)
        if replay_state is not None:
            with open(os.path.join(tmp, REPLAY_FILE), "wb") as fp:
                fp.write(msgpack_serialize(replay_state))
        with open(os.path.join(tmp, META_FILE), "w") as fp:
            json.dump(meta, fp, sort_keys=True, indent=4)
        # Sentinel last: its presence certifies a complete write.
        open(os.path.join(tmp, SENTINEL), "wb").close()
        # Retire the old checkpoint by rename first, so a crash between the
        # two operations leaves the previous complete checkpoint at `old`
        # rather than none at all.
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(dir=parent)
            os.rmdir(old)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return meta


_ASYNC_LOCK = threading.Lock()


def _locked_save(path, state, learning_rate, replay, extra_meta):
    # One save at a time per process: overlapping saves to the same path
    # would interleave the retire/replace sequence.
    with _ASYNC_LOCK:
        save_checkpoint(path, state, learning_rate, replay,
                        extra_meta=extra_meta)


def save_checkpoint_async(path: str, train_state: dict, learning_rate: float,
                          replay_state: Optional[dict] = None,
                          extra_meta: Optional[dict] = None,
                          ) -> threading.Thread:
    """Save on a worker thread, joined later by the caller. The state dicts
    are host copies already, so training may go on meanwhile."""
    thread = threading.Thread(
        target=_locked_save,
        args=(path, train_state, learning_rate, replay_state, extra_meta),
        daemon=True,
    )
    thread.start()
    return thread


def checkpoint_exists(path: str) -> bool:
    """A checkpoint only counts if its sentinel exists."""
    return os.path.exists(os.path.join(path, SENTINEL))


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """(train state dict, meta) of a checkpoint directory, after the
    sentinel and sha256 checks."""
    if not checkpoint_exists(path):
        raise FileNotFoundError(
            f"No completed checkpoint at {path} (missing sentinel)"
        )
    with open(os.path.join(path, MODEL_FILE), "rb") as fp:
        payload = fp.read()
    with open(os.path.join(path, META_FILE)) as fp:
        meta = json.load(fp)
    if _hash(payload) != meta["hash"]:
        raise ValueError(f"Checkpoint hash mismatch at {path}")
    return msgpack_restore(payload), meta


def load_replay(path: str) -> Optional[dict]:
    """The replay state dict of a checkpoint directory, or None where the
    checkpoint was written without one."""
    replay_path = os.path.join(path, REPLAY_FILE)
    if not os.path.exists(replay_path):
        return None
    with open(replay_path, "rb") as fp:
        return msgpack_restore(fp.read())


def load_jax_checkpoint(path: str) -> Tuple[dict, dict, dict]:
    """(params, batch_stats, meta) of a checkpoint directory."""
    state, meta = load_checkpoint(path)
    return state["params"], state["batch_stats"], meta


def list_evaluation_iterations(evaluation_dir: str) -> list:
    """All completed best-model lineage directories ``iteration_N`` as
    (N, path), ascending."""
    if not os.path.isdir(evaluation_dir):
        return []
    found = []
    for name in os.listdir(evaluation_dir):
        if not name.startswith("iteration_"):
            continue
        try:
            num = int(name.split("_", 1)[1])
        except ValueError:
            continue
        path = os.path.join(evaluation_dir, name)
        if checkpoint_exists(path):
            found.append((num, path))
    return sorted(found)


def latest_evaluation_iteration(evaluation_dir: str,
                                ) -> Optional[Tuple[int, str]]:
    """The newest completed ``iteration_N`` directory, or None."""
    lineage = list_evaluation_iterations(evaluation_dir)
    return lineage[-1] if lineage else None
