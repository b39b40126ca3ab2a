"""Metrics: TensorBoard event files + JSONL mirror (the port's copy of
io/metrics.py).

Scalar writes (loss / steps / learning rate per iteration, winning score per
evaluation) without a TensorFlow dependency: the event-file format (TFRecord
framing with masked CRC32C + Event/Summary protobuf messages) is hand-encoded
— it is a stable, tiny wire format. Files load in stock TensorBoard.

A JSONL mirror of every scalar is written alongside for dependency-free
analysis.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Optional

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) -------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ----------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag = 1 (string), simple_value = 2 (float) }
    sv = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    # Summary { value = 1 (repeated message) }
    summary = _field_bytes(1, sv)
    # Event { wall_time = 1 (double), step = 2 (int64), summary = 5 }
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 (string) }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (
        length
        + struct.pack("<I", _masked_crc(length))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class MetricsWriter:
    """Scalar metrics writer: TensorBoard event file + JSONL mirror."""

    def __init__(self, logdir: str, jsonl: bool = True):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        self._fp = open(os.path.join(logdir, name), "ab")
        self._fp.write(_tfrecord(_version_event(now)))
        self._jsonl = (
            open(os.path.join(logdir, "metrics.jsonl"), "a") if jsonl else None
        )

    def scalar(self, tag: str, value: float, step: int,
               wall_time: Optional[float] = None) -> None:
        wall_time = time.time() if wall_time is None else wall_time
        self._fp.write(_tfrecord(_scalar_event(tag, value, step, wall_time)))
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "wall_time": wall_time}) + "\n")

    def scalars(self, values: dict, step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def flush(self) -> None:
        self._fp.flush()
        if self._jsonl:
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._fp.close()
        if self._jsonl:
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
