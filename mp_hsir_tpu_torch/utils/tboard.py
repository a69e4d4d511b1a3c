"""Dependency-free TensorBoard scalar writer (a copy of
``mp_hsir_tpu/utils/tboard.py``: the same records, byte for byte, but the
wall time).

The reference logs train_loss through Lightning's TensorBoardLogger
(train.py:99,65). This image has no TensorFlow/tensorboardX, so this module
writes the TFRecord/Event wire format directly (varint-framed protobuf with
masked CRC32C) — enough for `tensorboard --logdir` to plot scalars.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

# ---- CRC32C (Castagnoli), software table ----
_POLY = 0x82F63B78
_TABLE = np.zeros(256, dtype=np.uint32)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if (_c & 1) else 0)
    _TABLE[_i] = _c


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    table = _TABLE
    for b in arr:
        crc = (crc >> 8) ^ int(table[(crc ^ int(b)) & 0xFF])
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    # protobuf varint: negatives encode as 64-bit two's complement (and a
    # plain arithmetic right shift on a negative int would loop forever)
    n &= (1 << 64) - 1
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _pb_string(field: int, value: bytes) -> bytes:
    return bytes([(field << 3) | 2]) + _varint(len(value)) + value


def _pb_double(field: int, value: float) -> bytes:
    return bytes([(field << 3) | 1]) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return bytes([(field << 3) | 5]) + struct.pack("<f", value)


def _pb_varint(field: int, value: int) -> bytes:
    return bytes([(field << 3) | 0]) + _varint(value)


class SummaryWriter:
    """Minimal scalar-only TensorBoard writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.mp-hsir-tpu"
        self._f = open(os.path.join(logdir, fname), "wb")
        self._write_event(_pb_double(1, time.time()) + _pb_string(3, b"brain.Event:2"))

    def _write_event(self, event_bytes: bytes) -> None:
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        # Event{wall_time=1, step=2, summary=5{ value=1{ tag=1, simple_value=2 }}}
        val = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
        summary = _pb_string(1, val)
        event = _pb_double(1, time.time()) + _pb_varint(2, int(step)) + _pb_string(5, summary)
        self._write_event(event)

    def close(self) -> None:
        self._f.close()
