"""Dependency-free TensorBoard scalar-event writer (the port's copy of
speech2text_tpu/train/tb_writer.py).

Writes `events.out.tfevents.*` files — TFRecord framing (length + masked
CRC32C + payload + masked CRC32C) around hand-encoded `tensorflow.Event`
protos — with the standard library only.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---- CRC32C (Castagnoli), table-driven ------------------------------------
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ----------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    sval = _pb_bytes(1, tag.encode("utf-8")) + _pb_float(2, float(value))
    summary = _pb_bytes(1, sval)  # Summary{ value=1 repeated }
    # Event{ wall_time=1, step=2, summary=5 }
    return _pb_double(1, wall_time) + _pb_int(2, step) + _pb_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3 }
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


class TensorBoardWriter:
    """Append-only scalar event writer, one events file per run dir."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))
        self._f.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(
            _scalar_event(wall_time or time.time(), int(step), tag,
                          float(value)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()
