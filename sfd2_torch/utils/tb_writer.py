"""Minimal TensorBoard scalar-event writer (self-contained).

Port of ``sfd2_tpu/utils/tb_writer.py``: the reference trainer logs loss
and lr scalars through tensorboardX every 50 iterations
(``trainer.py:96,218-230``); this writes the same artifact — a TFRecord
stream of TensorFlow ``Event`` protos with scalar ``Summary`` values,
readable by TensorBoard — without TensorFlow. The protos are hand-encoded:

  Event { double wall_time = 1; int64 step = 2; Summary summary = 5; }
  Summary { repeated Value value = 1; }
  Summary.Value { string tag = 1; float simple_value = 2; }

TFRecord framing: [len u64][masked crc32c(len) u32][data][masked
crc32c(data) u32], crc mask = ((crc >> 15 | crc << 17) + 0xa282ead8).
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    tag_b = tag.encode()
    # Summary.Value: tag=1 (len-delim), simple_value=2 (fixed32 float)
    val = (
        _field(1, 2) + _varint(len(tag_b)) + tag_b
        + _field(2, 5) + struct.pack("<f", float(value))
    )
    summary = _field(1, 2) + _varint(len(val)) + val
    event = (
        _field(1, 1) + struct.pack("<d", wall_time)  # wall_time double
        + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)  # step int64
        + _field(5, 2) + _varint(len(summary)) + summary
    )
    return event


class ScalarEventWriter:
    """Append-only `events.out.tfevents.*` file with add_scalar()."""

    def __init__(self, logdir: os.PathLike):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.sfd2_torch"
        self._f = open(self.logdir / fname, "ab")
        # TensorBoard expects a leading file-version event.
        ver = b"brain.Event:2"
        first = (
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(3, 2) + _varint(len(ver)) + ver  # file_version = 3
        )
        self._write_record(first)

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(
            _encode_scalar_event(tag, value, step, time.time())
        )

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
