"""Minimal TensorBoard event-file writer (copy of
``mintime_tpu/utils/tb_events.py``, which is pure Python: the port keeps its
own so that it never imports the JAX package).

The reference logs train/val scalars to TensorBoard via tensorboardX
(reference train.py:257-258,467-472). The obvious port — torch's bundled
``SummaryWriter`` — transitively imports TensorFlow, which costs minutes of
import and fork time on a small host and has no business on a training hot
path. Event files are just TFRecords of two tiny protos, so this module
hand-encodes them instead:

* TFRecord framing: ``u64le(len) | masked_crc32c(len) | data |
  masked_crc32c(data)`` with the TF mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.
* ``Event`` proto (tensorflow/core/util/event.proto): ``wall_time`` (field
  1, double), ``step`` (field 2, int64), and either ``file_version`` (field
  3, string — a mandatory ``"brain.Event:2"`` first record) or ``summary``
  (field 5, message).
* ``Summary``/``Summary.Value`` (summary.proto): repeated ``value`` (field
  1) with ``tag`` (field 1, string) and ``simple_value`` (field 2, float).

The output opens in stock TensorBoard (which verifies the CRCs — checked in
tests against the real reader when available).
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc32c_table():
    # Castagnoli polynomial 0x1EDC6F41, reflected 0x82F63B78.
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    ev = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        ev += _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _bytes_field(3, file_version.encode())
    if summary is not None:
        ev += _bytes_field(5, summary)
    return ev


def _scalar_summary(tag: str, value: float) -> bytes:
    v = _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", value)
    return _bytes_field(1, v)


class EventFileWriter:
    """Append-only scalar event writer, one file per run directory.

    API-compatible with the ``add_scalar``/``close`` subset of
    SummaryWriter that the reference uses (train.py:467-472).
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%d" % (
            time.time(), socket.gethostname(), os.getpid()
        )
        self._f = open(os.path.join(log_dir, name), "ab")
        self._f.write(_tfrecord(_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        summary = _scalar_summary(tag, float(value))
        self._f.write(_tfrecord(_event(time.time(), int(step), summary=summary)))
        self._f.flush()

    def close(self):
        self._f.close()
