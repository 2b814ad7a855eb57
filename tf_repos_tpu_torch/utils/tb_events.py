"""TensorBoard event-file writer without dependencies (the port's own
copy of the JAX package's utils/tb_events.py).

TensorBoard scalar curves are the reference's published training
artifacts, so runs write real event files beside the JSONL. This writes
the TFRecord-framed Event protos TensorBoard reads, the protobuf encoding
and the masked CRC32C done by hand:

  record   = uint64le(len) + crc(len) + payload + crc(payload)
  Event    = 1:double wall_time, 2:varint step,
             3:string file_version | 5:message Summary
  Summary  = repeated 1:message Value{1:string tag, 2:fixed32 simple_value}

tests/test_torch_observability.py reads them back with the tensorboard
package's own reader.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tab = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _len_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", value)
    return _len_field(1, val)  # Summary.value


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    head = _field(1, 1) + struct.pack("<d", wall_time) + _field(2, 0) + _varint(step)
    return head + body


def _record(payload: bytes) -> bytes:
    head = struct.pack("<Q", len(payload))
    return (
        head
        + struct.pack("<I", _masked_crc(head))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TensorBoardWriter:
    """Scalar-only event writer: one events.out.tfevents.* per instance."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}{suffix}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        # TB requires a file_version event first
        self._f.write(
            _record(_event(time.time(), 0, _len_field(3, b"brain.Event:2")))
        )
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        wall = time.time()
        body = b"".join(
            _scalar_summary(tag, float(v)) for tag, v in scalars.items()
        )
        self._f.write(_record(_event(wall, int(step), _len_field(5, body))))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
