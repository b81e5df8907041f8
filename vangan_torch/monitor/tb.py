"""TensorBoard summaries written by hand (tb_callback.py:14-103).

Counterpart of ``vangan_tpu.monitor.tb.TBSummary``, which writes through
tensorboardX. Here the event files are written in pure Python so that no
TensorBoard package is needed where training runs: TFRecord framing (length,
masked CRC32C of the length, the record, masked CRC32C of the record) around
``Event`` protobufs whose ``Summary.Value`` carries a ``simple_value``.
TensorBoard reads ``TB_Logs/train`` and ``TB_Logs/validate`` as it reads the
JAX package's. ``read_scalars`` reads the scalars of such files back, with
their CRCs checked, where no TensorBoard is installed. ``image``,
``figure`` and ``image_cycle`` wait for a caller on the port's path.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2, _varint(len(data)) + data)


def event(wall_time: float, step: int = 0, file_version: str = None,
          scalars: Dict[str, float] = None) -> bytes:
    """An ``Event`` protobuf: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) of ``Summary.Value``s (1) with
    tag (1, string) and simple_value (2, float)."""
    msg = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(step))
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if scalars:
        values = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode()) + _field(2, 5, struct.pack("<f", v)))
            for tag, v in scalars.items())
        msg += _bytes_field(5, values)
    return msg


def record(data: bytes) -> bytes:
    """One TFRecord frame."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", _masked_crc(length)) + data
            + struct.pack("<I", _masked_crc(data)))


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(msg: bytes):
    """(field number, wire type, value) of each field of a protobuf message;
    a length-delimited value as bytes, a fixed32 or fixed64 as raw bytes."""
    i = 0
    while i < len(msg):
        key, i = _read_varint(msg, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(msg, i)
        elif wire == 1:
            value, i = msg[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(msg, i)
            value, i = msg[i:i + n], i + n
        elif wire == 5:
            value, i = msg[i:i + 4], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire} not expected in an Event")
        yield number, wire, value


def read_scalars(log_dir: str) -> Dict[str, list]:
    """``{tag: [(step, value), ...]}`` of the ``simple_value`` scalars in the
    event files of ``log_dir``, in file and record order; a frame whose CRC
    does not match raises."""
    out: Dict[str, list] = {}
    for name in sorted(f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents.")):
        with open(os.path.join(log_dir, name), "rb") as f:
            buf = f.read()
        i = 0
        while i < len(buf):
            (length,) = struct.unpack_from("<Q", buf, i)
            (len_crc,) = struct.unpack_from("<I", buf, i + 8)
            data = buf[i + 12:i + 12 + length]
            (data_crc,) = struct.unpack_from("<I", buf, i + 12 + length)
            if len_crc != _masked_crc(buf[i:i + 8]) or data_crc != _masked_crc(data):
                raise ValueError(f"{name}: CRC mismatch in the record at byte {i}")
            i += 16 + length
            step, values = 0, []
            for number, _, value in _fields(data):
                if number == 2:
                    step = value
                elif number == 5:
                    values += [v for n, _, v in _fields(value) if n == 1]
            for v in values:
                fields = {n: val for n, _, val in _fields(v)}
                if 1 in fields and 2 in fields:
                    tag = fields[1].decode()
                    out.setdefault(tag, []).append((step, struct.unpack("<f", fields[2])[0]))
    return out


class EventFileWriter:
    """One ``events.out.tfevents.*`` file of scalar events."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(record(event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(record(event(time.time(), step, scalars={tag: float(value)})))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TBSummary:
    """Train and validate writers (tb_callback.py:21-103)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.train_writer = EventFileWriter(os.path.join(log_dir, "train"))
        self.val_writer = EventFileWriter(os.path.join(log_dir, "validate"))

    def _writer(self, training: bool) -> EventFileWriter:
        return self.train_writer if training else self.val_writer

    def scalar(self, name: str, value: float, epoch: int, training: bool = True) -> None:
        w = self._writer(training)
        w.add_scalar(name, float(value), epoch)
        w.flush()

    def losses(self, results: Dict[str, list]) -> None:
        """Print the mean of each loss (tb_callback.py:32-36)."""
        means = {k: float(np.mean(v)) for k, v in results.items()}
        print("  ".join(f"{k}: {v:.4f}" for k, v in means.items()))

    def close(self) -> None:
        for w in (self.train_writer, self.val_writer):
            w.close()
