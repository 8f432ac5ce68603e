"""Scalar metrics logging: CSV always, TensorBoard event files on request.
A copy of ``diffudf_tpu/utils/metrics.py``; ``losses.csv`` has the same
format.

First-class replacement for the reference's ad-hoc SummaryWriter calls +
pandas dump (``train.py:33-36,224,233,394-395``).  The training loop
produces whole *chunks* of per-epoch scalars at once (the trainer reads its
per-epoch scalars once per chunk), so the logger ingests arrays, not single points.

The event files are written here (:class:`EventFile`), not through
``torch.utils.tensorboard``: that writer goes through the ``tensorboard``
package's file layer, which imports TensorFlow (and with it JAX) where it is
installed, and is missing where it is not.  The records are those of
``SummaryWriter.add_scalar``: TFRecord framing (length, masked CRC-32C,
data, masked CRC-32C) around ``Event`` protos with a ``simple_value``.
"""

from __future__ import annotations

import csv
import os
import socket
import struct
import time


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


class EventFile:
    """One TensorBoard event file of scalar summaries, as
    ``torch.utils.tensorboard.SummaryWriter`` writes them."""

    def __init__(self, log_dir: str):
        name = (f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}."
                f"{os.getpid()}.0")
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        self._write(self._event(_field(3, b"brain.Event:2")))

    @staticmethod
    def _event(body: bytes, step: int = 0) -> bytes:
        # Event: wall_time (1, double), step (2, varint), then the body
        head = b"\x09" + struct.pack("<d", time.time())
        if step:
            head += b"\x10" + _varint(step)
        return head + body

    def _write(self, data: bytes):
        length = struct.pack("<Q", len(data))
        self._fh.write(length + struct.pack("<I", _masked_crc(length)) + data
                       + struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        # Summary (5) { Value (1) { tag (1), simple_value (2, float) } }
        val = _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
        self._write(self._event(_field(5, _field(1, val)), step))

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


class ScalarLogger:
    """Collects named per-step scalar series; flushes CSV and TensorBoard."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._series: dict = {}
        self._writer = None
        if tensorboard:
            summary_path = os.path.join(log_dir, "summaries")
            os.makedirs(summary_path, exist_ok=True)
            self._writer = EventFile(summary_path)

    def log_array(self, name: str, start_step: int, values):
        """Record values for steps [start_step, start_step + len(values))."""
        import numpy as np

        values = np.asarray(values, dtype=float)
        store = self._series.setdefault(name, {})
        for i, v in enumerate(values):
            store[start_step + i] = float(v)
        if self._writer is not None:
            for i, v in enumerate(values):
                self._writer.add_scalar(name, float(v), start_step + i)
            self._writer.flush()

    def log(self, name: str, step: int, value: float):
        self.log_array(name, step, [value])

    def flush_csv(self, filename: str = "losses.csv", sep: str = ";",
                  exclude=()):
        """Reference-compatible losses.csv (one column per series)."""
        names = [n for n in sorted(self._series) if n not in exclude]
        if not names:
            return
        steps = sorted({s for n in names for s in self._series[n]})
        path = os.path.join(self.log_dir, filename)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, delimiter=sep)
            w.writerow(names)
            for s in steps:
                w.writerow([self._series[n].get(s, "") for n in names])
        return path

    def close(self):
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
