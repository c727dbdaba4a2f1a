"""Process-global logger, JSONL metrics writer with its TensorBoard mirror,
and per-phase wall-clock timers (copies of ``get_logger``, ``MetricsWriter``
and ``PhaseTimer`` from ``rgbmanip_tpu/utils/logger.py``)."""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import sys
import time
from contextlib import contextmanager
from typing import Dict

import torch


def get_logger(name: str = "rgbmanip_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s"))
        log.addHandler(h)
        log.setLevel(os.environ.get("RGBMANIP_LOGLEVEL", "INFO"))
    return log


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """TFRecord's checksum: CRC32C (Castagnoli), rotated right by 15 bits
    plus 0xa282ead8."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    """One TFRecord: length (u64), its masked CRC, the payload, its masked
    CRC, little-endian."""
    head = struct.pack("<Q", len(payload))
    return (head + struct.pack("<I", masked_crc32c(head)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """A TensorBoard event file (``events.out.tfevents.*``) written record
    by record: a version event, then one event per scalar, as
    ``torch.utils.tensorboard.SummaryWriter`` writes them. The events are
    TensorBoard's own protos (``tensorboard.compat.proto``, which load
    neither TensorFlow nor JAX), framed here, since TensorBoard's writers
    load TensorFlow where it is installed. Each record is flushed as it is
    written."""

    def __init__(self, log_dir: str):
        from tensorboard.compat.proto import event_pb2, summary_pb2

        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                f"{os.getpid()}.0")
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        ev = self._event(wall_time=time.time(), file_version="brain.Event:2")
        ev.source_metadata.writer = "tensorboard.summary.writer.event_file_writer"
        self._write(ev)

    def _write(self, ev):
        self._fh.write(tfrecord(ev.SerializeToString()))
        self._fh.flush()

    def add_scalar(self, tag: str, value, step: int):
        summary = self._summary(value=[self._summary.Value(tag=tag, simple_value=float(value))])
        self._write(self._event(wall_time=time.time(), step=int(step), summary=summary))

    def close(self):
        self._fh.close()


class MetricsWriter:
    """Append-only JSONL metrics, mirrored to a TensorBoard event file in
    the same directory where TensorBoard is installed (as the JAX package's
    writer does by default)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        try:
            self._tb = EventFileWriter(log_dir)
        except ImportError:   # no TensorBoard: the JSONL alone
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                   "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class PhaseTimer:
    """Accumulating per-phase wall-clock timers (sim / render / nn / update).
    Each phase is also a ``torch.profiler.record_function`` range, so that a
    profile of a run (``RGBMANIP_PROFILE``) shows which phase launched each
    kernel; without a profiler the range costs about a microsecond."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
