"""Process-global logger, JSONL metrics writer with its TensorBoard mirror,
and per-phase wall-clock timers (copies of ``get_logger``, ``MetricsWriter``
and ``PhaseTimer`` from ``rgbmanip_tpu/utils/logger.py``), and the spans
that split a profiled run by stage (``span``, ``SPANS``)."""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import struct
import sys
import time
import warnings
from contextlib import contextmanager, nullcontext
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


# torch's own flag: true while a torch profiler records on this thread
_profiling = torch.autograd._profiler_enabled
# the message of each call that ``torch.cuda.set_sync_debug_mode("warn")`` reports
SYNC_WARNING = "called a synchronizing CUDA operation"


class _Record:
    __slots__ = ("name", "parent", "call", "t0", "t1", "device_ms", "counts", "range",
                 "events")

    def __init__(self, name, parent, call, counts):
        self.name, self.parent, self.call = name, parent, call
        self.counts = {"host_syncs": 0, **counts}
        self.device_ms = None
        self.events = None


class Spans:
    """The records of the spans opened while a torch profiler records.

    Each span is a ``record_function`` range, so that the profiler's trace
    shows it on the clock of the card's kernels, and a record: its name, the
    name of the span it is nested in, a call id shared by every span nested
    in one outermost span, its host time (``perf_counter_ns``) and, where
    CUDA is initialised, its device time between two timing events recorded
    on the current stream at entry and at exit. That time runs from the
    device finishing the work enqueued before the span to it finishing the
    span's own: its busy time and the time it waited for the span's
    launches, so that spans that follow each other add up.

    A span never synchronises: an event pair is read once ``query`` says
    its end is done, or in ``summary``, which synchronises once. The
    synchronising calls made inside an outermost span on a CUDA device are
    counted as ``host_syncs`` of the innermost span open, through torch's
    sync debug mode set to warn while that span is open and its warnings
    captured (the others are issued again at its exit). The first ``cap``
    records are kept whole; the sums per name are kept for all of them.
    One thread opens spans."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.reset()

    def reset(self):
        self.records = []
        self.totals: Dict[str, dict] = {}
        self._stack = []
        self._pending = collections.deque()   # (record, totals row) whose events run
        self._free = []                       # timing events to reuse
        self._calls = 0
        self._watch = None                    # (catch_warnings, log, sync debug mode)
        self._seen = 0
        self._registry = {}

    def open(self, name: str, counts) -> _Record:
        parent = self._stack[-1] if self._stack else None
        if parent is None:
            self._calls += 1
            if torch.cuda.is_initialized():
                self._watch_syncs()
        else:
            self._charge(parent)
        rec = _Record(name, parent and parent.name,
                      parent.call if parent else self._calls, counts)
        rec.range = torch.autograd.profiler.record_function(name)
        rec.range.__enter__()
        if torch.cuda.is_initialized():
            rec.events = [self._free.pop() if self._free
                          else torch.cuda.Event(enable_timing=True) for _ in range(2)]
            rec.events[0].record()
        self._stack.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def close(self, rec: _Record):
        rec.t1 = time.perf_counter_ns()
        try:
            if rec.events is not None:
                rec.events[1].record()
            rec.range.__exit__(None, None, None)
            rec.range = None
            self._charge(rec)
        finally:
            self._stack.pop()
            if not self._stack and self._watch is not None:
                self._unwatch_syncs()
        row = self.totals.setdefault(rec.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                                                "timed": 0, "counts": {}})
        row["calls"] += 1
        row["host_s"] += (rec.t1 - rec.t0) * 1e-9
        for k, v in rec.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
        if len(self.records) < self.cap:
            self.records.append(rec)
        if rec.events is not None:
            self._pending.append((rec, row))
        self._resolve(wait=False)

    def count(self, counts):
        rec = self._stack[-1]
        for k, v in counts.items():
            rec.counts[k] = rec.counts.get(k, 0) + v

    def _resolve(self, wait: bool):
        if wait and self._pending:
            torch.cuda.synchronize()
        while self._pending and (wait or self._pending[0][0].events[1].query()):
            rec, row = self._pending.popleft()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            row["device_s"] += rec.device_ms * 1e-3
            row["timed"] += 1
            self._free += rec.events
            rec.events = None

    def _watch_syncs(self):
        catch = warnings.catch_warnings(record=True)
        log = catch.__enter__()
        warnings.simplefilter("always")
        self._watch = (catch, log, torch.cuda.get_sync_debug_mode())
        self._seen = 0
        torch.cuda.set_sync_debug_mode("warn")

    def _charge(self, rec: _Record):
        if self._watch is None:
            return
        log = self._watch[1]
        rec.counts["host_syncs"] += sum(SYNC_WARNING in str(w.message)
                                        for w in log[self._seen:])
        self._seen = len(log)

    def _unwatch_syncs(self):
        catch, log, mode = self._watch
        self._watch = None
        torch.cuda.set_sync_debug_mode(mode)
        catch.__exit__(None, None, None)
        for w in log:
            if SYNC_WARNING not in str(w.message):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                       registry=self._registry)

    def summary(self) -> Dict[str, dict]:
        """Per span name: ``calls``, ``host_ms`` and (on a CUDA device)
        ``device_ms`` a call, and each counter's sum over the calls a call
        (``host_syncs`` always). Waits for the device once."""
        self._resolve(wait=True)
        out = {}
        for name, row in self.totals.items():
            n = row["calls"]
            s = {"calls": n, "host_ms": 1e3 * row["host_s"] / n}
            if row["timed"]:
                s["device_ms"] = 1e3 * row["device_s"] / row["timed"]
            s.update({k: v / n for k, v in row["counts"].items()})
            out[name] = s
        return out


SPANS = Spans()


class _Span:
    __slots__ = ("name", "counts", "rec")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.rec = SPANS.open(self.name, self.counts)
        return self

    def __exit__(self, *exc):
        SPANS.close(self.rec)
        return False


_OFF = nullcontext()


def span(name: str, **counts):
    """A span of ``SPANS`` named ``name`` with counters ``counts`` (numbers
    to add to its record), as a context manager. It is on while a torch
    profiler records (the benchmark's traced sub-window, ``RGBMANIP_PROFILE``)
    and costs the check of torch's flag otherwise."""
    if not _profiling():
        return _OFF
    return _Span(name, counts)


def count(**counts):
    """Add ``counts`` to the innermost span open, if a span is on."""
    if _profiling() and SPANS._stack:
        SPANS.count(counts)


class PhaseTimer:
    """Accumulating per-phase wall-clock timers (sim / render / nn / update),
    always on. Each phase is also a span (``span``), so that a profile of a
    run (``RGBMANIP_PROFILE``) shows which phase launched each kernel."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
