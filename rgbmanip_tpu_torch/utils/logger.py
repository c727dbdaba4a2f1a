"""Process-global logger, JSONL metrics writer and per-phase wall-clock
timers (copies of ``get_logger``, ``MetricsWriter`` and ``PhaseTimer`` from
``rgbmanip_tpu/utils/logger.py``)."""

from __future__ import annotations

import json
import logging
import os
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


class MetricsWriter:
    """Append-only JSONL metrics. The JAX package's writer also mirrors to
    TensorBoard where it is installed; the port leaves that out, since
    ``torch.utils.tensorboard`` loads TensorFlow where TensorFlow is
    installed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                   "t": time.time()}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def close(self):
        self._fh.close()


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
