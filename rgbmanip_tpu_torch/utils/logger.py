"""Process-global logger (a copy of ``rgbmanip_tpu/utils/logger.py``'s
``get_logger``; the metrics writer and phase timers are not ported yet)."""

from __future__ import annotations

import logging
import os
import sys


def get_logger(name: str = "rgbmanip_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s"))
        log.addHandler(h)
        log.setLevel(os.environ.get("RGBMANIP_LOGLEVEL", "INFO"))
    return log
