"""What every cell's run shares: the files a cell is made of, the device
record, the traced sub-window and its reading, the per-layer metrics found
by name, and the result line.

A cell is found by its name in ``BENCHMARK.json``; its traffic file is
``workloads/<cell>.json`` and names the driver (``drivers/<driver>.py``), its
configuration file is ``configs/<config>.json``, and each per-layer metric is
``metrics/<metric>.py`` with a ``read(run)`` that returns a number or None.
A configuration's plain reference is ``reference/<name>.py``, named by its
``"reference"`` key (``reference``).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rgbmanip_tpu")
TRACE_SECONDS = 3.0


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict):
    """The plain reference of the configuration's estimator generation: the
    module ``reference/<name>.py`` that its ``"reference"`` key names, "v5"
    where the key is absent. Such a module exposes ``network(cfg)``, the
    float32 network whose parameter names are the program's, and
    ``estimate(net, cfg, K, rgb1, mask1, ext1, rgb2, mask2, ext2, u1, u2)``,
    the whole estimate as a dict of ``bbox``, ``valid``, ``R_cam``, ``t_cam``
    and ``scale``."""
    return _reference(cfg.get("reference", "v5"))


@functools.cache
def _reference(name):
    path = os.path.join(HERE, "reference", f"{name}.py")
    if not (isinstance(name, str) and re.fullmatch(r"[A-Za-z0-9_]+", name)
            and os.path.isfile(path)):
        raise ValueError(f"the configuration's reference {name!r} names no module "
                         f"portbench/reference/<name>.py")
    mod = load_module("reference", name)
    if not all(callable(getattr(mod, f, None)) for f in ("network", "estimate")):
        raise ValueError(f"the configuration's reference {name!r}: reference/{name}.py "
                         f"has no network(cfg) and estimate(...)")
    return mod


def derive(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's ``--seed`` and ``tags`` (ints)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(
        2, dtype=np.uint32).astype(np.uint64).dot([1, 2 ** 32]) % 2 ** 63)


def cell_spec(bench: dict, name: str):
    """(workload entry, its end-to-end metrics, its per-layer metrics)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return cells[name], e2e, layer


def forbidden_modules():
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def span(name: str):
    """A host range of the benchmark's own (``record_function``), so that the
    trace labels the idle gaps that fall in it."""
    import torch
    return torch.profiler.record_function(f"portbench/{name}")


class Tracer:
    """torch.profiler over a sub-window of ``TRACE_SECONDS`` seconds, started
    and stopped between units of work by ``tick``. A session that recorded
    no device event is dropped and the next starts, until the window ends.
    ``active`` says whether the unit about to run is traced; ``paused`` is
    the time spent starting and reading sessions, which a driver leaves out
    of its window."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.active = False
        self.summary = None
        self.empty = 0
        self.t0 = None
        self.paused = 0.0

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prime(self, fn):
        """Set-up of a traced run: one profiler session around ``fn`` (a
        warm-up call), dropped, so that the profiler's own start-up is paid
        before the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        with profile(activities=acts):
            fn()
            self._sync()

    def tick(self, last: bool = False):
        if not self.enabled or self.summary is not None:
            return
        if self.prof is None:
            if last:
                return
            from torch.profiler import ProfilerActivity, profile
            t = time.perf_counter()
            self._sync()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
            self.paused += self.t0 - t
            self.active = True
            return
        if time.perf_counter() - self.t0 < TRACE_SECONDS and not last:
            return
        self._sync()
        t = time.perf_counter()
        window = t - self.t0
        self.prof.stop()
        self.active = False
        summary = read_trace(self.prof, window)
        self.prof = None
        self.paused += time.perf_counter() - t
        if summary is None:
            self.empty += 1
        else:
            summary["empty_sessions"] = self.empty
            self.summary = summary


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, window_s: float):
    """Busy time, kernels and idle gaps of one profiler session, or None
    when it holds no device event. Device activity is every kernel, copy
    and memset; an idle gap is labelled by the innermost host range
    (``record_function``: the program's phases and the benchmark's spans)
    open at its middle."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
        elif cat == "user_annotation":
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    if not dev:
        return None
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    lo = min(min(s for s, _, _ in dev), min((s for s, _, _ in ranges), default=busy[0][0]))
    hi = max(max(e for _, e, _ in dev), max((e for _, e, _ in ranges), default=busy[-1][1]))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = {}
    ranges.sort(key=lambda r: r[0])
    stack, i = [], 0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        while i < len(ranges) and ranges[i][0] <= mid:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "(no host range)"
        gaps[label] = gaps.get(label, 0.0) + (e - s) * 1e-6
    ops = {}
    for s, e, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "kernels": dev,
            "device_ops": ops, "idle_gaps": gaps}


def spread_line(took):
    """The quartiles and the longest of a window's units of work (rounds,
    calls), in ms, for telling a slow machine from slow work."""
    out = f"{len(took)} units"
    if len(took) >= 2:
        q = statistics.quantiles(took, n=4)
        out += (f", ms p25 {q[0] * 1e3:.1f} p50 {q[1] * 1e3:.1f} p75 {q[2] * 1e3:.1f}"
                f" max {max(took) * 1e3:.1f}")
    return out


def quantile(values, q: float):
    """The q-quantile (0 < q < 1) by ``statistics.quantiles`` (exclusive)."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="exclusive")[round(q * 100) - 1])


class Run:
    """What a driver hands the per-layer metrics: the cell's files, the
    window, the program's phase totals, counts of work, and the trace
    summary."""

    def __init__(self, cell, cfg, wl, seed, seconds, trace, device):
        self.cell, self.cfg, self.wl = cell, cfg, wl
        self.seed, self.seconds = seed, seconds
        self.device = device
        self.tracer = Tracer(trace, device)
        self.phases = {}          # PhaseTimer totals and counts over the window
        self.counts = {}          # work over the window, and in the traced part
        self.window_s = None

    @property
    def traced(self):
        return self.tracer.summary


def device_record(torch, device, chips: int, peak: int, summary):
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": int(peak)}
    if summary is not None:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec


def breakdown(summary):
    def top(d):
        return [[re.sub(r"\s+", " ", k)[:160], v]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["device_ops"]), "idle_gaps": top(summary["idle_gaps"])}


def power_line(torch, device):
    """The card's name and power limit, by nvidia-smi where it answers."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(device)
