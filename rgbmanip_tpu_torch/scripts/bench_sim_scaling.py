"""Collection scaling of the C++ ``SimPool`` (counterpart of the JAX
package's ``scripts/bench_sim_scaling.py``). Host work only: it runs
without a card.

    python -m rgbmanip_tpu_torch.scripts.bench_sim_scaling
        [--envs 1 2 4 8 16] [--threads 2 4 8] [--cycles 6]

Two measures:

  1. env-count efficiency at one pool thread: env-steps/s at N envs over
     the 1-env rate; a value near 1 means the pool adds no serialisation
     (locks, false sharing, queue contention) per env as the batch grows;
  2. threads at 8 envs: env-steps/s at 2, 4 and 8 worker threads over the
     1-thread rate.

The JAX script was written for a host with one core, where threads could
only show that oversubscription does not hurt. The card's host has many
cores (the script prints ``os.cpu_count()``), so threads now scale for
real, up to min(cores, envs).

Each row builds ``task=open_cabinet_no_dr`` with ``RGBMANIP_SIM_THREADS``
set to its thread count (``envs/vec_env.py`` reads it when it builds the
pool; the variable is restored after), resets, runs one warm-up cycle, then
times ``cycles`` cycles of ``pool.step_all(zero, n_substeps=30)`` and
``get_image()`` (physics bursts and the full 5-texture render). Prints one
JSON row per measure, then the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger


def measure(n_envs, n_threads, n_cycles=6, steps_per_cycle=30):
    log = get_logger()
    log.setLevel("WARNING")
    cfg = load_config(["task=open_cabinet_no_dr", f"task.num_envs={n_envs}"])
    before = os.environ.get("RGBMANIP_SIM_THREADS")
    os.environ["RGBMANIP_SIM_THREADS"] = str(n_threads)
    try:
        env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=0)
    finally:
        if before is None:
            del os.environ["RGBMANIP_SIM_THREADS"]
        else:
            os.environ["RGBMANIP_SIM_THREADS"] = before
    try:
        env.reset()
        zero = np.zeros((n_envs, 9))
        env.pool.step_all(zero, n_substeps=steps_per_cycle)     # warm-up cycle
        env.get_image()
        t0 = time.perf_counter()
        for _ in range(n_cycles):
            env.pool.step_all(zero, n_substeps=steps_per_cycle)
            env.get_image()
        dt = time.perf_counter() - t0
    finally:
        env.close()
    env_steps = n_cycles * steps_per_cycle * n_envs
    renders = n_cycles * n_envs
    return {"n_envs": n_envs, "n_threads": n_threads, "wall_s": dt,
            "env_steps_per_s": env_steps / dt, "renders_per_s": renders / dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, nargs="*", default=[1, 2, 4, 8, 16],
                    help="env counts at one thread")
    ap.add_argument("--threads", type=int, nargs="*", default=[2, 4, 8],
                    help="thread counts at 8 envs")
    ap.add_argument("--cycles", type=int, default=6)
    args = ap.parse_args(argv)
    print(f"host: os.cpu_count() = {os.cpu_count()}", flush=True)
    rows = []
    for n in args.envs:
        rows.append(measure(n, 1, args.cycles))
        print(json.dumps(rows[-1]), flush=True)
    for t in args.threads:
        rows.append(measure(8, t, args.cycles))
        print(json.dumps(rows[-1]), flush=True)

    by_envs = {r["n_envs"]: r for r in rows if r["n_threads"] == 1}
    if 1 in by_envs:
        one = by_envs[1]["env_steps_per_s"]
        print("\nefficiency vs 1-env serial (env_steps/s per env / 1-env rate):")
        for n, r in sorted(by_envs.items()):
            print(f"  n_envs={n:3d}: total {r['env_steps_per_s']:8.1f} steps/s"
                  f"  efficiency {r['env_steps_per_s'] / one:.3f}")
    threaded = [r for r in rows if r["n_threads"] > 1]
    if 8 in by_envs and threaded:
        base8 = by_envs[8]["env_steps_per_s"]
        print("threads at n_envs=8 (vs 1 thread):")
        for r in threaded:
            print(f"  threads={r['n_threads']}: {r['env_steps_per_s']:8.1f} steps/s"
                  f"  ratio {r['env_steps_per_s'] / base8:.3f}")
    return rows


if __name__ == "__main__":
    main()
