"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's work from the seed, warms up every shape it uses (the
set-up, timed from the start of this process to the first timed call),
drives the program for ``--seconds`` seconds, then checks what the window
produced against the plain reference. With ``--trace 0`` the result line
carries the cell's end-to-end metrics; with ``--trace 1`` a profiler records
a sub-window and the line carries the per-layer metrics, the device's busy
time and a breakdown. The numbers compared are printed beside their limits
as the last lines of standard error and under ``checks``, the last key of
the result, which is the last line of standard output.

It exits non-zero without a result when the card (or as many cards as the
cell asks for) is missing, when the program cannot be imported, and when
JAX or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device=None, bench=None, cfg=None, wl=None, t0=None):
    """Run a cell and print its result; returns the exit code. ``device``
    and the cell's files may be given by a test, which then skips the look
    for a card."""
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench import harness as H
    os.environ.setdefault("RGBMANIP_LOGLEVEL", "WARNING")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(H.ROOT, "build", "triton"))
    bench = bench or H.load_json(H.ROOT, "BENCHMARK.json")
    cell, e2e, layer = H.cell_spec(bench, args.workload)
    wl = wl or H.load_json(H.HERE, "workloads", f"{cell['name']}.json")
    cfg = cfg or H.load_json(H.HERE, "configs", f"{cell['config']}.json")
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        print(f"portbench: {H.power_line(torch, device)}; torch {torch.__version__}",
              file=sys.stderr)
    run = H.Run(cell, cfg, wl, args.seed, args.seconds, bool(args.trace), device)
    driver = H.load_module("drivers", wl["driver"])
    out = driver.run(run, T0 if t0 is None else t0)

    bad = H.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port must not", file=sys.stderr)
        return 3
    if args.trace and run.traced is None:
        print(f"portbench: no traced session held a device event "
              f"({run.tracer.empty} empty)", file=sys.stderr)
        return 4
    metrics = {}
    if args.trace:
        for m in layer:
            value = H.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit} for name, value, limit, _ in out["checks"]}
    correct = all(ok for *_, ok in out["checks"]) and out["failed"] == 0
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": H.device_record(torch, device, int(cell["chips"]), out["peak"],
                                        run.traced if args.trace else None)
              if device.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0,
                                             "memory_peak_bytes": 0}}
    if args.trace:
        result["breakdown"] = H.breakdown(run.traced)
    result["checks"] = checks
    for name, value, limit, ok in out["checks"]:
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
