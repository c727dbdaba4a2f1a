"""The readings that a cell's correctness limits are set from: for each
seed, the numbers compared for the program (its timed entry, as a run drives
it) and for the control (the reference computed one precision step below
the cell's, in the program's place), each against the float32 reference,
at the cell's own size. Runs on the card; one JSON line per seed:

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 [--calls n]

A workload that ``BENCHMARK.json`` does not name takes ``--config``.
"""

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=None)
    p.add_argument("--config", default=None)
    args = p.parse_args(argv)
    from portbench import harness as H
    import torch
    bench = H.load_json(H.ROOT, "BENCHMARK.json")
    config = args.config or {w["name"]: w["config"]
                             for w in bench["workloads"]}[args.workload]
    wl = H.load_json(H.HERE, "workloads", f"{args.workload}.json")
    cfg = H.load_json(H.HERE, "configs", f"{config}.json")
    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = H.load_module("drivers", wl["driver"])
    for seed in args.seeds:
        r = driver.readings(cfg, wl, seed, device, args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
