"""Paper-style result plots (reference miscs/plot/{num_views,alpha}.py), the
port's copy of ``scripts/plot_results.py``.

Reads the JSONL metrics that ``MetricsWriter`` writes and draws the
success-rate / reward / loss curves as PDFs. matplotlib is imported only
when plotting.

    python -m rgbmanip_tpu_torch.scripts.plot_results --log_dir logs/test/<run> --out plots/
"""

from __future__ import annotations

import argparse
import collections
import json
import os


def load_metrics(path):
    series = collections.defaultdict(list)
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            series[rec["tag"]].append((rec["step"], rec["value"]))
    return {k: sorted(v) for k, v in series.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log_dir", required=True)
    ap.add_argument("--out", default="plots")
    ap.add_argument("--tags", nargs="*", default=None,
                    help="tags to plot (default: all)")
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics_path = os.path.join(args.log_dir, "metrics.jsonl")
    series = load_metrics(metrics_path)
    os.makedirs(args.out, exist_ok=True)
    tags = args.tags or list(series)
    for tag in tags:
        if tag not in series:
            print(f"skip {tag}: not in {metrics_path}")
            continue
        xs, ys = zip(*series[tag])
        fig, ax = plt.subplots(figsize=(4.2, 3.0))
        ax.plot(xs, ys, lw=1.5)
        ax.set_xlabel("step")
        ax.set_ylabel(tag)
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fname = os.path.join(args.out, tag.replace("/", "_") + ".pdf")
        fig.savefig(fname)
        plt.close(fig)
        print(f"wrote {fname}")


if __name__ == "__main__":
    main()
