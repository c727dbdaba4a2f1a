"""Probe: is the card's row gather bound by row count or by bytes?
(Counterpart of the JAX package's ``scripts/probe_gather_regime.py``.)

    python -m rgbmanip_tpu_torch.scripts.probe_gather_regime [--device cpu]

The JAX probe's five (rows x row width) splits: three that move the same
bytes in 0.5x, 1x and 2x the rows, and two that keep the rows and move a
half and a quarter of the bytes. Each is one ``torch.index_select`` of a
bf16 table of 16 * 112 * 112 rows with random int32 indices, timed on the
card. Equal GB/s across the splits means the gather is bound by bytes;
equal Mrows/s means it is bound by rows. It calls no kernel of the port:
it measures the library gather that a warp kernel would compete with.
Without ``--device cpu`` it needs a card; on the CPU it runs each split at
a small size (``CPU_ROWS``) and times nothing.
"""

from __future__ import annotations

import argparse

import torch

from .perfutil import bench, card_line, require_card

TABLE_ROWS = 16 * 112 * 112              # the probe's table
TOTAL_ROWS = TABLE_ROWS * 24             # the warp's gathered rows at D=24
CPU_ROWS = (1024, 4096)                  # table and gathered rows off the card


def splits(total):
    """(rows, bf16 elements per row) of the JAX probe, in its order."""
    return ((total, 32), (total // 2, 64), (total * 2, 16), (total, 16), (total, 8))


def run(device="cuda", table_rows=TABLE_ROWS, total_rows=TOTAL_ROWS, seed=0,
        iters=5, reps=3):
    """One dict per split: rows, row bytes, ms (None on the CPU), GB/s and
    Mrows/s (gathered rows read + output written, the JAX probe's counting)."""
    dev = torch.device(device)
    if dev.type != "cpu":
        require_card(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for rows, C in splits(total_rows):
        table = torch.randn(table_rows, C, generator=g, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, table_rows, (rows,), generator=g, device=dev,
                            dtype=torch.int32)
        got = table.index_select(0, idx)
        if got.shape != (rows, C):
            raise RuntimeError(f"index_select gave {tuple(got.shape)}")
        ms = (bench(lambda t, ix: t.index_select(0, ix), table, idx, iters=iters,
                    reps=reps) if dev.type == "cuda" else None)
        gb = rows * C * 2 * 2 / 1e9
        out.append({"rows": rows, "row_bytes": C * 2, "ms": ms,
                    "gbps": None if ms is None else gb / (ms * 1e-3),
                    "mrows_per_s": None if ms is None else rows / (ms * 1e-3) / 1e6})
    return out


def describe(r) -> str:
    head = f"rows {r['rows'] / 1e6:5.1f}M x {r['row_bytes']:3d}B:"
    if r["ms"] is None:
        return head + " not measured (no card)"
    return (f"{head} {r['ms']:7.4f} ms ({r['gbps']:5.0f} GB/s, "
            f"{r['mrows_per_s']:6.0f} Mrows/s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type != "cpu"
    rows = run(args.device) if on_card else run("cpu", *CPU_ROWS)
    card = card_line() if on_card else "CPU"
    print(f"{card} | index_select of a bf16 table, int32 indices "
          f"(CUDA events, best of reps)", flush=True)
    for r in rows:
        print(describe(r), flush=True)


if __name__ == "__main__":
    main()
