"""Probe: the in-kernel row gather K5 on the card (counterpart of the JAX
package's ``scripts/try_pallas_gather.py``).

    python -m rgbmanip_tpu_torch.scripts.try_gather [B S C D] [--dtype f32] [--device cpu]

A (B, S*S, C) table, D index patterns ``(p * 7919 + d * 104729) mod S*S``
computed inside the kernel, output (B, D, S*S, C); defaults B=16, S=112,
C=32, D=24 in bf16, the plane-sweep volume of the paper-size AdaPose
configuration. The kernel is held bit-exact against one
``torch.index_select`` with the index precomputed (the probe's ``xla_ref``),
then timed beside its plain version and that ``index_select``, against the
bound of moving its bytes once. Without ``--device cpu`` it needs a card; on
the CPU it checks the plain version and times nothing.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.row_gather import gather_index, row_gather, row_gather_plain
from .perfutil import HBM_BYTES_PER_S, bench, card_line, require_card

DEFAULT_SHAPE = (16, 112, 32, 24)        # B, S, C, D
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def flat_gather_index(B: int, HW: int, D: int, device=None) -> torch.Tensor:
    """(B * D * HW,) int64 rows of the flattened (B * HW, C) table."""
    offs = torch.arange(B, dtype=torch.int64, device=device)[:, None, None] * HW
    return (gather_index(HW, D, device).long()[None] + offs).reshape(-1)


def index_select_reference(table, D, flat_index):
    """The yardstick: one ``index_select`` of the flattened table."""
    B, HW, C = table.shape
    return table.reshape(B * HW, C).index_select(0, flat_index).reshape(B, D, HW, C)


def traffic(B, S, C, D, elem_bytes):
    """(bytes the bound counts: the table read once and the output written
    once; bytes the JAX probe's "GB/s eff" counts: the gathered rows read and
    the output written)."""
    table = B * S * S * C * elem_bytes
    out = table * D
    return table + out, 2 * out


def run(B=DEFAULT_SHAPE[0], S=DEFAULT_SHAPE[1], C=DEFAULT_SHAPE[2], D=DEFAULT_SHAPE[3],
        device="cuda", dtype=torch.bfloat16, seed=0, iters=20, reps=5):
    """Check K5 against ``index_select`` (bit-exact, or raise) and, on a
    card, time it. Returns a dict of the numbers; times are None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cpu":
        require_card(dev)
    HW = S * S
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(B, HW, C, generator=g, device=dev).to(dtype)
    flat_index = flat_gather_index(B, HW, D, dev)
    out = row_gather(table, D)
    ref = index_select_reference(table, D, flat_index)
    if out.shape != ref.shape or not torch.equal(out, ref):
        bad = (out != ref).any(-1).sum().item() if out.shape == ref.shape else "all"
        raise RuntimeError(f"K5 {(B, S, C, D)} {dtype}: {bad} rows differ from "
                           f"index_select")
    bound_bytes, probe_bytes = traffic(B, S, C, D, table.element_size())
    res = {"shape": [B, S, C, D], "dtype": str(dtype).replace("torch.", ""),
           "device": str(dev), "exact": True,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "bound_bytes": bound_bytes, "probe_bytes": probe_bytes,
           "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "ms": None, "plain_ms": None, "library_ms": None, "card": None}
    if dev.type == "cuda":
        res["ms"] = bench(row_gather, table, D, iters=iters, reps=reps)
        res["plain_ms"] = bench(row_gather_plain, table, D, iters=iters, reps=reps)
        res["library_ms"] = bench(lambda t, ix: index_select_reference(t, D, ix),
                                  table, flat_index, iters=iters, reps=reps)
        res["card"] = card_line()
    return res


def describe(res) -> str:
    B, S, C, D = res["shape"]
    head = (f"K5 row gather (B, S, C, D) = ({B}, {S}, {C}, {D}) {res['dtype']} on "
            f"{res['device']}: bit-exact against index_select")
    if res["ms"] is None:
        return head + "; times not measured (no card)"
    ms = res["ms"]
    return (f"{res['card']} | {head} | kernel {ms:.4f} ms: "
            f"{res['probe_bytes'] / ms / 1e6:.0f} GB/s eff (the JAX probe's "
            f"counting: gathered rows read + output written, "
            f"{res['probe_bytes'] / 1e6:.1f} MB), "
            f"{res['bound_bytes'] / ms / 1e6:.0f} GB/s of bound traffic (table "
            f"read once + output written once, {res['bound_bytes'] / 1e6:.1f} MB) "
            f"= {res['bound_ms'] / ms * 100:.1f}% of the {res['bound_ms']:.4f} ms "
            f"bound at 3.35 TB/s | plain {res['plain_ms']:.4f} ms | index_select "
            f"{res['library_ms']:.4f} ms (CUDA events, best of reps)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", nargs="*", type=int, metavar="B S C D")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.shape and len(args.shape) != 4:
        ap.error("give all four of B S C D, or none")
    shape = args.shape or list(DEFAULT_SHAPE)
    res = run(*shape, device=args.device, dtype=DTYPES[args.dtype])
    print(describe(res), flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
