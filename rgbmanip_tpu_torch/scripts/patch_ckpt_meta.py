"""Rewrite the depth-anchor metadata of an estimator checkpoint (the port's
counterpart of ``scripts/patch_ckpt_meta.py``, through
``utils/checkpoint.py``'s msgpack reader and writer instead of flax).

The checkpoint loader (``AdaPoseEstimator.load``) validates every arch knob
in the saved metadata against the live config and refuses on a mismatch.
That guard is right for shape-changing knobs (backend, strides, volume
size), but ``d_min``/``d_interval`` only move the plane-sweep depth
HYPOTHESES: the weights are shape-compatible across depth grids, and
fine-tuning from a coarse-grid checkpoint onto a finer grid converges far
faster than a random init. This tool re-anchors those two fields so that a
fine-depth run can seed from a coarse-depth checkpoint (how the mug's
fine-depth estimator was made).

    python -m rgbmanip_tpu_torch.scripts.patch_ckpt_meta SRC DST d_min=0.35 d_interval=0.08
"""

from __future__ import annotations

import json
import sys

from ..utils.checkpoint import read_msgpack, write_msgpack

ALLOWED = {"d_min", "d_interval"}


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    src, dst = args[0], args[1]
    patch = dict(kv.split("=", 1) for kv in args[2:])
    bad = set(patch) - ALLOWED
    if bad:
        raise SystemExit(f"refusing to patch shape-affecting knobs: {bad}")
    blob = read_msgpack(src)
    meta = json.loads(blob["meta"])
    for k, v in patch.items():
        print(f"{k}: {meta.get(k)} -> {float(v)}")
        meta[k] = float(v)
    blob["meta"] = json.dumps(meta)
    write_msgpack(dst, blob)  # a synced temporary file, then os.replace
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
