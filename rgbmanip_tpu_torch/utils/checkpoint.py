"""Read flax msgpack checkpoints with ``msgpack`` alone.

``flax.serialization.to_bytes`` writes a msgpack map whose array leaves are
ext type 1 holding ``(shape, dtype name, raw buffer)``; numpy scalars are
ext type 3 holding ``(dtype name, raw buffer)``. Lists were written as maps
with string keys. The reader turns every leaf into a numpy array and leaves
the tree as nested dicts.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    if code == _EXT_NPSCALAR:
        dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype))[0]
    raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")


def read_msgpack(path: str) -> Dict[str, Any]:
    """The whole checkpoint tree, arrays as numpy."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(tree, meta): ``meta`` is the decoded JSON string an estimator
    checkpoint stores under ``"meta"`` ({} when there is none)."""
    tree = read_msgpack(path)
    meta = tree.pop("meta", None)
    return tree, (json.loads(meta) if meta else {})


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """{path tuple: leaf} for a nested dict."""
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out
