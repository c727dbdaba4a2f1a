"""Read and write flax msgpack checkpoints with ``msgpack`` alone.

``flax.serialization.to_bytes`` writes a msgpack map whose array leaves are
ext type 1 holding ``(shape, dtype name, raw buffer)``; numpy scalars are
ext type 3 holding ``(shape, dtype name, raw buffer)`` of a 0-d array.
Tuples and lists are written as maps with string keys ``"0"``, ``"1"``, ...
The reader turns every leaf into a numpy array and leaves the tree as nested
dicts; the writer takes such a tree (numpy arrays and scalars, Python
numbers and strings, dicts, lists, tuples) and writes the same format, so
the JAX package's ``flax.serialization.from_bytes`` reads it back.
"""

from __future__ import annotations

import json
import os
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
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)[()]
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


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    raise TypeError(f"cannot write a {type(x).__name__} into a checkpoint")


def _state_dict(tree):
    """flax's ``to_state_dict`` for plain trees: tuples and lists become
    maps with string keys, dict keys become strings."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_msgpack(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``."""
    return msgpack.packb(_state_dict(tree), default=_ext_pack, strict_types=True)


def write_msgpack(path: str, tree) -> None:
    """Write ``tree`` to ``path`` through a temporary file that is synced and
    renamed, so that a reader never sees a half-written checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(to_msgpack(tree))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
