"""Observation pytree utilities + gym-free spaces.

Replaces the reference's ``utils/tools.py`` (merge_obs/split_obs gather-scatter
at the vec-env boundary, gym-space plumbing; reference ``utils/tools.py:23-241``)
with plain-numpy pytree stacking and a tiny dependency-free Space hierarchy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# Spaces (gym-free)
# ---------------------------------------------------------------------------

@dataclass
class Box:
    low: np.ndarray
    high: np.ndarray

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is not None:
            low = np.full(shape, low, dtype=dtype)
            high = np.full(shape, high, dtype=dtype)
        self.low = np.asarray(low, dtype=dtype)
        self.high = np.asarray(high, dtype=dtype)

    @property
    def shape(self):
        return self.low.shape

    @property
    def dtype(self):
        return self.low.dtype

    def sample(self, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high).astype(self.dtype)

    def contains(self, x):
        return bool(np.all(x >= self.low) and np.all(x <= self.high))


class DictSpace(dict):
    """A dict of spaces; flattenable."""

    @property
    def spaces(self):
        return self


def flatdim(space) -> int:
    if isinstance(space, Box):
        return int(np.prod(space.shape))
    if isinstance(space, (DictSpace, dict)):
        return sum(flatdim(s) for s in space.values())
    raise TypeError(f"unknown space {type(space)}")


def concat_spaces(spaces: List[Box]) -> Box:
    """Concatenate Box spaces along their (flattened) last axis."""
    lows = [np.ravel(s.low) for s in spaces]
    highs = [np.ravel(s.high) for s in spaces]
    return Box(np.concatenate(lows), np.concatenate(highs))


def convert_observation_to_space(obs: Dict[str, Any], skip=("image",)) -> DictSpace:
    """Infer a DictSpace from an example observation dict."""
    out = DictSpace()
    for k, v in obs.items():
        if k in skip:
            continue
        arr = np.asarray(v)
        out[k] = Box(-np.inf, np.inf, shape=arr.shape, dtype=np.float32)
    return out


# ---------------------------------------------------------------------------
# Batched-observation pytrees
# ---------------------------------------------------------------------------

def merge_obs(results: List[Any]) -> Any:
    """Stack a list of per-env results (nested dict/tuple/array/scalar) into
    one batched pytree with a leading env axis."""
    first = results[0]
    if isinstance(first, dict):
        return {k: merge_obs([r[k] for r in results]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(merge_obs([r[i] for r in results]) for i in range(len(first)))
    if first is None:
        return None
    return np.stack([np.asarray(r) for r in results], axis=0)


def split_obs(batched: Any, num: int) -> List[Any]:
    """Inverse of :func:`merge_obs`: slice a batched pytree into per-env trees."""
    def index(tree, i):
        if isinstance(tree, dict):
            return {k: index(v, i) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(index(v, i) for v in tree)
        if tree is None:
            return None
        return np.asarray(tree)[i]

    return [index(batched, i) for i in range(num)]


def flatten_obs(obs: Dict[str, Any], skip=("image",)) -> np.ndarray:
    """Flatten a (possibly batched) observation dict into a (..., D) vector,
    keys in sorted order for determinism, skipping image-like entries."""
    keys = sorted(k for k in obs if k not in skip)
    parts = []
    batch_shape = None
    for k in keys:
        arr = np.asarray(obs[k], dtype=np.float32)
        if batch_shape is None:
            batch_shape = arr.shape[:1]
        parts.append(arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr[:, None])
    return np.concatenate(parts, axis=-1)


def regularize_dict(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in d.items() if v is not None}
