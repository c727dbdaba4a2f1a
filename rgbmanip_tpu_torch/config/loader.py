"""YAML config groups of the port (copies of the JAX package's
``config/cfg`` files that this slice needs), with dotted overrides."""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

CFG_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfg")


def load_group(group: str, name: str,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load ``cfg/<group>/<name>.yaml`` and apply ``{"a.b": value}``
    overrides to its leaves."""
    path = os.path.join(CFG_ROOT, group, f"{name}.yaml")
    if not os.path.exists(path):
        raise ValueError(f"config file not found: {path}")
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    cfg = copy.deepcopy(cfg)
    for dotted, value in (overrides or {}).items():
        node = cfg
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return cfg
