"""Hydra-compatible config composition over the port's YAML groups
(counterpart of ``rgbmanip_tpu/config/loader.py``; the ``cfg`` files are
copies of the JAX package's that the port's slices run).

A root ``config.yaml`` names a default per group; CLI arguments either swap
a group (``task=open_drawer``) or override a leaf with a dotted path
(``task.num_envs=4``). The composed result is a plain nested dict.
``load_group`` loads one group file on its own. Each takes ``cfg_root``,
another tree to compose from (a generated one: ``generate_cfg.py``), for
that call only.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml

CFG_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cfg")
GROUPS = ("dataset", "task", "pose_estimator", "manipulation", "controller", "train")


class ConfigError(ValueError):
    pass


def _load_yaml(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def load_group(group: str, name: str, overrides: Optional[Dict[str, Any]] = None,
               cfg_root: Optional[str] = None) -> Dict[str, Any]:
    """Load ``<cfg_root>/<group>/<name>.yaml`` (``CFG_ROOT`` by default) and
    apply ``{"a.b": value}`` overrides to its leaves."""
    path = os.path.join(cfg_root or CFG_ROOT, group, f"{name}.yaml")
    cfg = copy.deepcopy(_load_yaml(path))
    for dotted, value in (overrides or {}).items():
        _set_dotted(cfg, dotted, value)
    return cfg


def apply_overrides(cfg: Dict[str, Any], overrides: List[str],
                    cfg_root: Optional[str] = None) -> Dict[str, Any]:
    """Apply CLI overrides with Hydra's two-phase semantics: ALL group
    selections (``controller=rl``) first, then ALL dotted value overrides
    (``controller.load=...``), regardless of CLI order, so that a trailing
    group swap never drops an earlier dotted override into the same group.
    Values are parsed with YAML scalar rules."""
    cfg = copy.deepcopy(cfg)
    dotted: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        if key in GROUPS:
            cfg[key] = load_group(key, val, cfg_root=cfg_root)
        else:
            dotted.append((key, val))
    for key, val in dotted:
        _set_dotted(cfg, key, yaml.safe_load(val))
    return cfg


def load_config(overrides: Optional[List[str]] = None,
                cfg_root: Optional[str] = None) -> Dict[str, Any]:
    """Compose the root defaults, the group files and the CLI overrides,
    from ``cfg_root`` when given (for this call only: the JAX package's
    ``load_config`` also makes it the module's ``CFG_ROOT`` for every later
    call), else from ``CFG_ROOT``."""
    root = _load_yaml(os.path.join(cfg_root or CFG_ROOT, "config.yaml"))
    defaults = root.pop("defaults", {})
    cfg: Dict[str, Any] = dict(root)
    for group in GROUPS:
        name = defaults.get(group)
        cfg[group] = None if name is None else load_group(group, name, cfg_root=cfg_root)
    if overrides:
        cfg = apply_overrides(cfg, overrides, cfg_root)
    for group in GROUPS:
        if cfg.get(group) is None:
            raise ConfigError(f"config group '{group}' unset: pass {group}=<name>")
    return cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
