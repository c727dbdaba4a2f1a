"""No module of the benchmark imports JAX or the JAX package, top-level
names compared whole (the port's ``rgbmanip_tpu_torch`` begins with the JAX
package's name and is allowed in the harness); the reference and the counts
import nothing of the program either."""

import ast
import os
import sys

import pytest

from portbench import harness as H

FILES = sorted(os.path.relpath(os.path.join(d, f), H.HERE)
               for d, _, fs in os.walk(H.HERE) for f in fs if f.endswith(".py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rgbmanip_tpu"}


def imported(path):
    with open(os.path.join(H.HERE, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES
                                  if f.startswith(("reference", "counts", "metrics"))])
def test_yardstick_imports_nothing_of_the_program(path):
    assert "rgbmanip_tpu_torch" not in set(imported(path))


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import rgbmanip_tpu_torch  # noqa: F401
    assert "rgbmanip_tpu_torch" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in H.forbidden_modules()
