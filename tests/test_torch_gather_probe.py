"""Kernel K5 (the in-kernel row gather) and its probes, on the CPU.

The port's plain version of K5 must equal the Pallas kernel of
``scripts/try_pallas_gather.py`` exactly (a gather rounds nothing). The
script is run as it stands, in Pallas interpret mode: it is loaded with
importlib, its ``pl.pallas_call`` gets ``interpret=True``, and its
``scan_bench`` is replaced by a function that keeps the table and the
kernel's output instead of timing them; that function goes into
``sys.modules`` as the script's ``perfutil``, so the script's own import
of it searches no path.
"""

import functools
import importlib.util
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.ops import row_gather as k5
from rgbmanip_tpu_torch.scripts import perfutil, probe_gather_regime, try_gather

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def run_pallas_probe(monkeypatch, B, S, C, D):
    """(table, Pallas output) of scripts/try_pallas_gather.py at this shape,
    as float32 numpy arrays."""
    seen = {}

    def capture(fn, table, **_):
        seen["table"] = np.asarray(table).astype(np.float32)
        seen["out"] = np.asarray(fn(table)).astype(np.float32)
        return 1.0

    monkeypatch.setitem(sys.modules, "perfutil", types.SimpleNamespace(scan_bench=capture))
    # the script puts a fixed directory at the front of sys.path; that
    # change is undone when the test ends
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("try_pallas_gather",
                                                  os.path.join(SCRIPTS, "try_pallas_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    monkeypatch.setattr(sys, "argv", ["try_pallas_gather.py"] + [str(v) for v in (B, S, C, D)])
    mod.main()
    assert "out" in seen, "the Pallas probe failed before its timing (see its output)"
    return seen["table"], seen["out"]


@pytest.mark.parametrize("shape", [(2, 8, 32, 3), (1, 640, 8, 2)],
                         ids=["small", "int32-overflow"])
def test_plain_k5_equals_the_pallas_kernel(monkeypatch, shape):
    """(1, 640, 8, 2): HW = 409,600, so p * 7919 passes 2**31 and the
    reference's index wraps around."""
    B, S, C, D = shape
    table, ref = run_pallas_probe(monkeypatch, *shape)
    assert ref.shape == (B, D, S * S, C)
    out = k5.row_gather(torch.from_numpy(table).to(torch.bfloat16), D)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("HW,D", [(12544, 24), (409600, 2), (3_000_017, 5)])
def test_index_equals_the_jnp_expression(HW, D):
    ref = np.stack([np.asarray((jnp.arange(HW, dtype=jnp.int32) * 7919 + d * 104729) % HW)
                    for d in range(D)])
    out = k5.gather_index(HW, D)
    assert out.dtype == torch.int32 and out.shape == (D, HW)
    np.testing.assert_array_equal(out.numpy(), ref)
    if HW > 271_000:      # past the overflow the wrap-around is what was compared
        p = np.arange(HW, dtype=np.int64)
        assert ((p * 7919 + (D - 1) * 104729) % HW != ref[-1]).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_k5_equals_index_select(dtype):
    res = try_gather.run(2, 8, 32, 3, device="cpu", dtype=dtype)
    assert res["exact"] and res["max_abs_err"] == 0.0
    assert res["ms"] is None and res["library_ms"] is None


def test_k5_bound_at_the_default_shape():
    bound_bytes, probe_bytes = try_gather.traffic(16, 112, 32, 24, 2)
    assert bound_bytes == 12_845_056 + 308_281_344
    assert probe_bytes == 2 * 308_281_344
    assert abs(bound_bytes / try_gather.HBM_BYTES_PER_S * 1e3 - 0.0959) < 5e-5


@pytest.mark.parametrize("bad", ["dtype", "row-bytes", "strided", "rank"])
def test_k5_wrapper_rejects(bad):
    table = {"dtype": torch.zeros(1, 4, 8, dtype=torch.float16),
             "row-bytes": torch.zeros(1, 4, 4, dtype=torch.bfloat16),
             "strided": torch.zeros(1, 8, 16).transpose(1, 2),
             "rank": torch.zeros(4, 8)}[bad]
    with pytest.raises(ValueError):
        k5.row_gather(table, 2)


def test_probes_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probes would run for real")
    with pytest.raises(RuntimeError, match="card"):
        try_gather.run()
    with pytest.raises(RuntimeError, match="card"):
        probe_gather_regime.run()
    with pytest.raises(RuntimeError, match="card"):
        perfutil.bench(lambda t: t, torch.zeros(4))


def test_regime_probe_on_the_cpu_times_nothing():
    rows = probe_gather_regime.run("cpu", table_rows=64, total_rows=256)
    assert [(r["rows"], r["row_bytes"]) for r in rows] == [
        (256, 64), (128, 128), (512, 32), (256, 32), (256, 16)]
    assert all(r["ms"] is None for r in rows)
