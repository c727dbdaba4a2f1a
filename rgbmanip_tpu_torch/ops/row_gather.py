"""In-kernel row gather (kernel K5).

``row_gather(table, D)`` computes ``out[b, d, p, :] = table[b, idx(p, d), :]``
with ``idx(p, d) = (p * 7919 + d * 104729) mod HW``: the measurement probe
``scripts/try_pallas_gather.py::pallas_gather`` of the JAX package, whose
index is computed inside the kernel as a plane-sweep warp would compute its
source pixel. Layouts are the TPU kernel's: table (B, HW, C), output
(B, D, HW, C). A CUDA tensor goes through ``csrc/row_gather.cu`` (or the call
raises); only a CPU tensor takes the plain version, ``row_gather_plain``.

The index follows the reference's int32 arithmetic: the products and the sum
wrap around as two's complement, and the mod is a floor mod with the sign of
HW (``jnp.remainder``). Past HW ~ 271k (S >= 522) the sum overflows, and
then a wrapped value is what both sides must agree on.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

P_MULT, D_MULT = 7919, 104729
DTYPES = (torch.bfloat16, torch.float32)

_KERNEL = "row_gather"


@functools.cache
def _entry():
    """The kernel's C entry point, built on first use."""
    fn = load_library(_KERNEL).row_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_index(HW: int, D: int, device=None) -> torch.Tensor:
    """(D, HW) int32 rows ``(p * 7919 + d * 104729) mod HW`` in the
    reference's int32 arithmetic. The products are formed in int64 and
    wrapped to 32 bits explicitly (signed overflow is not something to rely
    on); the floor mod is ``torch.remainder`` on the int32 values."""
    p = torch.arange(HW, dtype=torch.int64, device=device)
    d = torch.arange(D, dtype=torch.int64, device=device)[:, None]
    x = (p * P_MULT + d * D_MULT) & 0xFFFFFFFF
    x = torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
    return torch.remainder(x, HW)


def row_gather_plain(table: torch.Tensor, D: int) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: the int32 index, then
    advanced indexing. table (B, HW, C) -> (B, D, HW, C)."""
    return table[:, gather_index(table.shape[1], D, table.device).long()]


def _check(table, D):
    if table.dim() != 3:
        raise ValueError(f"table must be (B, HW, C), got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise ValueError(f"table must be bfloat16 or float32, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (B, HW, C)")
    row_bytes = table.shape[2] * table.element_size()
    if row_bytes % 16 != 0:
        raise ValueError(f"a row of {row_bytes} bytes is not a whole number of "
                         f"16-byte vectors")
    if D < 1:
        raise ValueError(f"D must be positive, got {D}")


def row_gather(table: torch.Tensor, D: int) -> torch.Tensor:
    """K5. table (B, HW, C) contiguous bf16 or f32, rows a multiple of 16
    bytes. Returns (B, D, HW, C) of the same dtype and device."""
    _check(table, D)
    if table.device.type == "cpu":
        return row_gather_plain(table, D)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    B, HW, C = table.shape
    vecs = C * table.element_size() // 16
    if B * D >= 2 ** 31 or HW * vecs >= 2 ** 31:
        raise ValueError(f"shape (B={B}, HW={HW}, C={C}, D={D}) is past the "
                         f"kernel's 32-bit plane indexing")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (a view at an offset?)")
    out = torch.empty((B, D, HW, C), dtype=table.dtype, device=table.device)
    fn = _entry()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), out.data_ptr(), B, HW, D, vecs, stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: cudaError {err}")
    row_gather.launches += 1
    return out


# kernel launches so far; a run sets it to 0 and reads it to show that its
# path went through the kernel
row_gather.launches = 0
