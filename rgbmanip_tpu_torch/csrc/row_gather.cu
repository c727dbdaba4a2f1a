// In-kernel row gather for NVIDIA Hopper (sm_90a), bound to PyTorch through
// ctypes (rgbmanip_tpu_torch/ops/row_gather.py).
//
// Replaces the Pallas TPU kernel scripts/try_pallas_gather.py::pallas_gather
// (body `kern`): for a row table (B, HW, C) and D index patterns,
//   out[b, d, p, :] = table[b, idx(p, d), :],
//   idx(p, d) = (p * 7919 + d * 104729) mod HW,
// with the index computed inside the kernel, as a plane-sweep warp kernel
// would compute its source pixel. The arithmetic is the reference's: int32
// with two's-complement wrap-around, then a floor mod (the sign of HW). Here
// the product and the sum run in uint32_t, whose wrap-around is defined, and
// the bits are read back as int32_t; C++'s `%` truncates, so a negative
// remainder gets HW added.
//
// Bound: bytes. There is no arithmetic to speak of; the least traffic is the
// table read once (B * HW * C elements) plus the output written once
// (B * D * HW * C), and the output is D times the table. At the probe's
// default shape (16, 112 x 112, 32, 24) in bf16 that is 12.85 MB + 308.3 MB.
//
// Design. The TPU kernel held one (HW, C) table in VMEM per grid step and ran
// take_along_axis on it. Here the table of every batch (12.85 MB at the
// default shape) fits in the card's 50 MB L2, so the gathered reads hit L2
// after the first touch and the kernel is bound by writing the output:
//   - each thread moves one 16-byte vector, so a 64-byte bf16 row is four
//     neighbouring lanes and a warp writes eight whole rows, coalesced;
//   - each thread computes its own row's index (a few integer operations);
//   - the output is written with streaming stores (st.global.cs), so the
//     stream of output lines does not push the table out of L2.
// blockIdx.x walks the vectors of one (b, d) plane and a loop over
// blockIdx.y walks the B * D planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int gather_row(int p, int d, int hw) {
  const uint32_t x = static_cast<uint32_t>(p) * 7919u + static_cast<uint32_t>(d) * 104729u;
  int r = static_cast<int32_t>(x) % hw;
  if (r < 0) r += hw;
  return r;
}

__global__ void row_gather_kernel(const uint4* __restrict__ table,
                                  uint4* __restrict__ out, int B, int HW, int D,
                                  int vecs_per_row) {
  const int plane_vecs = HW * vecs_per_row;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= plane_vecs) return;
  const int p = j / vecs_per_row;
  const int v = j - p * vecs_per_row;
  for (int plane = blockIdx.y; plane < B * D; plane += gridDim.y) {
    const int b = plane / D;
    const int d = plane - b * D;
    const long long src =
        (static_cast<long long>(b) * HW + gather_row(p, d, HW)) * vecs_per_row + v;
    const long long dst = static_cast<long long>(plane) * plane_vecs + j;
    __stcs(out + dst, __ldg(table + src));
  }
}

}  // namespace

// Plain C entry point. table (B, HW, row_bytes) and out (B, D, HW, row_bytes)
// contiguous and 16-byte aligned, row_bytes = 16 * vecs_per_row; the element
// type does not matter to a copy. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int row_gather(const void* table, void* out, int B, int HW, int D,
                          int vecs_per_row, void* stream) {
  const long long plane_vecs = static_cast<long long>(HW) * vecs_per_row;
  if (plane_vecs == 0 || B == 0 || D == 0) return 0;
  const int threads = 256;
  const unsigned blocks_x = static_cast<unsigned>((plane_vecs + threads - 1) / threads);
  const long long planes = static_cast<long long>(B) * D;
  const unsigned blocks_y = static_cast<unsigned>(planes < 65535 ? planes : 65535);
  row_gather_kernel<<<dim3(blocks_x, blocks_y), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<uint4*>(out), B, HW, D,
      vecs_per_row);
  return static_cast<int>(cudaGetLastError());
}
