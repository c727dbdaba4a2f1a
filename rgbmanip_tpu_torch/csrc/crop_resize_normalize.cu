// Fused crop -> bilinear resize -> ImageNet normalise for NVIDIA Hopper
// (sm_90a), bound to PyTorch through ctypes (rgbmanip_tpu_torch/ops/crop_resize.py).
//
// Replaces the Pallas TPU kernel rgbmanip_tpu/ops/pallas_preprocess.py::
// crop_resize_normalize (body `_kernel`). Per image b, from the window
// (rmin, cmin, inv_ratio = 1/ratio):
//   src_y(i) = rmin + (i + 0.5) * inv_ratio - 0.5     (same for x with cmin)
//   hat weights w(h) = max(0, 1 - |src - h|), each row divided by its sum
//   (floor 1e-6); out = separable bilinear resample, then (x - mean) / std.
// The TPU kernel built the dense (S x H) and (S x W) weight matrices and ran
// two MXU products per channel on a channel-planar frame. A hat row has at
// most two non-zero taps, floor(src) and floor(src) + 1, so here each thread
// reads those 2 x 2 taps of the HWC frame directly; taps outside the frame
// are dropped and the rest renormalised by their sum, which is exactly the
// renormalised hat row.
//
// Bound: bytes. Per output pixel the kernel reads 4 taps x 3 channels of f32
// and writes 3 values; there are ~20 flops per output value, far below the
// card's flop-to-byte balance. The least traffic is the distinct source
// pixels the taps touch (at most min(h, 2S)^2 per image) plus the output.
//
// Design (first version: simple and right): one thread per output pixel
// (b, y, x), all three channels. Neighbouring threads take neighbouring x, so
// their taps fall on neighbouring source columns and the loads coalesce
// through L1/L2. The window arithmetic rounds where the reference rounds:
// XLA compiles rmin + (i + 0.5) * inv_ratio into one fused multiply-add, so
// src is one __fmaf_rn; every other step is a separate _rn intrinsic, which
// nvcc never contracts. The taps and weights then equal the plain PyTorch
// version's bit for bit. Shared-memory tiles of the window and vector loads
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two taps of one renormalised hat row: indices i0, i0 + 1 (clamped into the
// frame for the load) and their weights (0 for a tap outside [0, n - 1]).
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float lo, float inv_ratio, int i, int n) {
  // src = fma(i + 0.5, inv_ratio, lo) - 0.5
  const float src = __fsub_rn(
      __fmaf_rn(__fadd_rn(static_cast<float>(i), 0.5f), inv_ratio, lo), 0.5f);
  const float f0 = floorf(src);
  const float f1 = __fadd_rn(f0, 1.0f);
  float w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(src, f0))));
  float w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(src, f1))));
  const bool in0 = f0 >= 0.0f && f0 <= static_cast<float>(n - 1);
  const bool in1 = f1 >= 0.0f && f1 <= static_cast<float>(n - 1);
  w0 = in0 ? w0 : 0.0f;
  w1 = in1 ? w1 : 0.0f;
  const float norm = fmaxf(__fadd_rn(w0, w1), 1e-6f);
  Taps t;
  t.w0 = __fdiv_rn(w0, norm);
  t.w1 = __fdiv_rn(w1, norm);
  t.i0 = in0 ? static_cast<int>(f0) : 0;
  t.i1 = in1 ? static_cast<int>(f1) : 0;
  return t;
}

template <typename OutT>
__global__ void crop_resize_normalize_kernel(const float* __restrict__ rgb,
                                             const float* __restrict__ win,
                                             OutT* __restrict__ out, int B,
                                             int H, int W, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * S * S;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % S);
  const int y = static_cast<int>((idx / S) % S);
  const int b = static_cast<int>(idx / (static_cast<long long>(S) * S));

  const float rmin = win[3 * b + 0];
  const float cmin = win[3 * b + 1];
  const float inv_ratio = win[3 * b + 2];
  const Taps ty = hat_taps(rmin, inv_ratio, y, H);
  const Taps tx = hat_taps(cmin, inv_ratio, x, W);

  const float* img = rgb + static_cast<long long>(b) * H * W * 3;
  const float* r0 = img + static_cast<long long>(ty.i0) * W * 3;
  const float* r1 = img + static_cast<long long>(ty.i1) * W * 3;
  OutT* o = out + idx * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // rows first, then columns: the order of the TPU kernel's (Wy @ img) @ Wx^T
    const float col0 = __fadd_rn(__fmul_rn(ty.w0, r0[tx.i0 * 3 + c]),
                                 __fmul_rn(ty.w1, r1[tx.i0 * 3 + c]));
    const float col1 = __fadd_rn(__fmul_rn(ty.w0, r0[tx.i1 * 3 + c]),
                                 __fmul_rn(ty.w1, r1[tx.i1 * 3 + c]));
    const float v = __fadd_rn(__fmul_rn(tx.w0, col0), __fmul_rn(tx.w1, col1));
    o[c] = cast_out<OutT>(__fdiv_rn(__fsub_rn(v, kMean[c]), kStd[c]));
  }
}

template <typename OutT>
int launch(const void* rgb, const void* win, void* out, int B, int H, int W,
           int S, void* stream) {
  const long long total = static_cast<long long>(B) * S * S;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  crop_resize_normalize_kernel<OutT><<<blocks, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(win),
      static_cast<OutT*>(out), B, H, W, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points. rgb (B, H, W, 3) f32 contiguous; win (B, 3) f32 rows
// (rmin, cmin, 1/ratio); out (B, S, S, 3) contiguous. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int crop_resize_normalize_f32(const void* rgb, const void* win,
                                         void* out, int B, int H, int W, int S,
                                         void* stream) {
  return launch<float>(rgb, win, out, B, H, W, S, stream);
}

extern "C" int crop_resize_normalize_bf16(const void* rgb, const void* win,
                                          void* out, int B, int H, int W, int S,
                                          void* stream) {
  return launch<__nv_bfloat16>(rgb, win, out, B, H, W, S, stream);
}
