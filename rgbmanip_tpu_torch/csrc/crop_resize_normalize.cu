// Fused crop -> bilinear resize -> ImageNet normalise for NVIDIA Hopper
// (sm_90a), bound to PyTorch through ctypes (rgbmanip_tpu_torch/ops/crop_resize.py).
//
// Replaces the Pallas TPU kernel rgbmanip_tpu/ops/pallas_preprocess.py::
// crop_resize_normalize (body `_kernel`). Per image b, from the window
// (rmin, cmin, inv_ratio = 1/ratio):
//   src_y(i) = rmin + (i + 0.5) * inv_ratio - 0.5     (same for x with cmin)
//   hat weights w(h) = max(0, 1 - |src - h|), each row divided by its sum
//   (floor 1e-6); out = separable bilinear resample, then (x - mean) / std.
// A hat row has at most two non-zero taps, floor(src) and floor(src) + 1;
// taps outside the frame are dropped and the rest renormalised by their sum,
// which is exactly the renormalised hat row.
//
// Bound: bytes. There are ~11 operations per output value, far below the
// card's flop-to-byte balance. The least traffic is each source pixel a tap
// touches read once (at most min(|h|, 2S)^2 per image) plus the output
// written once.
//
// Design. The TPU kernel ran (Wy @ img) @ Wx^T as two MXU products per
// channel with dense hat matrices. Here the same separable order runs
// through shared memory:
//   - Grid: one CTA of kThreads = 64 threads per (image, band of kBand = 2
//     output rows). A CTA holds two row buffers of a 640 px frame (7.7 KB
//     each) and the column taps, ~19 KB, and ptxas gives it under 128
//     registers a thread, so 8 CTAs fit on an SM and the main path's grid
//     is one wave on 132 SMs (1,056 slots): 768 CTAs at B=8, S=192 and 896
//     at B=8, S=224. The first version ran one thread per output pixel in
//     1.09-1.48 waves. (Of the band/block/unroll sizes tried on the card,
//     64 threads, 2 rows and 8 loads in flight were fastest at B=8 and no
//     slower at B=64.)
//   - Column taps once per CTA: the S entries (x0, x1, wx0, wx1) go to
//     shared memory as offsets into a row buffer. Each band row's
//     (y0, y1, wy0, wy1) is computed once, by the threads that form it.
//   - Vertical pass from device memory: for each band row the source
//     columns that the window's taps touch, [lo, hi], are contiguous in the
//     HWC frame, in both source rows y0 and y1. One warp per band row reads
//     them as 16-byte __ldg loads, kUnroll = 8 pairs in flight a lane, forms
//     col = wy0 * r0 + wy1 * r1 on the interleaved RGB floats (the weights
//     do not depend on the channel) and stores it to the row's buffer. The
//     column taps are computed while the first loads are in flight.
//   - Horizontal pass from shared memory: a thread takes kPix neighbouring
//     output pixels of a row, each value wx0 * col[x0] + wx1 * col[x1],
//     then (v - mean) / std, and writes its 3 * kPix values as 16-byte
//     stores (bf16: pairs packed into 8-byte stores); where S is not a
//     multiple of kPix, rows do not start 16-byte aligned and the stores
//     are scalar.
// The span runs from the lower to the higher end of the window, so a
// reversed window (a negative side: an empty mask gives rmin 460, rmax 20)
// reads the same way as a forward one; it is clamped to the frame, and a
// tap outside the frame (weight 0) is read at the span's edge. A frame
// whose rows are not a whole number of 16-byte vectors (W not a multiple of
// 4) takes scalar loads in the vertical pass.
//
// Rounding, as in the reference: XLA compiles rmin + (i + 0.5) * inv_ratio
// into one fused multiply-add, so src is one __fmaf_rn; every other step is
// a separate _rn intrinsic, which nvcc never contracts, in the order rows,
// then columns; the division by std is exact (see `normalise`). The f32
// output then equals the plain PyTorch version bit for bit on a finite
// frame.
//
// The clamping border mode (template parameter kClamp; entry points
// crop_resize_normalize_clamp_*) computes instead what the JAX package's
// portable fallback computes (rgbmanip_tpu/ops/preprocess.py:
// prepare_model_input without Pallas, over bilinear_sample_batched), the
// crop of every training batch of its estimator trainer, which prepares
// batches on the CPU backend. Per output coordinate, from (rmin, cmin,
// ratio = S / side):
//   src = (lo + (i + 0.5) / ratio) - 0.5, f = floor(src), w = src - f,
//   taps i0 = clip(f, 0, n - 1), i1 = min(i0 + 1, n - 1), weights 1 - w, w
// (from the unclamped floor: a tap row below 0 mixes rows 0 and 1, not row
// 0 alone), then the four-term sum and (v - mean) * (1 / std). The rounding
// is XLA's on the CPU, found by probing its compiled fallback: each
// division correctly rounded, the sum
//   fma(g00 (1-wy), 1-wx, (g01 (1-wy)) wx), + g10 wy (1-wx), + g11 wy wx
// as a chain of fused multiply-adds, and the division by the constant std
// as a product with its f32 reciprocal. The same band structure serves
// it: the vertical pass stores the two source rows already multiplied by
// their row weights (two buffers per band row), the horizontal pass forms
// the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;                     // threads per CTA
constexpr int kBand = 2;                         // output rows per CTA
constexpr int kRowThreads = kThreads / kBand;    // threads per band row in the vertical pass
constexpr int kUnroll = 8;                       // 16-byte load pairs in flight per thread
constexpr int kPix = 4;                          // output pixels per thread in the horizontal pass

// Two taps of one renormalised hat row: indices i0, i0 + 1 (0 for a tap
// outside [0, n - 1]) and their weights (0 for a tap outside the frame).
struct Taps {
  int i0, i1;
  float w0, w1;
};

// One output column's taps as float offsets into a row buffer.
struct ColTap {
  int q0, q1;
  float w0, w1;
};

// `scale` is inv_ratio in the renormalising mode and ratio in the clamping one
template <bool kClamp>
__device__ __forceinline__ float src_coord(float lo, float scale, int i) {
  const float a = __fadd_rn(static_cast<float>(i), 0.5f);
  if (kClamp) return __fsub_rn(__fadd_rn(lo, __fdiv_rn(a, scale)), 0.5f);  // (lo + a / ratio) - 0.5
  return __fsub_rn(__fmaf_rn(a, scale, lo), 0.5f);  // fma(a, inv_ratio, lo) - 0.5
}

__device__ __forceinline__ Taps hat_taps(float lo, float inv_ratio, int i, int n) {
  const float src = src_coord<false>(lo, inv_ratio, i);
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

// The clamping mode's taps: from the unclamped floor f, i0 = clip(f),
// i1 = min(i0 + 1, n - 1), weights (1 - w, w) with w = src - f.
__device__ __forceinline__ Taps clamp_taps(float lo, float ratio, int i, int n) {
  const float src = src_coord<true>(lo, ratio, i);
  const float f = floorf(src);
  const float w = __fsub_rn(src, f);
  Taps t;
  t.i0 = static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
  t.i1 = min(t.i0 + 1, n - 1);
  t.w0 = __fsub_rn(1.0f, w);
  t.w1 = w;
  return t;
}

template <bool kClamp>
__device__ __forceinline__ Taps taps_of(float lo, float scale, int i, int n) {
  return kClamp ? clamp_taps(lo, scale, i, n) : hat_taps(lo, scale, i, n);
}

// [first, last]: the source indices, clamped into [0, n - 1], between the
// taps of output 0 and output S - 1. src is monotonic in i (each step rounds
// monotonically), so every tap inside the frame lies in this span, whichever
// way the window runs. (The clamping mode's second tap of a floor below 0 is
// index 1, hence its floor of 0 under the last tap's floor.)
template <bool kClamp>
__device__ __forceinline__ void tap_span(float lo, float scale, int S, int n,
                                         int& first, int& last) {
  const float a = floorf(src_coord<kClamp>(lo, scale, 0));
  const float b = floorf(src_coord<kClamp>(lo, scale, S - 1));
  const float top = static_cast<float>(n - 1);
  const float hi = kClamp ? fmaxf(fmaxf(a, b), 0.0f) : fmaxf(a, b);
  first = static_cast<int>(fminf(fmaxf(fminf(a, b), 0.0f), top));
  last = static_cast<int>(fminf(fmaxf(__fadd_rn(hi, 1.0f), 0.0f), top));
}

// rows first: the vertical half of the TPU kernel's (Wy @ img) @ Wx^T
__device__ __forceinline__ float mix(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__device__ __forceinline__ float4 mix4(const Taps& t, const float4& a, const float4& b) {
  return make_float4(mix(t.w0, a.x, t.w1, b.x), mix(t.w0, a.y, t.w1, b.y),
                     mix(t.w0, a.z, t.w1, b.z), mix(t.w0, a.w, t.w1, b.w));
}

__device__ __forceinline__ float4 scale4(float w, const float4& a) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w), __fmul_rn(a.z, w),
                     __fmul_rn(a.w, w));
}

// the clamping mode's four-term sum from the weighted rows a = g(y0) (1 - wy)
// and b = g(y1) wy: fma(a0, 1-wx, a1 wx), then + b0 (1-wx), then + b1 wx
__device__ __forceinline__ float chain(float w0, float w1, float a0, float a1, float b0,
                                       float b1) {
  const float v = __fmaf_rn(a0, w0, __fmul_rn(a1, w1));
  return __fmaf_rn(b1, w1, __fmaf_rn(b0, w0, v));
}

// (v - mean) / std, the quotient correctly rounded: q = x * (1/std) and one
// FMA correction step. For these three divisors that equals IEEE division
// (__fdiv_rn, and the plain version's) for every normal x, checked
// exhaustively over one binade of x (tests/test_torch_preprocess.py), in
// three instructions instead of a division's ten and a branch.
template <int C>
__device__ __forceinline__ float normalise(float v) {
  constexpr float kMean = C == 0 ? 0.485f : (C == 1 ? 0.456f : 0.406f);
  constexpr float kStd = C == 0 ? 0.229f : (C == 1 ? 0.224f : 0.225f);
  constexpr float kInv = 1.0f / kStd;
  const float x = __fsub_rn(v, kMean);
  const float q = __fmul_rn(x, kInv);
  return __fmaf_rn(__fmaf_rn(-q, kStd, x), kInv, q);
}

// The clamping mode's (v - mean) * f32(1 / f32(std)), as XLA rewrites the
// division by a constant (the reciprocals' bits, hex, from numpy's f32).
template <int C>
__device__ __forceinline__ float normalise_clamp(float v) {
  constexpr float kMean = C == 0 ? 0.485f : (C == 1 ? 0.456f : 0.406f);
  constexpr float kInv = C == 0 ? 0x1.1779dap+2f : (C == 1 ? 0x1.1db6dap+2f : 0x1.1c71c8p+2f);
  return __fmul_rn(__fsub_rn(v, kMean), kInv);
}

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four values: one 16-byte store in f32, two packed bf16 pairs (8 bytes)
__device__ __forceinline__ void store4(float* o, const float4& v) {
  *reinterpret_cast<float4*>(o) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float4& v) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Floats in one row buffer: the widest span (W columns) plus the 16-byte
// alignment of its two ends, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int row_buffer_floats(int W) {
  return (3 * W + 6 + 3) / 4 * 4;
}

// Row buffers per band row: the mixed row, or the clamping mode's two
// weighted rows.
template <bool kClamp>
__host__ __device__ constexpr int buffers_per_row() { return kClamp ? 2 : 1; }

template <typename OutT, bool kClamp>
__global__ void __launch_bounds__(kThreads)
crop_resize_normalize_kernel(const float* __restrict__ rgb,
                             const float* __restrict__ win,
                             OutT* __restrict__ out, int H, int W, int S) {
  extern __shared__ float4 smem[];
  constexpr int kBuf = buffers_per_row<kClamp>();
  const int stride = row_buffer_floats(W);
  float* col = reinterpret_cast<float*>(smem);                            // kBand x kBuf row buffers
  ColTap* taps = reinterpret_cast<ColTap*>(col + kBand * kBuf * stride);   // kPix x G column taps
  const int G = (S + kPix - 1) / kPix;                               // pixel groups per row

  const int b = blockIdx.y;
  const int y_first = blockIdx.x * kBand;
  const int rows = min(kBand, S - y_first);
  const float rmin = __ldg(win + 3 * b + 0);
  const float cmin = __ldg(win + 3 * b + 1);
  const float scale = __ldg(win + 3 * b + 2);  // inv_ratio, or the clamping mode's ratio

  int lo, hi;
  tap_span<kClamp>(cmin, scale, S, W, lo, hi);
  const int W3 = 3 * W;
  const bool vec = (W3 & 3) == 0;
  // the floats [a0, a1) of a source row that the vertical pass reads
  const int a0 = vec ? (3 * lo) & ~3 : 3 * lo;
  const int a1 = vec ? (3 * hi + 6) & ~3 : 3 * hi + 3;
  const int shift = 3 * lo - a0;  // where column lo starts in a row buffer

  const float* img = rgb + static_cast<size_t>(b) * H * W3;

  // ---- vertical pass: col = wy0 * row y0 + wy1 * row y1 over [a0, a1) ----
  // warp r forms band row r: its two source rows' spans, kUnroll 16-byte
  // loads of each in flight a lane before the first mix
  const int r = threadIdx.x / kRowThreads;
  const int lane = threadIdx.x % kRowThreads;
  const bool active = r < rows;  // uniform across each warp
  const Taps ty = taps_of<kClamp>(rmin, scale, y_first + r, H);
  const int n4 = vec ? (a1 - a0) >> 2 : 0;
  const float4* row0 = reinterpret_cast<const float4*>(img + ty.i0 * W3 + a0);
  const float4* row1 = reinterpret_cast<const float4*>(img + ty.i1 * W3 + a0);
  float* dst_row = col + kBuf * r * stride;
  float4* dst = reinterpret_cast<float4*>(dst_row);
  float4* dst1 = reinterpret_cast<float4*>(dst_row + stride);  // the clamping mode's second row
  float4 p[kUnroll], q[kUnroll];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + kRowThreads * u;
      if (active && j < n4) {
        p[u] = __ldg(row0 + j);
        q[u] = __ldg(row1 + j);
      }
    }
  };
  auto finish = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + kRowThreads * u;
      if (active && j < n4) {
        if (kClamp) {
          dst[j] = scale4(ty.w0, p[u]);
          dst1[j] = scale4(ty.w1, q[u]);
        } else {
          dst[j] = mix4(ty, p[u], q[u]);
        }
      }
    }
  };
  fetch(lane);
  // the column taps while the first loads are in flight; pixel x of group
  // g sits at (x % kPix) * G + g, so a warp's tap reads are contiguous
  for (int x = threadIdx.x; x < S; x += kThreads) {
    const Taps t = taps_of<kClamp>(cmin, scale, x, W);
    ColTap c;
    c.q0 = 3 * (min(max(t.i0, lo), hi) - lo) + shift;
    c.q1 = 3 * (min(max(t.i1, lo), hi) - lo) + shift;
    c.w0 = t.w0;
    c.w1 = t.w1;
    taps[(x % kPix) * G + x / kPix] = c;
  }
  finish(lane);
  for (int j0 = lane + kRowThreads * kUnroll; j0 < n4; j0 += kRowThreads * kUnroll) {
    fetch(j0);
    finish(j0);
  }
  if (!vec && active) {  // rows of W * 3 floats are not all 16-byte aligned: scalar loads
    for (int j = lane; j < a1 - a0; j += kRowThreads) {
      const float g0 = __ldg(img + ty.i0 * W3 + a0 + j);
      const float g1 = __ldg(img + ty.i1 * W3 + a0 + j);
      if (kClamp) {
        dst_row[j] = __fmul_rn(g0, ty.w0);
        dst_row[stride + j] = __fmul_rn(g1, ty.w1);
      } else {
        dst_row[j] = mix(ty.w0, g0, ty.w1, g1);
      }
    }
  }
  __syncthreads();

  // ---- horizontal pass: out = normalise(wx0 * col[x0] + wx1 * col[x1]) ----
  // a thread takes kPix neighbouring pixels of one row: 3 * kPix values,
  // 16-byte stores where S is a multiple of kPix (rows then start aligned)
  const bool vec_out = S % kPix == 0;
  for (int k = threadIdx.x; k < rows * G; k += kThreads) {
    const int row = k / G;
    const int g = k - row * G;
    const float* cr = col + kBuf * row * stride;
    const int np = min(kPix, S - g * kPix);
    float v[3 * kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (i < np) {
        const ColTap t = taps[i * G + g];
        const float* c0 = cr + t.q0;
        const float* c1 = cr + t.q1;
        if (kClamp) {
          const float* d0 = c0 + stride;  // the second weighted row
          const float* d1 = c1 + stride;
          v[3 * i + 0] = normalise_clamp<0>(chain(t.w0, t.w1, c0[0], c1[0], d0[0], d1[0]));
          v[3 * i + 1] = normalise_clamp<1>(chain(t.w0, t.w1, c0[1], c1[1], d0[1], d1[1]));
          v[3 * i + 2] = normalise_clamp<2>(chain(t.w0, t.w1, c0[2], c1[2], d0[2], d1[2]));
        } else {
          // then columns
          v[3 * i + 0] = normalise<0>(mix(t.w0, c0[0], t.w1, c1[0]));
          v[3 * i + 1] = normalise<1>(mix(t.w0, c0[1], t.w1, c1[1]));
          v[3 * i + 2] = normalise<2>(mix(t.w0, c0[2], t.w1, c1[2]));
        }
      }
    }
    OutT* o = out + (static_cast<size_t>(b) * S + y_first + row) * S * 3 + g * kPix * 3;
    if (vec_out) {
#pragma unroll
      for (int i = 0; i < 3 * kPix; i += 4) {
        store4(o + i, make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3 * kPix; ++i) {
        if (i < 3 * np) o[i] = cast_out<OutT>(v[i]);
      }
    }
  }
}

template <typename OutT, bool kClamp>
int launch(const void* rgb, const void* win, void* out, int B, int H, int W,
           int S, void* stream) {
  if (B == 0 || S == 0) return 0;
  const size_t smem = sizeof(float) * (kBand * buffers_per_row<kClamp>() * row_buffer_floats(W)) +
                      sizeof(ColTap) * ((S + kPix - 1) / kPix) * kPix;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(crop_resize_normalize_kernel<OutT, kClamp>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBand - 1) / kBand, B);
  crop_resize_normalize_kernel<OutT, kClamp><<<grid, kThreads, smem,
                                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(win),
      static_cast<OutT*>(out), H, W, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points. rgb (B, H, W, 3) f32 contiguous, 16-byte aligned;
// win (B, 3) f32 rows (rmin, cmin, 1/ratio), for the clamping mode (rmin,
// cmin, ratio); out (B, S, S, 3) contiguous, 16-byte aligned. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
extern "C" int crop_resize_normalize_f32(const void* rgb, const void* win,
                                         void* out, int B, int H, int W, int S,
                                         void* stream) {
  return launch<float, false>(rgb, win, out, B, H, W, S, stream);
}

extern "C" int crop_resize_normalize_bf16(const void* rgb, const void* win,
                                          void* out, int B, int H, int W, int S,
                                          void* stream) {
  return launch<__nv_bfloat16, false>(rgb, win, out, B, H, W, S, stream);
}

extern "C" int crop_resize_normalize_clamp_f32(const void* rgb, const void* win,
                                               void* out, int B, int H, int W, int S,
                                               void* stream) {
  return launch<float, true>(rgb, win, out, B, H, W, S, stream);
}

extern "C" int crop_resize_normalize_clamp_bf16(const void* rgb, const void* win,
                                                void* out, int B, int H, int W, int S,
                                                void* stream) {
  return launch<__nv_bfloat16, true>(rgb, win, out, B, H, W, S, stream);
}
