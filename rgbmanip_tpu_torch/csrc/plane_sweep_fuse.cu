// The fused bilinear plane-sweep warp (K2) for NVIDIA Hopper (sm_90a), bound
// to PyTorch through ctypes (rgbmanip_tpu_torch/ops/plane_sweep.py).
//
// Replaces no Pallas kernel: the JAX package builds the warp from XLA
// gathers (rgbmanip_tpu/models/pose_estimator/nets/stereo.py::_sample, the
// "flat gathers with per-batch offsets" of its README). It was added
// because the estimator at its published resolution (volume_scale 1, 224 px,
// 24 depths, 32 channels) spends the eager warp's tens of milliseconds
// writing and re-reading (B, D, H, W, C) temporaries: four gathers, their
// weighted sum, the mask and the fusing add.
//
// What one launch computes, for every (b, d, y, x) of the reference view and
// each channel c, from the source features src (B, H, W, C), the reference
// features ref (B, H, W, C), the rotated pixel rays rays (B, 3, H * W) (the
// relative rotation times (x, y, 1)), the relative translation trans (B, 3)
// and the depth hypotheses depth (B, D):
//   p = rays * depth[d] + trans, px = p.x / (p.z + 1e-9), py = p.y / (...),
//   inside = 0 <= px <= W - 1, 0 <= py <= H - 1, p.z > 1e-6,
//   the 4 taps at floor(px), floor(py) (clamped into the map) and +1,
//   out[b, c, d, y, x] = ref[b, y, x, c] + inside * sum of the weighted taps,
// stored channels-last: memory (B, D, H, W, C), each point's C channels one
// contiguous row. That is the (B, C, D, H, W) volume in the channels-last-3d
// layout the 3-D U-Net runs in on the card (cuDNN's NDHWC engines).
//
// Rounding: op for op that of the eager path (stereo.py's _project, _sample
// and the fusing add), so that the output equals it bit for bit. Each f32
// step is a separate _rn intrinsic, which nvcc never contracts into a fused
// multiply-add; the tap weights are rounded to the features' dtype, as the
// eager path keeps them. In bf16 each product and sum is one instruction
// with an explicit .rn (PTX mul/add.rn.bf16x2, never contracted): the
// product of two bf16 values is exact in f32, and the f32 sum of two bf16
// values rounded to bf16 is the sum rounded once to bf16, so the single
// rounding equals PyTorch's f32 operation followed by the cast. A point
// outside the image keeps its taps, products and sums (clamped taps), and
// is then multiplied by 0, as the eager path does, so that a NaN or the
// sign of a zero comes out the same.
//
// Bound: bytes. At the published shape in bf16 the output is 1.23 GB a
// launch against 3.2 MB of features a sample; a point does 9 operations a
// channel pair. The least traffic is the output written once plus both
// feature maps read once (portbench/counts/k2.py).
//
// Design. A group of G lanes per point (b, d, y, x), neighbouring groups on
// neighbouring x: each lane of the group computes the point's projection,
// taps and weights (the same few operations, so that no lane waits on
// another), then takes every G-th 16-byte vector of the row (8 bf16 or 4
// f32 channels), with G the largest of 8, 4, 2, 1 that divides the row's
// vector count. A group reads each tap's row and the reference's as whole
// contiguous rows through the read-only path (a sample's maps, 3.2 MB each
// in bf16, stay in L1 and L2 while the threads of its depths run), and the
// warp's 32 / G points are 32 / G consecutive rows of the output, so that
// where G is the vector count (the published 32 channels) each streaming
// store of the warp writes 512 contiguous bytes: every 32-byte sector whole
// at once, and the output stream does not push the features out of L2. A
// row that is no whole number of 16-byte vectors, or maps at an address that
// is no multiple of 16, go channel by channel through the same arithmetic
// (plane_sweep_fuse_rows_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clamp_index(float f, int n) {
  // the eager path's .long() then .clamp(0, n - 1)
  const long long v = static_cast<long long>(f);
  return static_cast<int>(v < 0 ? 0 : (v > n - 1 ? n - 1 : v));
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t splat_bf16(float v) {
  // v already a bf16 value: its bits twice
  const uint32_t h = __float_as_uint(v) >> 16;
  return h | (h << 16);
}

// The point's tap weights (1 - wy)(1 - wx), (1 - wy) wx, wy (1 - wx), wy wx
// and the mask, in the element type's own form.
template <typename T>
struct Weights;

template <>
struct Weights<float> {
  float w00, w01, w10, w11, ins;
  __device__ Weights(float fx, float fy, bool inside) {
    const float wx = fx, wy = fy;
    const float ox = __fsub_rn(1.0f, wx), oy = __fsub_rn(1.0f, wy);
    w00 = __fmul_rn(oy, ox);
    w01 = __fmul_rn(oy, wx);
    w10 = __fmul_rn(wy, ox);
    w11 = __fmul_rn(wy, wx);
    ins = inside ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ float one(float g00, float g01, float g10, float g11,
                                       float r) const {
    float acc = __fmul_rn(g00, w00);
    acc = __fadd_rn(acc, __fmul_rn(g01, w01));
    acc = __fadd_rn(acc, __fmul_rn(g10, w10));
    acc = __fadd_rn(acc, __fmul_rn(g11, w11));
    return __fadd_rn(r, __fmul_rn(acc, ins));
  }
  // one 16-byte vector: 4 channels
  __device__ __forceinline__ uint4 vec(uint4 a, uint4 b, uint4 c, uint4 d, uint4 r) const {
    uint4 o;
    o.x = __float_as_uint(one(__uint_as_float(a.x), __uint_as_float(b.x),
                              __uint_as_float(c.x), __uint_as_float(d.x), __uint_as_float(r.x)));
    o.y = __float_as_uint(one(__uint_as_float(a.y), __uint_as_float(b.y),
                              __uint_as_float(c.y), __uint_as_float(d.y), __uint_as_float(r.y)));
    o.z = __float_as_uint(one(__uint_as_float(a.z), __uint_as_float(b.z),
                              __uint_as_float(c.z), __uint_as_float(d.z), __uint_as_float(r.z)));
    o.w = __float_as_uint(one(__uint_as_float(a.w), __uint_as_float(b.w),
                              __uint_as_float(c.w), __uint_as_float(d.w), __uint_as_float(r.w)));
    return o;
  }
  // one channel
  __device__ __forceinline__ float scalar(float a, float b, float c, float d, float r) const {
    return one(a, b, c, d, r);
  }
  using Raw = float;
  static constexpr int kPerVec = 4;
};

template <>
struct Weights<__nv_bfloat16> {
  uint32_t w00, w01, w10, w11, ins;   // each a bf16 pair, the same value twice
  __device__ Weights(float fx, float fy, bool inside) {
    // (px - floor(px)).to(bf16), then each weight an f32 operation rounded
    // to bf16, as the eager path's bf16 tensors compute them
    const float wx = round_bf16(fx), wy = round_bf16(fy);
    const float ox = round_bf16(__fsub_rn(1.0f, wx)), oy = round_bf16(__fsub_rn(1.0f, wy));
    w00 = splat_bf16(round_bf16(__fmul_rn(oy, ox)));
    w01 = splat_bf16(round_bf16(__fmul_rn(oy, wx)));
    w10 = splat_bf16(round_bf16(__fmul_rn(wy, ox)));
    w11 = splat_bf16(round_bf16(__fmul_rn(wy, wx)));
    ins = splat_bf16(inside ? 1.0f : 0.0f);
  }
  // a pair of channels
  __device__ __forceinline__ uint32_t two(uint32_t g00, uint32_t g01, uint32_t g10,
                                          uint32_t g11, uint32_t r) const {
    uint32_t acc = mul_bf16x2(g00, w00);
    acc = add_bf16x2(acc, mul_bf16x2(g01, w01));
    acc = add_bf16x2(acc, mul_bf16x2(g10, w10));
    acc = add_bf16x2(acc, mul_bf16x2(g11, w11));
    return add_bf16x2(r, mul_bf16x2(acc, ins));
  }
  // one 16-byte vector: 8 channels
  __device__ __forceinline__ uint4 vec(uint4 a, uint4 b, uint4 c, uint4 d, uint4 r) const {
    return make_uint4(two(a.x, b.x, c.x, d.x, r.x), two(a.y, b.y, c.y, d.y, r.y),
                      two(a.z, b.z, c.z, d.z, r.z), two(a.w, b.w, c.w, d.w, r.w));
  }
  // one channel: the low half of a pair whose high half is 0
  __device__ __forceinline__ unsigned short scalar(unsigned short a, unsigned short b,
                                                   unsigned short c, unsigned short d,
                                                   unsigned short r) const {
    return static_cast<unsigned short>(two(a, b, c, d, r) & 0xFFFFu);
  }
  using Raw = unsigned short;   // a bf16 value's bits
  static constexpr int kPerVec = 8;
};

// One point (b, d, y, x): its 4 taps' pixels, the fractions of its source
// position and whether it lands inside the source image.
struct Point {
  int t00, t01, t10, t11;
  float fx, fy;
  bool inside;
};

__device__ __forceinline__ Point project(const float* __restrict__ rays,
                                         const float* __restrict__ trans,
                                         const float* __restrict__ depth, int b, int d, int m,
                                         int H, int W, int D) {
  // the projection, as _project: each product and sum rounded, the
  // division correctly rounded
  const int M = H * W;
  const float* r = rays + static_cast<long long>(b) * 3 * M + m;
  const float dv = __ldg(depth + b * D + d);
  const float X = __fadd_rn(__fmul_rn(__ldg(r), dv), __ldg(trans + 3 * b));
  const float Y = __fadd_rn(__fmul_rn(__ldg(r + M), dv), __ldg(trans + 3 * b + 1));
  const float Z = __fadd_rn(__fmul_rn(__ldg(r + 2 * M), dv), __ldg(trans + 3 * b + 2));
  const float den = __fadd_rn(Z, static_cast<float>(1e-9));
  const float px = __fdiv_rn(X, den);
  const float py = __fdiv_rn(Y, den);
  Point p;
  p.inside = px >= 0.0f && px <= static_cast<float>(W - 1) && py >= 0.0f &&
             py <= static_cast<float>(H - 1) && Z > static_cast<float>(1e-6);
  // _sample's bilinear taps
  const float x0f = floorf(px), y0f = floorf(py);
  const int x0 = clamp_index(x0f, W), y0 = clamp_index(y0f, H);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  p.t00 = y0 * W + x0;
  p.t01 = y0 * W + x1;
  p.t10 = y1 * W + x0;
  p.t11 = y1 * W + x1;
  p.fx = __fsub_rn(px, x0f);
  p.fy = __fsub_rn(py, y0f);
  return p;
}

// Rows of whole 16-byte vectors: kVecs of them, or `vecs` where kVecs is 0,
// kGroup lanes a point.
template <typename T, int kVecs, int kGroup>
__global__ void __launch_bounds__(256)
plane_sweep_fuse_kernel(const uint4* __restrict__ src, const uint4* __restrict__ ref,
                        const float* __restrict__ rays, const float* __restrict__ trans,
                        const float* __restrict__ depth, uint4* __restrict__ out, int B,
                        int H, int W, int D, int vecs) {
  const int M = H * W;
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long t = lane / kGroup;                   // the point
  if (t >= static_cast<long long>(B) * D * M) return;
  const int g = static_cast<int>(lane % kGroup);       // the lane's place in its group
  const int i = static_cast<int>(t);
  const int m = i % M;
  const int bd = i / M;
  const int d = bd % D;
  const int b = bd / D;
  const int nv = kVecs > 0 ? kVecs : vecs;

  const Point p = project(rays, trans, depth, b, d, m, H, W, D);
  const Weights<T> w(p.fx, p.fy, p.inside);
  const uint4* s = src + static_cast<long long>(b) * M * nv;
  const uint4* g00 = s + p.t00 * nv;
  const uint4* g01 = s + p.t01 * nv;
  const uint4* g10 = s + p.t10 * nv;
  const uint4* g11 = s + p.t11 * nv;
  const uint4* q = ref + (static_cast<long long>(b) * M + m) * nv;
  uint4* o = out + t * nv;                    // the point's row of out (B, D, H, W, C)
#pragma unroll
  for (int v = g; v < nv; v += kGroup) {
    __stcs(o + v, w.vec(__ldg(g00 + v), __ldg(g01 + v), __ldg(g10 + v), __ldg(g11 + v),
                        __ldg(q + v)));
  }
}

// Any row: channel by channel, the same arithmetic.
template <typename T>
__global__ void __launch_bounds__(256)
plane_sweep_fuse_rows_kernel(const typename Weights<T>::Raw* __restrict__ src,
                             const typename Weights<T>::Raw* __restrict__ ref,
                             const float* __restrict__ rays, const float* __restrict__ trans,
                             const float* __restrict__ depth,
                             typename Weights<T>::Raw* __restrict__ out, int B, int H, int W,
                             int C, int D) {
  const int M = H * W;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * D * M) return;
  const int i = static_cast<int>(t);
  const int m = i % M;
  const int bd = i / M;
  const int d = bd % D;
  const int b = bd / D;

  const Point p = project(rays, trans, depth, b, d, m, H, W, D);
  const Weights<T> w(p.fx, p.fy, p.inside);
  const long long s = static_cast<long long>(b) * M * C;
  const long long q = (static_cast<long long>(b) * M + m) * C;
  typename Weights<T>::Raw* o = out + t * C;  // the point's row of out (B, D, H, W, C)
  for (int c = 0; c < C; ++c) {
    __stcs(o + c,
           w.scalar(__ldg(src + s + p.t00 * C + c), __ldg(src + s + p.t01 * C + c),
                    __ldg(src + s + p.t10 * C + c), __ldg(src + s + p.t11 * C + c),
                    __ldg(ref + q + c)));
  }
}

template <typename T>
int launch(const void* src, const void* ref, const void* rays, const void* trans,
           const void* depth, void* out, int B, int H, int W, int C, int D, void* stream) {
  const long long n = static_cast<long long>(B) * D * H * W;
  if (n == 0 || C == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ra = static_cast<const float*>(rays);
  const float* tr = static_cast<const float*>(trans);
  const float* de = static_cast<const float*>(depth);
  constexpr int per = Weights<T>::kPerVec;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(ref)) & 15u) == 0;
  if (C % per != 0 || !aligned) {
    using Raw = typename Weights<T>::Raw;
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    plane_sweep_fuse_rows_kernel<T><<<blocks, 256, 0, st>>>(
        static_cast<const Raw*>(src), static_cast<const Raw*>(ref), ra, tr, de,
        static_cast<Raw*>(out), B, H, W, C, D);
    return static_cast<int>(cudaGetLastError());
  }
  const uint4* s = static_cast<const uint4*>(src);
  const uint4* r = static_cast<const uint4*>(ref);
  uint4* o = static_cast<uint4*>(out);
  const int vecs = C / per;
  const int group = vecs % 8 == 0 ? 8 : vecs % 4 == 0 ? 4 : vecs % 2 == 0 ? 2 : 1;
  const unsigned blocks = static_cast<unsigned>((n * group + 255) / 256);
#define K2_LAUNCH(V, G)                                                                   \
  plane_sweep_fuse_kernel<T, V, G><<<blocks, 256, 0, st>>>(s, r, ra, tr, de, o, B, H, W, D, \
                                                           vecs)
  if (vecs == 1) K2_LAUNCH(1, 1);
  else if (vecs == 2) K2_LAUNCH(2, 2);
  else if (vecs == 4) K2_LAUNCH(4, 4);
  else if (vecs == 8) K2_LAUNCH(8, 8);
  else if (group == 8) K2_LAUNCH(0, 8);
  else if (group == 4) K2_LAUNCH(0, 4);
  else if (group == 2) K2_LAUNCH(0, 2);
  else K2_LAUNCH(0, 1);
#undef K2_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points. src, ref (B, H, W, C) and out (B, D, H, W, C) in the
// entry point's dtype, rays (B, 3, H * W), trans (B, 3) and depth (B, D) in
// f32, all contiguous, any C; B * D * H * W < 2^31. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int plane_sweep_fuse_f32(const void* src, const void* ref, const void* rays,
                                    const void* trans, const void* depth, void* out, int B,
                                    int H, int W, int C, int D, void* stream) {
  return launch<float>(src, ref, rays, trans, depth, out, B, H, W, C, D, stream);
}

extern "C" int plane_sweep_fuse_bf16(const void* src, const void* ref, const void* rays,
                                     const void* trans, const void* depth, void* out, int B,
                                     int H, int W, int C, int D, void* stream) {
  return launch<__nv_bfloat16>(src, ref, rays, trans, depth, out, B, H, W, C, D, stream);
}
