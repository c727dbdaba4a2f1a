// The 3-D U-Net's one-output-channel convolution (K7) for NVIDIA Hopper
// (sm_90a), bound to PyTorch through ctypes (rgbmanip_tpu_torch/ops/prob_conv.py).
//
// Replaces no Pallas kernel: the JAX package leaves CostRegNet's last layer,
// `prob` (rgbmanip_tpu/models/pose_estimator/nets/stereo.py), to XLA's
// convolution. It was added because on the card cuDNN runs this layer, a
// Conv3d(8, 1, 3, padding=1, bias=False) in bf16 over the channels-last-3d
// volume, with an FFMA implicit-GEMM engine (implicit_convolveNd_sgemm) that
// takes about 190 times the layer's byte bound: at the published network's
// volume, (B, C, D, H, W) = (16, 8, 24, 224, 224), 19.6 ms of the U-Net's
// 35.4 ms a view.
//
// What one launch computes, for every (b, d, h, w), from x (B, C=8, D, H, W)
// in bf16 with the memory (B, D, H, W, 8) (one 16-byte row of 8 channels a
// voxel, the U-Net's channels-last-3d layout) and the filter w (1, 8, 3, 3, 3)
// in f32, each weight rounded to bf16 as the layer computes in bf16:
//   out[b, 0, d, h, w] = sum over c, kd, kh, kw of
//                        x[b, c, d + kd - 1, h + kh - 1, w + kw - 1] * w[0, c, kd, kh, kw],
// zero outside the volume (padding 1), stored as (B, 1, D, H, W). Each product
// of two bf16 values is exact in f32; the 216 terms are summed in f32 and the
// sum is rounded once to bf16, the work cuDNN does, in another order: each
// thread sums 18-term chains (one depth tap, two channels, nine in-plane taps)
// that are then added across the depth taps and across the four threads of
// an output's channels, so no f32 partial sum runs over more than 18 terms.
//
// Bound: bytes. A voxel is read once (16 bytes) and an output written once
// (2 bytes): at the published shape 346.8 MB, 0.104 ms at 3.35 TB/s. The
// 216 multiply-adds an output are 8.32 GFLOP there, 0.124 ms on the CUDA
// cores' 67 TFLOP/s f32, so the FFMA pipe is the practical limit, and the
// design spends as few other instructions as it can beside each FFMA.
//
// Design. A CTA of 256 threads takes a tile of 32 rows by 16 columns of one
// sample and walks it down all D planes. Each plane of the tile with its
// one-voxel halo (34 x 18 voxels) is copied by cp.async into a ring
// of four plane buffers in shared memory, three planes ahead of the one being
// read; voxels outside the volume are zero-filled by the copy (src-size 0),
// which gives the padding in H and W, and the planes before the first and
// after the last are never read (their terms are zero). A warp covers 8
// columns by 8 rows: its lane (pos, cp) holds the column pos and the channel
// pair cp, and the 54 weights of its two channels in registers as f32. For
// each plane it reads 10 x 3 words (its channel pair of each voxel it
// needs: a warp's 32 lanes read 128 contiguous bytes, with no bank
// conflict), widens each bf16 pair with one shift and one mask, and adds
// every product into 3 x 8 chains, one a depth tap and output row. Across
// planes the depth taps roll: a plane's first tap starts the output of the
// next plane, its second adds to its own plane's, its third completes the
// previous plane's, which is then summed over the four channel-pair lanes by
// two shuffle rounds that leave each lane one row, and stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNH = 8;       // output rows a thread
constexpr int kTileH = 32;   // output rows a CTA: four warps of kNH
constexpr int kTileW = 16;   // output columns a CTA: two warps of 8
constexpr int kStages = 4;   // plane buffers in the shared-memory ring

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The four channel-pair lanes' partial sums of the thread's rows 4g .. 4g + 3,
// each lane's v[0..3], summed over the lanes; lane cp returns row 4g + cp.
__device__ __forceinline__ float lane_rows_sum(const float* v, int cp) {
  const bool hi = cp & 2;
  const float send0 = hi ? v[0] : v[2], send1 = hi ? v[1] : v[3];
  const float keep0 = hi ? v[2] : v[0], keep1 = hi ? v[3] : v[1];
  const float r0 = keep0 + __shfl_xor_sync(0xffffffffu, send0, 2);
  const float r1 = keep1 + __shfl_xor_sync(0xffffffffu, send1, 2);
  const bool odd = cp & 1;
  return (odd ? r1 : r0) + __shfl_xor_sync(0xffffffffu, odd ? r0 : r1, 1);
}

__global__ void __launch_bounds__(kThreads, 2)
    prob_conv3d_kernel(const uint4* __restrict__ x, const float* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int D, int H, int W) {
  static_assert(kNH % 4 == 0, "the lane sum hands each of 4 lanes one row of 4");
  static_assert(kTileH == 4 * kNH, "four warps down the tile");
  constexpr int kCols = kTileW + 2;
  constexpr int kVox = (kTileH + 2) * kCols;
  constexpr int kPer = (kVox + kThreads - 1) / kThreads;  // voxels a thread copies a plane
  __shared__ __align__(16) uint4 ring[kStages][kVox];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cp = lane & 3, pos = lane >> 2;
  const int col = (warp & 1) * 8 + pos;  // the thread's output column in the tile
  const int row0 = (warp >> 1) * kNH;    // its first output row in the tile
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint4* xb = x + static_cast<size_t>(b) * D * plane;

  // the thread's two channels' weights, each rounded to bf16
  float wt[2][3][3][3];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          wt[e][kd][kh][kw] = __bfloat162float(__float2bfloat16_rn(
              __ldg(w + (2 * cp + e) * 27 + kd * 9 + kh * 3 + kw)));

  // the voxels this thread copies into each plane buffer: their offset within
  // a plane of the sample, or -1 outside the volume (zero-filled)
  long long src_off[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = tid + k * kThreads;
    const int r = v / kCols, c = v - r * kCols;
    const int gh = h0 - 1 + r, gw = w0 - 1 + c;
    src_off[k] = (v < kVox && gh >= 0 && gh < H && gw >= 0 && gw < W)
                     ? static_cast<long long>(gh) * W + gw
                     : -1;
  }
  auto issue = [&](int p) {  // plane p into buffer p % kStages
    const uint4* src = xb + static_cast<size_t>(p) * plane;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(&ring[p % kStages][0]));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = tid + k * kThreads;
      if (kVox % kThreads == 0 || v < kVox)
        cp_async16(dst + v * 16, src_off[k] >= 0 ? src + src_off[k] : x, src_off[k] >= 0);
    }
  };

  // Before plane p: part_a[j] holds output p - 1's terms of planes p - 2 and
  // p - 1, part_b[j] output p's of plane p - 1.
  float part_a[kNH], part_b[kNH];
#pragma unroll
  for (int j = 0; j < kNH; ++j) part_a[j] = part_b[j] = 0.0f;

  auto store = [&](int d, const float* v) {  // output plane d of the thread's rows
#pragma unroll
    for (int g = 0; g < kNH / 4; ++g) {
      const float sum = lane_rows_sum(v + 4 * g, cp);
      const int h = h0 + row0 + 4 * g + cp, wo = w0 + col;
      if (h < H && wo < W)
        out[(static_cast<size_t>(b) * D + d) * plane + static_cast<size_t>(h) * W + wo] =
            __float2bfloat16_rn(sum);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < D) issue(s);
    cp_async_commit();
  }
  for (int p = 0; p < D; ++p) {
    cp_async_wait<kStages - 2>();  // this thread's copies of plane p have landed
    __syncthreads();               // everyone's have, and plane p - 1's buffer is free
    if (p + kStages - 1 < D) issue(p + kStages - 1);
    cp_async_commit();

    const uint32_t* s = reinterpret_cast<const uint32_t*>(ring[p % kStages]);
    float q[3][kNH];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int j = 0; j < kNH; ++j) q[kd][j] = 0.0f;
#pragma unroll
    for (int r = 0; r < kNH + 2; ++r) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const uint32_t word = s[((row0 + r) * kCols + col + kw) * 4 + cp];
        const float x0 = __uint_as_float(word << 16);           // channel 2 cp
        const float x1 = __uint_as_float(word & 0xffff0000u);   // channel 2 cp + 1
#pragma unroll
        for (int j = 0; j < kNH; ++j) {
          const int kh = r - j;
          if (kh < 0 || kh > 2) continue;
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            q[kd][j] = fmaf(x0, wt[0][kd][kh][kw], q[kd][j]);
            q[kd][j] = fmaf(x1, wt[1][kd][kh][kw], q[kd][j]);
          }
        }
      }
    }
    // depth tap 2 completes output p - 1, tap 1 adds to p, tap 0 starts p + 1
    float done[kNH];
#pragma unroll
    for (int j = 0; j < kNH; ++j) {
      done[j] = part_a[j] + q[2][j];
      part_a[j] = part_b[j] + q[1][j];
      part_b[j] = q[0][j];
    }
    if (p > 0) store(p - 1, done);
  }
  store(D - 1, part_a);  // the plane after the last adds nothing
}

}  // namespace

// Plain C entry point. x: the (B, D, H, W, 8) bf16 rows, 16-byte aligned; w:
// the 216 f32 weights of the (1, 8, 3, 3, 3) filter, contiguous; out: (B, D,
// H, W) bf16, contiguous; B < 65536. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int prob_conv3d_bf16(const void* x, const void* w, void* out, int B, int D, int H,
                                int W, void* stream) {
  if (static_cast<long long>(B) * D * H * W == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  prob_conv3d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), D, H, W);
  return static_cast<int>(cudaGetLastError());
}
