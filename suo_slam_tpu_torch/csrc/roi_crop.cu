// K1 — batched ROI crop-and-resize (bilinear, one tap at each bin centre).
//
// Replaces `suo_slam_tpu/ops/roi.py` `roi_crop_batch` / `roi_crop` /
// `_hat_weights`. On the TPU that function is two dense hat-weight matmuls
// per box (the MXU form of a separable bilinear resample). On Hopper the
// same function is a gather: every output pixel reads 2x2 source pixels.
//
// Semantics kept exactly (`roi.py:53-55,69-70`):
//   x_j = x1 + (j + 0.5) * (x2 - x1) / ow      in f32, in that order
//   c   = clip(nan_to_num(x_j), 0, W - 1)      replicate border, clamp BEFORE floor
//   w0  = max(0, 1 - |c - x0|), w1 = max(0, 1 - |c - (x0 + 1)|), x0 = floor(c)
//   out = wx0 * (wy0 I[y0,x0] + wy1 I[y1,x0]) + wx1 * (wy0 I[y0,x1] + wy1 I[y1,x1])
// (the matmul form's rows-then-columns order); masked slots are written 0.
// Every path below computes each output element by this one function
// (`pixel`), so the paths agree to the bit.
//
// Bound on this card: bytes. At the main path's shapes (one 480x640x3 f32
// frame, 8 boxes -> 8x256x256x3 f32) it writes 6.3 MB and reads at most the
// 3.7 MB frame once (the taps hit L2 after the first touch): ~2.5 us at
// 3.35 TB/s. The plan (`ops/roi.py` `plan_crop`, whose path the wrapper
// passes in) picks one of two paths:
//   - generic (any C, any ow, any alignment): one thread per output pixel,
//     all C channels, a 3D grid (columns, rows, boxes) that keeps integer
//     division out of the index math; each of its 3 scalar stores per pixel
//     lands at a 12-byte stride;
//   - strip (C = 3, ow % 4 == 0, 16-byte aligned output and boxes; the main
//     path): a block per 128-pixel strip of 8 rows, a warp per row. The
//     strip's x-taps are computed once per block into shared memory and the
//     row's y-taps once per warp, before the block's barrier; a lane per
//     pixel for the gathers (4 pixels 32 apart, so a warp's loads read one
//     compact patch of the frame); the row's 384 floats are staged in shared
//     memory and each lane writes 12 of them as three aligned 16-byte
//     streaming stores, 512 contiguous bytes per warp store. A thread per 4
//     adjacent pixels writing its own 12 floats measured slower on the card:
//     its gathers span 4x the frame per load and its stores 48-byte runs.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kGenericThreads = 256;
constexpr int kStrip = 128;     // pixels per warp strip
constexpr int kStripWarps = 8;  // rows per block, one warp each

__device__ __forceinline__ float sanitize_clip(float c, float hi) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX; then jnp.clip(., 0, hi)
  if (isnan(c)) c = 0.f;
  else if (isinf(c)) c = c > 0.f ? FLT_MAX : -FLT_MAX;
  return fminf(fmaxf(c, 0.f), hi);
}

// The two taps of one axis: sample coordinate s in [0, n - 1] after the
// clamp; lo / hi the source indices, w0 / w1 their hat weights.
struct Taps {
  int lo, hi;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float s, int n) {
  const float c = sanitize_clip(s, (float)(n - 1));
  const float f0 = floorf(c);
  const int i0 = (int)f0;
  const bool has1 = i0 + 1 <= n - 1;
  Taps t;
  t.lo = i0;
  t.hi = has1 ? i0 + 1 : i0;
  t.w0 = fmaxf(0.f, 1.f - fabsf(c - f0));
  t.w1 = has1 ? fmaxf(0.f, 1.f - fabsf(c - (f0 + 1.f))) : 0.f;
  return t;
}

// x_j (or y_i) of an output bin, in the plain version's order
__device__ __forceinline__ float bin_centre(float a, float b, int j, int n) {
  return a + ((float)j + 0.5f) * (b - a) / (float)n;
}

// One output pixel's C channels: the row blend at both columns, then the
// column blend.
template <int C>
__device__ __forceinline__ void pixel(const float* __restrict__ base, int W, const Taps& ty,
                                      const Taps& tx, float* v) {
  const float* p00 = base + ((long long)ty.lo * W + tx.lo) * C;
  const float* p01 = base + ((long long)ty.lo * W + tx.hi) * C;
  const float* p10 = base + ((long long)ty.hi * W + tx.lo) * C;
  const float* p11 = base + ((long long)ty.hi * W + tx.hi) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r0 = ty.w0 * __ldg(p00 + c) + ty.w1 * __ldg(p10 + c);  // row blend at x0
    const float r1 = ty.w0 * __ldg(p01 + c) + ty.w1 * __ldg(p11 + c);  // row blend at x1
    v[c] = tx.w0 * r0 + tx.w1 * r1;
  }
}

__global__ void roi_crop_kernel(const float* __restrict__ img,
                                const float* __restrict__ boxes,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out,
                                int O, int H, int W, int C, int oh, int ow) {
  // grid: x over output columns, y over output rows, z over (b, o) boxes
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ow) return;
  const int i = blockIdx.y;
  const int bo = blockIdx.z;
  const int b = bo / O;
  float* dst = out + (((long long)bo * oh + i) * ow + j) * C;
  if (!mask[bo]) {
    for (int c = 0; c < C; ++c) dst[c] = 0.f;
    return;
  }
  const float* bx = boxes + (long long)bo * 4;
  const Taps ty = taps(bin_centre(bx[1], bx[3], i, oh), H);
  const Taps tx = taps(bin_centre(bx[0], bx[2], j, ow), W);
  const float* base = img + (long long)b * H * W * C;
  const float* p00 = base + ((long long)ty.lo * W + tx.lo) * C;
  const float* p01 = base + ((long long)ty.lo * W + tx.hi) * C;
  const float* p10 = base + ((long long)ty.hi * W + tx.lo) * C;
  const float* p11 = base + ((long long)ty.hi * W + tx.hi) * C;
  for (int c = 0; c < C; ++c) {
    const float r0 = ty.w0 * p00[c] + ty.w1 * p10[c];
    const float r1 = ty.w0 * p01[c] + ty.w1 * p11[c];
    dst[c] = tx.w0 * r0 + tx.w1 * r1;
  }
}

__global__ void roi_crop_kernel_strip(const float* __restrict__ img,
                                      const float* __restrict__ boxes,
                                      const uint8_t* __restrict__ mask,
                                      float* __restrict__ out,
                                      int O, int H, int W, int oh, int ow) {
  // grid: x over kStrip-pixel strips, y over kStripWarps-row chunks (a warp
  // per row), z over boxes
  __shared__ float4 stage[kStripWarps][kStrip * 3 / 4];
  __shared__ int2 s_xi[kStrip];    // the strip's x-taps, computed once per block
  __shared__ float2 s_xw[kStrip];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bo = blockIdx.z;
  const int s0 = blockIdx.x * kStrip;
  const float4 b4 = reinterpret_cast<const float4*>(boxes)[bo];  // one 16-byte load (aligned: the plan)
  const float bx[4] = {b4.x, b4.y, b4.z, b4.w};
  const bool live = mask[bo] != 0;
  const int i = blockIdx.y * kStripWarps + warp;
  Taps ty;
  if (live) ty = taps(bin_centre(bx[1], bx[3], i, oh), H);  // beside the x-taps, before the barrier
  if (live && threadIdx.x < kStrip && s0 + (int)threadIdx.x < ow) {
    const Taps tx = taps(bin_centre(bx[0], bx[2], s0 + threadIdx.x, ow), W);
    s_xi[threadIdx.x] = make_int2(tx.lo, tx.hi);
    s_xw[threadIdx.x] = make_float2(tx.w0, tx.w1);
  }
  __syncthreads();
  if (i >= oh) return;  // a whole warp: no barrier below
  const int n4 = min(kStrip, ow - s0) * 3 / 4;  // 16-byte vectors in this strip (ow % 4 == 0)
  float4* dst = reinterpret_cast<float4*>(out + (((long long)bo * oh + i) * ow + s0) * 3);
  if (!live) {
    for (int f = lane; f < n4; f += 32) __stcs(dst + f, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const float* base = img + (long long)(bo / O) * H * W * 3;
  float* st = reinterpret_cast<float*>(stage[warp]);
#pragma unroll
  for (int k = 0; k < kStrip / 32; ++k) {
    const int p = k * 32 + lane;  // a lane per pixel: neighbouring lanes, neighbouring taps
    if (s0 + p < ow) {
      const int2 xi = s_xi[p];
      const float2 xw = s_xw[p];
      Taps tx;
      tx.lo = xi.x; tx.hi = xi.y; tx.w0 = xw.x; tx.w1 = xw.y;
      float v[3];
      pixel<3>(base, W, ty, tx, v);
      st[p * 3 + 0] = v[0];  // stride 3 words: no bank conflicts
      st[p * 3 + 1] = v[1];
      st[p * 3 + 2] = v[2];
    }
  }
  __syncwarp();
  // the crop is written once and read by the next kernel: streaming stores
  for (int f = lane; f < n4; f += 32) __stcs(dst + f, stage[warp][f]);
}

}  // namespace

// path: 0 generic, 1 strip (`ops/roi.py` `plan_crop`, which checks what the
// strip takes: C = 3, ow % 4 == 0 and a 16-byte aligned output (and boxes);
// its geometry mirrors the grids below)
extern "C" int suo_roi_crop(const void* img, const void* boxes, const void* mask, void* out,
                            int B, int O, int H, int W, int C, int oh, int ow, int path,
                            void* stream) {
  const int n_box = B * O;
  if (n_box > 0 && oh > 0 && ow > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const float* fi = (const float*)img;
    const float* fb = (const float*)boxes;
    const uint8_t* mk = (const uint8_t*)mask;
    float* fo = (float*)out;
    if (path == 1) {
      const dim3 grid((ow + kStrip - 1) / kStrip, (oh + kStripWarps - 1) / kStripWarps, n_box);
      roi_crop_kernel_strip<<<grid, 32 * kStripWarps, 0, s>>>(fi, fb, mk, fo, O, H, W, oh, ow);
    } else {
      const dim3 grid((ow + kGenericThreads - 1) / kGenericThreads, oh, n_box);
      roi_crop_kernel<<<grid, kGenericThreads, 0, s>>>(fi, fb, mk, fo, O, H, W, C, oh, ow);
    }
  }
  return (int)cudaGetLastError();
}
