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
//
// Bound on this card: bytes. At the main path's shapes (one 480x640x3 f32
// frame, 8 boxes -> 8x256x256x3 f32) it writes 6.3 MB and reads at most the
// 3.7 MB frame once (the taps hit L2 after the first touch): ~3 us at
// 3.35 TB/s. Design: one thread per output pixel computing all C channels, so
// a warp writes 32 neighbouring pixels (coalesced 12-byte runs) and reads a
// compact patch of the frame; a 3D grid (columns, rows, boxes) keeps 64-bit
// integer division out of the index math (a first version that decoded a flat
// index with it was several times slower on an H100).

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ float sanitize_clip(float c, float hi) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX; then jnp.clip(., 0, hi)
  if (isnan(c)) c = 0.f;
  else if (isinf(c)) c = c > 0.f ? FLT_MAX : -FLT_MAX;
  return fminf(fmaxf(c, 0.f), hi);
}

__global__ void roi_crop_kernel(const float* __restrict__ img,
                                const float* __restrict__ boxes,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out,
                                int B, int O, int H, int W, int C,
                                int oh, int ow) {
  // grid: x over output columns, y over output rows, z over (b, o) boxes —
  // no integer division in the index math
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ow) return;
  const int i = blockIdx.y;
  const int bo = blockIdx.z;
  const int o = bo % O, b = bo / O;
  float* dst = out + (((long long)bo * oh + i) * ow + j) * C;
  if (!mask[bo]) {
    for (int c = 0; c < C; ++c) dst[c] = 0.f;
    return;
  }
  const float* bx = boxes + (long long)bo * 4;
  const float x1 = bx[0], y1 = bx[1], x2 = bx[2], y2 = bx[3];
  const float xs = x1 + ((float)j + 0.5f) * (x2 - x1) / (float)ow;
  const float ys = y1 + ((float)i + 0.5f) * (y2 - y1) / (float)oh;

  const float cx = sanitize_clip(xs, (float)(W - 1));
  const float cy = sanitize_clip(ys, (float)(H - 1));
  const float fx0 = floorf(cx), fy0 = floorf(cy);
  const int x0 = (int)fx0, y0 = (int)fy0;
  const float wx0 = fmaxf(0.f, 1.f - fabsf(cx - fx0));
  const float wy0 = fmaxf(0.f, 1.f - fabsf(cy - fy0));
  const bool hx1 = x0 + 1 <= W - 1, hy1 = y0 + 1 <= H - 1;
  const float wx1 = hx1 ? fmaxf(0.f, 1.f - fabsf(cx - (fx0 + 1.f))) : 0.f;
  const float wy1 = hy1 ? fmaxf(0.f, 1.f - fabsf(cy - (fy0 + 1.f))) : 0.f;
  const int x1i = hx1 ? x0 + 1 : x0, y1i = hy1 ? y0 + 1 : y0;

  const float* base = img + (long long)b * H * W * C;
  const float* p00 = base + ((long long)y0 * W + x0) * C;
  const float* p01 = base + ((long long)y0 * W + x1i) * C;
  const float* p10 = base + ((long long)y1i * W + x0) * C;
  const float* p11 = base + ((long long)y1i * W + x1i) * C;
  for (int c = 0; c < C; ++c) {
    const float r0 = wy0 * p00[c] + wy1 * p10[c];  // row blend at column x0
    const float r1 = wy0 * p01[c] + wy1 * p11[c];  // row blend at column x1
    dst[c] = wx0 * r0 + wx1 * r1;
  }
}

}  // namespace

extern "C" int suo_roi_crop(const void* img, const void* boxes,
                            const void* mask, void* out, int B, int O, int H,
                            int W, int C, int oh, int ow, void* stream) {
  const int threads = 256;
  const dim3 grid((ow + threads - 1) / threads, oh, B * O);
  if (B * O > 0 && oh > 0 && ow > 0) {
    roi_crop_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)boxes, (const uint8_t*)mask,
        (float*)out, B, O, H, W, C, oh, ow);
  }
  return (int)cudaGetLastError();
}
