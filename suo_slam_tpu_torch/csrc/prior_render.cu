// K5 — prior-keypoint render: per (crop, keypoint) one isotropic Gaussian of
// peak 1 at the keypoint's clipped NDC location, written as NHWC heatmaps
// [N, H, W, K] for the network's prior input.
//
// Replaces `suo_slam_tpu/ops/heatmap.py` `render_prior_heatmaps` (`:166-201`),
// which on the TPU is one fused XLA elementwise pass over [N, H, W, K]. Here
// one block owns one output row (n, h): its first K threads stage the crop's
// keypoints once per (crop, keypoint) in shared memory — `finite`,
// `clip(nan_to_num(uv), -1, 1)` and the validity mask — then the block writes
// the row's W x K values, contiguous, one thread per output element:
//   du = (u_w - uc_k) / su,  dv = (v_h - vc_k) / sv,
//   out = valid_k ? exp(-0.5 (du^2 + dv^2)) : 0
// with the NDC pixel-centre grid of `ndc_grid` (v points up). The output is
// contiguous NHWC, so the post_stem projection (`_nhwc_to_cl`) and the
// concat `cat` read it without a copy.
//
// Bound on this card: bytes. At the main path's shapes (post_stem, N = 8
// crops, 64 x 64 x 41) it writes 8 * 64 * 64 * 41 * 4 B = 5.4 MB, ~1.6 us at
// 3.35 TB/s; it reads ~4 KB. Design: one 256-thread block per output row
// (512 blocks), coalesced stores, one expf per element (compiled without
// fast math, as PyTorch's exp).

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_to_num_clip(float a) {
  float x = isnan(a) ? 0.f : (isinf(a) ? (a > 0.f ? FLT_MAX : -FLT_MAX) : a);
  return fminf(fmaxf(x, -1.f), 1.f);
}

__global__ void __launch_bounds__(kThreads)
prior_render_kernel(const float* __restrict__ uv, const uint8_t* __restrict__ mask,
                    int H, int W, int K, float su, float sv,
                    float* __restrict__ out) {
  extern __shared__ float sm[];
  float* uc = sm;          // [K] clipped u
  float* vc = uc + K;      // [K] clipped v
  float* ok = vc + K;      // [K] 1 = valid and finite
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float a = uv[((long long)n * K + k) * 2 + 0];
    const float b = uv[((long long)n * K + k) * 2 + 1];
    const bool finite = isfinite(a) && isfinite(b);
    uc[k] = nan_to_num_clip(a);
    vc[k] = nan_to_num_clip(b);
    ok[k] = (mask[(long long)n * K + k] && finite) ? 1.f : 0.f;
  }
  __syncthreads();
  const float v = 1.f - ((float)h + 0.5f) / (0.5f * (float)H);
  float* row = out + ((long long)n * H + h) * (long long)W * K;
  const int P = W * K;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const int w = e / K, k = e - w * K;
    const float u = ((float)w + 0.5f) / (0.5f * (float)W) - 1.f;
    const float du = (u - uc[k]) / su;
    const float dv = (v - vc[k]) / sv;
    const float g = expf(-0.5f * (du * du + dv * dv));
    row[e] = ok[k] != 0.f ? g : 0.f;
  }
}

}  // namespace

extern "C" int suo_prior_render(const void* uv, const void* mask, int N, int H,
                                int W, int K, float su, float sv, void* out,
                                void* stream) {
  if (N > 0 && H > 0 && W > 0 && K > 0) {
    const size_t shmem = (size_t)3 * K * sizeof(float);
    prior_render_kernel<<<dim3(H, N), kThreads, shmem, (cudaStream_t)stream>>>(
        (const float*)uv, (const uint8_t*)mask, H, W, K, su, sv, (float*)out);
  }
  return (int)cudaGetLastError();
}
