// K6 — masked chi2 inlier counts: project every model keypoint under a batch
// of object-to-camera poses, test its covariance-weighted chi2 against the
// threshold, and count the passing edges.
//
// Replaces `suo_slam_tpu/slam/kernels.py` `_chi2_counts` (`:116-134`) as
// `camera_pose_ransac` (`:137`) calls it — H = O camera hypotheses scored
// against one frame's [O, K] detections — and the per-object counts of
// `reinit_counts` (`:177`) over the last N views. On the TPU these are
// [H, O, K] / [N, O, K] fused elementwise programs ending in a reduction;
// here one block owns one count:
//   per_object = 0: count[s]    = sum over (o, k) of set s       (RANSAC)
//   per_object = 1: count[g, o] = sum over (m, k) of sets g*M+m   (re-init)
// Set s reads its measurements (uv, info, mask, cam_k4) from row s % M, so
// camera RANSAC passes M = 1 and re-init passes its PnP and estimated poses
// as 2N sets over the same N view rows in one launch.
//
// Per edge, in the plain version's operation order (compiled with
// --fmad=false, so each product and sum rounds as PyTorch's separate
// elementwise kernels round them; the counts must be equal, since one edge
// that flips at the threshold can change the chosen camera):
//   p = R x + t (three products and three sums per row, left to right),
//   iz = 1 / (|z| < 1e-12 ? 1e-12 : z),
//   r = uv - (f p iz + c),  chi2 = ru (i00 ru + i01 rv) + rv (i10 ru + i11 rv),
//   good = chi2 <= thresh && z > 0 && mask   (a NaN chi2 never counts).
//
// Bound on this card: latency. At the SLAM path's shapes (O = 8, K = 41;
// 8 hypotheses, or 2 x 15 views) one launch reads < 0.2 MB and does
// ~10k edges x ~40 f32 operations = 0.4 MFLOP: ~0.05 us of bytes, far below
// one launch. Design: one 128-thread block per count, a fixed-order
// warp-shuffle + shared-memory integer reduction, no atomics.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int edge_good(const float* __restrict__ T,
                                         const float* __restrict__ model_kp,
                                         const float* __restrict__ uv,
                                         const float* __restrict__ info,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ cam_k4,
                                         int s, int o, int k, int O, int K, int M,
                                         float thresh) {
  const float* Ts = T + ((long long)s * O + o) * 16;
  const float* x = model_kp + ((long long)o * K + k) * 3;
  const long long e = ((long long)(s % M) * O + o) * K + k;
  if (!mask[e]) return 0;
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = x[0] * Ts[i * 4 + 0] + x[1] * Ts[i * 4 + 1] + x[2] * Ts[i * 4 + 2] + Ts[i * 4 + 3];
  const float z = p[2];
  const float iz = 1.f / (fabsf(z) < 1e-12f ? 1e-12f : z);
  const float* ck = cam_k4 + ((long long)(s % M) * O + o) * 4;
  const float u = ck[0] * p[0] * iz + ck[2];
  const float v = ck[1] * p[1] * iz + ck[3];
  const float ru = uv[e * 2 + 0] - u;
  const float rv = uv[e * 2 + 1] - v;
  const float* W = info + e * 4;
  const float chi2 = ru * (W[0] * ru + W[1] * rv) + rv * (W[2] * ru + W[3] * rv);
  return (chi2 <= thresh && z > 0.f) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
chi2_counts_kernel(const float* __restrict__ T, const float* __restrict__ model_kp,
                   const float* __restrict__ uv, const float* __restrict__ info,
                   const uint8_t* __restrict__ mask, const float* __restrict__ cam_k4,
                   int S, int O, int K, int M, int per_object, float thresh,
                   int* __restrict__ counts) {
  __shared__ int red[kWarps];
  int c = 0;
  if (!per_object) {
    const int s = blockIdx.x;
    for (int e = threadIdx.x; e < O * K; e += blockDim.x)
      c += edge_good(T, model_kp, uv, info, mask, cam_k4, s, e / K, e % K, O, K, M, thresh);
  } else {
    const int g = blockIdx.x / O, o = blockIdx.x % O;
    for (int e = threadIdx.x; e < M * K; e += blockDim.x)
      c += edge_good(T, model_kp, uv, info, mask, cam_k4, g * M + e / K, o, e % K, O, K,
                     M, thresh);
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    counts[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int suo_chi2_counts(const void* T, const void* model_kp, const void* uv,
                               const void* info, const void* mask, const void* cam_k4,
                               int S, int O, int K, int M, int per_object, float thresh,
                               void* counts, void* stream) {
  const int blocks = per_object ? (S / M) * O : S;
  if (blocks > 0) {
    chi2_counts_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)T, (const float*)model_kp, (const float*)uv, (const float*)info,
        (const uint8_t*)mask, (const float*)cam_k4, S, O, K, M, per_object, thresh,
        (int*)counts);
  }
  return (int)cudaGetLastError();
}
