// K4 — bundle-adjustment edge assembly: per (view, object) the projection of
// its K keypoint edges, residuals, chi2, the Huber IRLS weight from that same
// chi2, the analytic 2x12 Jacobian of each edge, and the 12x12 block H and
// 12-vector g of the normal equations; or, in chi2 mode, the chi2 alone.
//
// Replaces `suo_slam_tpu/solvers/ba.py` `_edge_planes_Hg` (the LM loop's H/g
// path, with `_project_planes` / `_chi2_from_planes`) and `_edge_chi2`. On
// the TPU the Jacobian components are [V,O,K] planes contracted on the MXU
// over a 2K edge axis; here one block owns one (v, o): phase 1 puts one
// thread on each edge, which writes its two Jacobian rows, their
// info-weighted copies and its residual to shared memory; phase 2 puts one
// thread on each of the 144 + 12 outputs, which sums its products over the
// 2K edge rows in f32.
//
// Bound on this card: latency. At the main path's shapes (V = 16, O = 8,
// K = 41) one launch reads ~0.2 MB (uv, info, cam_k, poses, model points)
// and writes ~90 KB, ~0.1 us of bytes and ~4 MFLOP; it runs ~86 times per
// view in the fixed-length LM schedule (H/g and the trial-step chi2 of 40
// iterations, plus 6 reclassifications), so launch latency sets its cost.
// Design: one 128-thread block per (v, o), 128 blocks, no atomics, no
// second pass.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float clamp_iz(float z) {
  return 1.f / (fabsf(z) < 1e-12f ? 1e-12f : z);
}

__global__ void __launch_bounds__(kThreads)
ba_edges_kernel(const float* __restrict__ cam_T, const float* __restrict__ obj_T,
                const float* __restrict__ uv, const float* __restrict__ info,
                const float* __restrict__ model_kp, const float* __restrict__ cam_k,
                const uint8_t* __restrict__ inl, int use_huber, float huber_d,
                int V, int O, int K, int want_hg, float* __restrict__ H_out,
                float* __restrict__ g_out, float* __restrict__ chi2_out,
                float* __restrict__ z_out) {
  extern __shared__ float sm[];
  float* J0 = sm;              // [K, 12] u-row of each edge's Jacobian
  float* J1 = J0 + 12 * K;     // [K, 12] v-row
  float* W0 = J1 + 12 * K;     // [K, 12] info-weighted combinations
  float* W1 = W0 + 12 * K;
  float* RU = W1 + 12 * K;     // [K] residuals
  float* RV = RU + K;

  const int vo = blockIdx.x;  // v * O + o
  const int v = vo / O, o = vo % O;
  const float* Tc = cam_T + (long long)v * 16;
  const float* To = obj_T + (long long)o * 16;
  const float* ck = cam_k + (long long)vo * 4;
  const float fx = ck[0], fy = ck[1], cx = ck[2], cy = ck[3];

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long e = (long long)vo * K + k;
    const float* m = model_kp + ((long long)o * K + k) * 3;
    float pG[3], pC[3];
    for (int i = 0; i < 3; ++i)
      pG[i] = To[i * 4 + 0] * m[0] + To[i * 4 + 1] * m[1] + To[i * 4 + 2] * m[2] + To[i * 4 + 3];
    for (int i = 0; i < 3; ++i)
      pC[i] = Tc[i * 4 + 0] * pG[0] + Tc[i * 4 + 1] * pG[1] + Tc[i * 4 + 2] * pG[2] + Tc[i * 4 + 3];
    const float px = pC[0], py = pC[1], pz = pC[2];
    const float iz = clamp_iz(pz);
    const float ru = uv[e * 2 + 0] - (fx * px * iz + cx);
    const float rv = uv[e * 2 + 1] - (fy * py * iz + cy);
    const float w00 = info[e * 4 + 0], w01 = info[e * 4 + 1], w11 = info[e * 4 + 3];
    const float chi2 = w00 * ru * ru + 2.f * w01 * ru * rv + w11 * rv * rv;
    chi2_out[e] = chi2;
    z_out[e] = pz;
    if (!want_hg) continue;

    float w_h = 1.f;
    if (use_huber && !(chi2 <= huber_d * huber_d))
      w_h = huber_d / sqrtf(isnan(chi2) ? chi2 : fmaxf(chi2, 1e-30f));
    const float w = (inl[e] ? 1.f : 0.f) * w_h;

    const float A = fx * iz;
    const float B = -fx * px * iz * iz;
    const float C = fy * iz;
    const float D = -fy * py * iz * iz;
    float r0[12], r1[12];
    // camera columns: -(Jproj @ [-hat(p_C) | I])
    r0[0] = -B * py; r0[1] = B * px - A * pz; r0[2] = A * py;
    r0[3] = -A;      r0[4] = 0.f;             r0[5] = -B;
    r1[0] = C * pz - D * py; r1[1] = D * px; r1[2] = -C * px;
    r1[3] = 0.f;             r1[4] = -C;     r1[5] = -D;
    // object columns: M = Jproj @ R_cw, then -(M @ [-hat(p_G) | I])
    float M0[3], M1[3];
    for (int j = 0; j < 3; ++j) {
      M0[j] = A * Tc[0 * 4 + j] + B * Tc[2 * 4 + j];
      M1[j] = C * Tc[1 * 4 + j] + D * Tc[2 * 4 + j];
    }
    const float gx = pG[0], gy = pG[1], gz = pG[2];
    r0[6] = M0[1] * gz - M0[2] * gy;
    r0[7] = -(M0[0] * gz - M0[2] * gx);
    r0[8] = M0[0] * gy - M0[1] * gx;
    r0[9] = -M0[0]; r0[10] = -M0[1]; r0[11] = -M0[2];
    r1[6] = M1[1] * gz - M1[2] * gy;
    r1[7] = -(M1[0] * gz - M1[2] * gx);
    r1[8] = M1[0] * gy - M1[1] * gx;
    r1[9] = -M1[0]; r1[10] = -M1[1]; r1[11] = -M1[2];
    const float v00 = w00 * w, v01 = w01 * w, v11 = w11 * w;
    for (int a = 0; a < 12; ++a) {
      J0[k * 12 + a] = r0[a];
      J1[k * 12 + a] = r1[a];
      W0[k * 12 + a] = r0[a] * v00 + r1[a] * v01;
      W1[k * 12 + a] = r0[a] * v01 + r1[a] * v11;
    }
    RU[k] = ru;
    RV[k] = rv;
  }
  if (!want_hg) return;
  __syncthreads();

  for (int t = threadIdx.x; t < 156; t += blockDim.x) {
    float acc = 0.f;
    if (t < 144) {
      const int i = t / 12, j = t % 12;
      for (int k = 0; k < K; ++k) acc += W0[k * 12 + i] * J0[k * 12 + j];
      for (int k = 0; k < K; ++k) acc += W1[k * 12 + i] * J1[k * 12 + j];
      H_out[(long long)vo * 144 + t] = acc;
    } else {
      const int i = t - 144;
      for (int k = 0; k < K; ++k) acc += W0[k * 12 + i] * RU[k];
      for (int k = 0; k < K; ++k) acc += W1[k * 12 + i] * RV[k];
      g_out[(long long)vo * 12 + i] = acc;
    }
  }
}

}  // namespace

extern "C" int suo_ba_edges(const void* cam_T, const void* obj_T,
                            const void* uv, const void* info,
                            const void* model_kp, const void* cam_k,
                            const void* inl, int use_huber, float huber_d,
                            int V, int O, int K, int want_hg, void* H_out,
                            void* g_out, void* chi2_out, void* z_out,
                            void* stream) {
  if (V * O > 0) {
    const size_t shmem = want_hg ? (size_t)50 * K * sizeof(float) : 0;
    ba_edges_kernel<<<V * O, kThreads, shmem, (cudaStream_t)stream>>>(
        (const float*)cam_T, (const float*)obj_T, (const float*)uv,
        (const float*)info, (const float*)model_kp, (const float*)cam_k,
        (const uint8_t*)inl, use_huber, huber_d, V, O, K, want_hg,
        (float*)H_out, (float*)g_out, (float*)chi2_out, (float*)z_out);
  }
  return (int)cudaGetLastError();
}
