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
// and writes ~90 KB, ~0.1 us of bytes and ~4 MFLOP, at ~86 launches per
// view in the eager LM schedule (H/g and the trial-step chi2 of 40
// iterations, plus 6 reclassifications), so launch latency sets its cost.
// Design: one 128-thread block per (v, o), 128 blocks, no atomics, no
// second pass. The per-edge math lives in `ba_common.cuh`, shared with K7
// and K14.
//
// Off the main path since K14 (`ba_lm.cu`) runs the whole LM schedule in
// one launch; `solvers/ba.py` `_optimize_eager` still drives it, and
// chip_smoke holds it to its plain version.

#include "ba_common.cuh"

namespace {

using namespace suo_ba;

constexpr int kThreads = 128;

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

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long e = (long long)vo * K + k;
    const Edge ed = project_edge(Tc, To, model_kp + ((long long)o * K + k) * 3, ck,
                                 uv + e * 2, info + e * 4);
    chi2_out[e] = ed.chi2;
    z_out[e] = ed.pz;
    if (!want_hg) continue;

    const float w_h = use_huber ? huber_weight(ed.chi2, huber_d, huber_d * huber_d) : 1.f;
    const float w = (inl[e] ? 1.f : 0.f) * w_h;
    float r0[12], r1[12];
    edge_jacobian(Tc, ck, ed, r0, r1);
    const float w00 = info[e * 4 + 0], w01 = info[e * 4 + 1], w11 = info[e * 4 + 3];
    const float v00 = w00 * w, v01 = w01 * w, v11 = w11 * w;
    for (int a = 0; a < 12; ++a) {
      J0[k * 12 + a] = r0[a];
      J1[k * 12 + a] = r1[a];
      W0[k * 12 + a] = r0[a] * v00 + r1[a] * v01;
      W1[k * 12 + a] = r0[a] * v01 + r1[a] * v11;
    }
    RU[k] = ed.ru;
    RV[k] = ed.rv;
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
