// K15 — the whole of PnP RANSAC for a batch of objects in one launch: the
// centroid / scale preconditioning, every hypothesis (P3P + the 4th point +
// the inlier count), the argmax, two rounds of 8 damped Gauss-Newton
// iterations with inlier reselection, the keep-only-if-no-inliers-lost gate,
// the unpreconditioning and the final inlier pass.
//
// Replaces `suo_slam_tpu/solvers/pnp.py` `pnp_ransac` (`:200-271`, vmapped
// by `pnp_ransac_batch` `:274`) after the sampler: the hypotheses, `_gn_refine`
// (`:110`) with `_solve6_spd` (`:96`), the refine block (`:248-262`) and the
// tail (`:264-271`), which the TPU runs as one jitted program. The port's
// eager form (`solvers/pnp.py` `pnp_ransac_batch_plain` with K3) issued
// ~2,900 small PyTorch launches per call after K3.
//
// Bound on this card: latency. At the main path's shapes (O = 8 objects,
// n_hyp = 64, N = 41 points) the inputs are ~12 KB and the work ~2 MFLOP of
// hypotheses plus 16 x 41 x ~200 flops of Gauss-Newton per object: well
// under a microsecond of either bytes or f32 operations. What costs is the
// chain of dependent steps, so the design keeps all of it in one block per
// object, on chip:
//   - stage x, y and the mask in shared memory (as K3), precondition in
//     place (warp 0 sums the centroid and the RMS scale in f64, rounding
//     each once: `_precondition`'s values bit for bit, whatever the order,
//     so the hypotheses, their counts and the argmax are the plain
//     version's);
//   - (b) a thread per hypothesis, `pnp_common.cuh`'s body shared with K3;
//   - (c) the first maximum of the counts by a warp shuffle and a pass over
//     the warps' winners (ties to the lowest index, as torch.argmax);
//   - (d)-(f) warp 0 alone: a lane per point (lane, lane + 32, ...), each
//     lane summing its points' 21 upper H entries, 6 g entries and the cost
//     in registers, then an xor butterfly that leaves the same sums, bit
//     for bit, in every lane; every lane then runs the 6x6 solve
//     (`_solve6_spd`'s closed-form 3x3 Schur blocks), `exp_compose`
//     (`ba_common.cuh`) and the accept test on identical values, so the
//     warp needs no shared memory or barrier to agree on the pose. The
//     round weights w and w * (z > 0) are one bit per point a lane owns (a
//     64-bit mask: N <= 2048).
// An object whose RANSAC failed (fewer than 4 valid points or no hypothesis
// with 4 inliers) skips the refinement: its result is the identity and zero
// counts whatever the refinement would give. Compiled with --fmad=false;
// the sums run in another order than the plain version's einsum and
// reductions, so the accept test, the reselection and the keep gate can flip
// at their edges (chip_smoke holds the outcome, not the bits).

#include <climits>

#include "ba_common.cuh"
#include "pnp_common.cuh"

namespace {

using suo_pnp::nz;

constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kGnIters = 8;        // solvers/pnp.py REFINE_GN_ITERS
constexpr int kRounds = 2;         // refinement rounds, reselecting inliers between them
constexpr float kLambda0 = 1e-4f;  // _gn_refine's initial damping

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// p = R x + t for a row-major 4x4 pose, in `_reproj_sq_err`'s order
__device__ __forceinline__ void transform(const float* T, const float* x, float* p) {
  for (int i = 0; i < 3; ++i)
    p[i] = x[0] * T[i * 4 + 0] + x[1] * T[i * 4 + 1] + x[2] * T[i * 4 + 2] + T[i * 4 + 3];
}

// `_reproj_sq_err`: the squared normalized-plane reprojection error, +inf
// behind the camera
__device__ __forceinline__ float reproj_sq_err(const float* T, const float* x, const float* y) {
  float p[3];
  transform(T, x, p);
  const float iz = 1.f / nz(p[2]);
  const float du = p[0] * iz - y[0];
  const float dv = p[1] * iz - y[1];
  return p[2] > 0.f ? du * du + dv * dv : INFINITY;
}

__device__ __forceinline__ bool all_finite(const float* T) {
  bool f = true;
  for (int k = 0; k < 16; ++k) f = f && isfinite(T[k]);
  return f;
}

// `pnp._inv3`: the closed-form inverse of a row-major 3x3, its columns the
// cross products of the rows over the determinant
__device__ __forceinline__ void inv3(const float* M, float* out) {
  float c0[3], c1[3], c2[3];
  suo_pnp::cross3(M + 3, M + 6, c0);
  suo_pnp::cross3(M + 6, M + 0, c1);
  suo_pnp::cross3(M + 0, M + 3, c2);
  const float idet = 1.f / nz(suo_pnp::dot3(M, c0));
  for (int i = 0; i < 3; ++i) {
    out[i * 3 + 0] = c0[i] * idet;
    out[i * 3 + 1] = c1[i] * idet;
    out[i * 3 + 2] = c2[i] * idet;
  }
}

// `pnp._solve6_spd`: H x = g for the damped SPD 6x6 (row-major) by its 3x3
// Schur blocks A = H[:3, :3], B = H[:3, 3:], D = H[3:, 3:]
__device__ inline void solve6(const float* H, const float* g, float* x) {
  float A[9], B[9], D[9], Ai[9], AiB[9], S[9], Si[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = H[i * 6 + j];
      B[i * 3 + j] = H[i * 6 + 3 + j];
      D[i * 3 + j] = H[(3 + i) * 6 + 3 + j];
    }
  inv3(A, Ai);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      AiB[i * 3 + j] = Ai[i * 3 + 0] * B[0 * 3 + j] + Ai[i * 3 + 1] * B[1 * 3 + j] +
                       Ai[i * 3 + 2] * B[2 * 3 + j];
  for (int i = 0; i < 3; ++i)  // S = D - B^T (Ai B)
    for (int j = 0; j < 3; ++j)
      S[i * 3 + j] = D[i * 3 + j] - (B[0 * 3 + i] * AiB[0 * 3 + j] + B[1 * 3 + i] * AiB[1 * 3 + j] +
                                     B[2 * 3 + i] * AiB[2 * 3 + j]);
  inv3(S, Si);
  float Aig1[3], r2[3], r1[3];
  for (int i = 0; i < 3; ++i)
    Aig1[i] = Ai[i * 3 + 0] * g[0] + Ai[i * 3 + 1] * g[1] + Ai[i * 3 + 2] * g[2];
  for (int i = 0; i < 3; ++i)  // g2 - B^T (Ai g1)
    r2[i] = g[3 + i] - (B[0 * 3 + i] * Aig1[0] + B[1 * 3 + i] * Aig1[1] + B[2 * 3 + i] * Aig1[2]);
  for (int i = 0; i < 3; ++i)
    x[3 + i] = Si[i * 3 + 0] * r2[0] + Si[i * 3 + 1] * r2[1] + Si[i * 3 + 2] * r2[2];
  for (int i = 0; i < 3; ++i)  // g1 - B x2
    r1[i] = g[i] - (B[i * 3 + 0] * x[3] + B[i * 3 + 1] * x[4] + B[i * 3 + 2] * x[5]);
  for (int i = 0; i < 3; ++i)
    x[i] = Ai[i * 3 + 0] * r1[0] + Ai[i * 3 + 1] * r1[1] + Ai[i * 3 + 2] * r1[2];
}

// The 28 sums of one Gauss-Newton step: H's 21 upper entries (row-major), g
// (6) and the weighted cost.
constexpr int kSums = 28;

// One point's terms of `_gn_refine`'s step under pose T: the 2x6 Jacobian
// of the left update (Jproj @ [-hat(p) | I]) weighted by wz = w * (z > 0)
// (never pull a behind-camera point), into acc. Returns wz.
__device__ __forceinline__ bool gn_terms(const float* T, const float* x, const float* y,
                                         bool w, float* acc) {
  float p[3];
  transform(T, x, p);
  const bool wzb = w && p[2] > 0.f;
  const float wz = wzb ? 1.f : 0.f;
  const float iz = 1.f / nz(p[2]);
  const float u = p[0] * iz, v = p[1] * iz;
  const float r0 = u - y[0], r1 = v - y[1];
  const float bu = -u * iz, bv = -v * iz;
  const float J0[6] = {bu * p[1], iz * p[2] + bu * -p[0], iz * -p[1], iz, 0.f, bu};
  const float J1[6] = {iz * -p[2] + bv * p[1], bv * -p[0], iz * p[0], 0.f, iz, bv};
  float W0[6], W1[6];
  for (int k = 0; k < 6; ++k) {
    W0[k] = J0[k] * wz;
    W1[k] = J1[k] * wz;
  }
  int e = 0;
  for (int k = 0; k < 6; ++k)
    for (int l = k; l < 6; ++l) acc[e++] += W0[k] * J0[l] + W1[k] * J1[l];
  for (int k = 0; k < 6; ++k) acc[21 + k] += W0[k] * r0 + W1[k] * r1;
  acc[27] += wz * (r0 * r0 + r1 * r1);
  return wzb;
}

__device__ __forceinline__ float trial_cost_term(const float* T, const float* x, const float* y,
                                                 float wz) {
  float p[3];
  transform(T, x, p);
  const float iz = 1.f / nz(p[2]);
  const float r0 = p[0] * iz - y[0], r1 = p[1] * iz - y[1];
  return wz * (r0 * r0 + r1 * r1);
}

// `_gn_refine` on warp 0: 8 damped Gauss-Newton iterations on the points
// whose bit is set in w (a lane's points n = lane + 32 j), from pose T (the
// same in every lane), in place.
__device__ void gn_refine(float* T, const float* sx, const float* sy, int N,
                          unsigned long long w, int lane) {
  float lam = kLambda0;
  for (int it = 0; it < kGnIters; ++it) {
    float acc[kSums];
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    unsigned long long wz_bits = 0ull;
    for (int n = lane, j = 0; n < N; n += 32, ++j) {
      const bool wz = gn_terms(T, sx + n * 3, sy + n * 2, (w >> j) & 1ull, acc);
      wz_bits |= (unsigned long long)wz << j;
    }
    for (int k = 0; k < kSums; ++k) acc[k] = warp_sum(acc[k]);
    float H[36], g[6], delta[6], Tn[16];
    for (int k = 0, e = 0; k < 6; ++k)
      for (int l = k; l < 6; ++l, ++e) H[k * 6 + l] = H[l * 6 + k] = acc[e];
    for (int k = 0; k < 6; ++k) g[k] = acc[21 + k];
    const float cost = acc[27];
    float tr = 0.f;
    for (int k = 0; k < 6; ++k) tr += H[k * 6 + k];
    // tr / 6 as PyTorch divides by a Python scalar on the card: by its reciprocal
    const float damp = lam * suo_ba::clampmin(tr * (1.f / 6.f), 1e-12f);
    for (int k = 0; k < 6; ++k) H[k * 6 + k] += damp;
    solve6(H, g, delta);
    for (int k = 0; k < 6; ++k) delta[k] = -delta[k];
    suo_ba::exp_compose(delta, T, Tn);
    float part = 0.f;
    for (int n = lane, j = 0; n < N; n += 32, ++j)
      part += trial_cost_term(Tn, sx + n * 3, sy + n * 2, ((wz_bits >> j) & 1ull) ? 1.f : 0.f);
    const float cost2 = warp_sum(part);
    const bool ok = cost2 < cost && all_finite(Tn);
    if (ok)
      for (int k = 0; k < 16; ++k) T[k] = Tn[k];
    lam = ok ? lam * 0.33f : lam * 4.f;
  }
}

// The inlier bits of a lane's points (n = lane + 32 j) under pose T, and
// their count over the warp.
__device__ __forceinline__ unsigned long long inlier_bits(const float* T, const float* sx,
                                                          const float* sy, const float* smk,
                                                          int N, float thr_sq, int lane,
                                                          int& count) {
  unsigned long long bits = 0ull;
  int c = 0;
  for (int n = lane, j = 0; n < N; n += 32, ++j) {
    const bool in = reproj_sq_err(T, sx + n * 3, sy + n * 2) < thr_sq && smk[n] != 0.f;
    bits |= (unsigned long long)in << j;
    c += in ? 1 : 0;
  }
  count = warp_sum_int(c);
  return bits;
}

__global__ void pnp_ransac_kernel(const float* __restrict__ x, const float* __restrict__ yn,
                                  const uint8_t* __restrict__ mask,
                                  const long long* __restrict__ idx, int N, int H,
                                  float thr_sq, int refine, float* __restrict__ T_out,
                                  uint8_t* __restrict__ inl_out,
                                  long long* __restrict__ num_out,
                                  uint8_t* __restrict__ succ_out) {
  extern __shared__ float sm[];
  float* sx = sm;             // [N, 3] x, then preconditioned in place
  float* sy = sm + 3 * N;     // [N, 2]
  float* smk = sm + 5 * N;    // [N]
  __shared__ float s_cs[4];   // centroid, scale
  __shared__ int s_cnt[kMaxWarps], s_h[kMaxWarps];
  __shared__ float s_T[16];   // the best hypothesis's pose
  const int o = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xo = x + (long long)o * N * 3;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = xo[n * 3 + k];
    for (int k = 0; k < 2; ++k) sy[n * 2 + k] = yn[((long long)o * N + n) * 2 + k];
    smk[n] = mask[(long long)o * N + n] ? 1.f : 0.f;
  }
  __syncthreads();

  // (a) `_precondition`: centroid and RMS scale over the valid points, the
  // sums in f64 (exact for a few dozen f32 terms, so in any order) and each
  // statistic rounded once to f32, as the plain version computes them
  int n_valid = 0;
  float c[3], s = 0.f;
  if (warp == 0) {
    double sum[3] = {0.0, 0.0, 0.0};
    int cnt = 0;
    for (int n = lane; n < N; n += 32) {
      for (int k = 0; k < 3; ++k) sum[k] += (double)(sx[n * 3 + k] * smk[n]);
      cnt += smk[n] != 0.f ? 1 : 0;
    }
    n_valid = warp_sum_int(cnt);
    const double nd = n_valid > 1 ? (double)n_valid : 1.0;
    for (int k = 0; k < 3; ++k) c[k] = (float)(warp_sum_f64(sum[k]) / nd);
    double ss = 0.0;
    for (int n = lane; n < N; n += 32)
      for (int k = 0; k < 3; ++k) {
        const float xc = (sx[n * 3 + k] - c[k]) * smk[n];
        ss += (double)(xc * xc);
      }
    const double var = warp_sum_f64(ss) / nd;
    s = (float)sqrt(isnan(var) ? var : fmax(var, 1e-12));
    if (lane == 0) {
      for (int k = 0; k < 3; ++k) s_cs[k] = c[k];
      s_cs[3] = s;
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = (sx[n * 3 + k] - s_cs[k]) / s_cs[3];
  __syncthreads();

  // (b) a thread per hypothesis; each thread keeps its first maximum
  int best_cnt = INT_MIN, best_h = INT_MAX;
  float bR[9], bt[3];
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const long long* ip = idx + ((long long)o * H + h) * 4;
    int id[4];
    for (int k = 0; k < 4; ++k) id[k] = (ip[k] < 0 || ip[k] >= N) ? -1 : (int)ip[k];
    float R[9], t[3];
    bool ok;
    const int cnt = suo_pnp::solve_hypothesis(sx, sy, smk, N, id, thr_sq, R, t, ok);
    if (cnt > best_cnt) {
      best_cnt = cnt;
      best_h = h;
      for (int k = 0; k < 9; ++k) bR[k] = R[k];
      for (int k = 0; k < 3; ++k) bt[k] = t[k];
    }
  }

  // (c) the block's first maximum: the warps' winners, then theirs
  int wc = best_cnt, wh = best_h;
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
    const int oh = __shfl_xor_sync(0xffffffffu, wh, off);
    if (oc > wc || (oc == wc && oh < wh)) { wc = oc; wh = oh; }
  }
  if (lane == 0) { s_cnt[warp] = wc; s_h[warp] = wh; }
  __syncthreads();
  int top_cnt = s_cnt[0], top_h = s_h[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (s_cnt[w] > top_cnt || (s_cnt[w] == top_cnt && s_h[w] < top_h)) {
      top_cnt = s_cnt[w];
      top_h = s_h[w];
    }
  if (best_h == top_h) {  // the thread that solved the winner
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_T[i * 4 + j] = bR[i * 3 + j];
      s_T[i * 4 + 3] = bt[i];
    }
    s_T[12] = 0.f; s_T[13] = 0.f; s_T[14] = 0.f; s_T[15] = 1.f;
  }
  __syncthreads();
  if (warp != 0) return;  // warp 0 alone from here on: no more block barriers

  float T[16];
  for (int k = 0; k < 16; ++k) T[k] = s_T[k];
  bool success = n_valid >= 4 && top_cnt >= 4;

  // (d) two refinement rounds, each from the inliers of the current pose,
  // then (e) the keep gate: the refined pose only if no inlier was lost
  if (refine && success) {
    float Tr[16];
    for (int k = 0; k < 16; ++k) Tr[k] = T[k];
    for (int r = 0; r < kRounds; ++r) {
      int cnt;
      const unsigned long long w = inlier_bits(Tr, sx, sy, smk, N, thr_sq, lane, cnt);
      gn_refine(Tr, sx, sy, N, w, lane);
    }
    int cnt3;
    inlier_bits(Tr, sx, sy, smk, N, thr_sq, lane, cnt3);
    if (cnt3 >= top_cnt && all_finite(Tr))
      for (int k = 0; k < 16; ++k) T[k] = Tr[k];
  }

  // (f) `_unprecondition`, the final inliers on the raw points, the gate
  for (int i = 0; i < 3; ++i)
    T[i * 4 + 3] = s * T[i * 4 + 3] - (T[i * 4 + 0] * c[0] + T[i * 4 + 1] * c[1] + T[i * 4 + 2] * c[2]);
  success = success && all_finite(T);
  int num = 0;
  for (int n = lane; n < N; n += 32) {
    const float* xn = xo + n * 3;
    const bool in = success && reproj_sq_err(T, xn, sy + n * 2) < thr_sq && smk[n] != 0.f;
    inl_out[(long long)o * N + n] = in ? 1 : 0;
    num += in ? 1 : 0;
  }
  num = warp_sum_int(num);
  if (lane < 16) T_out[(long long)o * 16 + lane] = success ? T[lane] : ((lane % 5 == 0) ? 1.f : 0.f);
  if (lane == 0) {
    num_out[o] = num;
    succ_out[o] = success ? 1 : 0;
  }
}

}  // namespace

extern "C" int suo_pnp_ransac(const void* x, const void* yn, const void* mask, const void* idx,
                              int O, int N, int H, float thr_sq, int refine, void* T_out,
                              void* inl_out, void* num_out, void* succ_out, void* stream) {
  if (O > 0 && H > 0) {
    const int threads = H >= kMaxThreads ? kMaxThreads : ((H + 31) / 32) * 32;
    const size_t shmem = (size_t)6 * N * sizeof(float);
    if (shmem > 40 * 1024) {  // above the default 48 KB with the static arrays
      const cudaError_t e = cudaFuncSetAttribute(
          pnp_ransac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    pnp_ransac_kernel<<<O, threads, shmem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)yn, (const uint8_t*)mask, (const long long*)idx, N, H,
        thr_sq, refine, (float*)T_out, (uint8_t*)inl_out, (long long*)num_out,
        (uint8_t*)succ_out);
  }
  return (int)cudaGetLastError();
}
