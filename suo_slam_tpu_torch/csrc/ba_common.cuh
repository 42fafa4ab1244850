// Device math shared by the bundle-adjustment kernels K4 (`ba_edges.cu`),
// K7 (`ba_schur.cu`) and K14 (`ba_lm.cu`): one edge's projection, residual
// and chi2, its analytic 2x12 Jacobian, the 6x6 block algebra of the
// damped, Jacobi-scaled Schur solve, and the SE(3) exponential with its
// left composition (which K15, `pnp_ransac.cu`, includes too). The kernels
// include this one header, so they agree by construction. Compiled with
// --fmad=false (see `kernels/_build.py`): every a*b+c below is two rounded
// operations, as PyTorch's separate elementwise kernels compute it in the
// plain versions.

#pragma once

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace suo_ba {

__device__ __forceinline__ float clamp_iz(float z) {
  return 1.f / (fabsf(z) < 1e-12f ? 1e-12f : z);
}

// max(x, lo) that keeps NaN, like torch.clamp
__device__ __forceinline__ float clampmin(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// One edge: its point in the object's world frame (pG), in the camera frame
// (px, py, pz), the clamped 1/z, the residual (ru, rv) and chi2 under the
// 2x2 information [[w00, w01], [w01, w11]].
struct Edge {
  float gx, gy, gz, px, py, pz, iz, ru, rv, chi2;
};

// Tc: T_GtoC row-major 4x4; To: T_OtoG; m: the model point; ck: (fx, fy,
// cx, cy); uv: the measurement; w: the information (row-major 2x2).
__device__ __forceinline__ Edge project_edge(const float* Tc, const float* To,
                                             const float* m, const float* ck,
                                             const float* uv, const float* w) {
  Edge e;
  float pG[3], pC[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pG[i] = To[i * 4 + 0] * m[0] + To[i * 4 + 1] * m[1] + To[i * 4 + 2] * m[2] + To[i * 4 + 3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pC[i] = Tc[i * 4 + 0] * pG[0] + Tc[i * 4 + 1] * pG[1] + Tc[i * 4 + 2] * pG[2] + Tc[i * 4 + 3];
  e.gx = pG[0]; e.gy = pG[1]; e.gz = pG[2];
  e.px = pC[0]; e.py = pC[1]; e.pz = pC[2];
  e.iz = clamp_iz(e.pz);
  e.ru = uv[0] - (ck[0] * e.px * e.iz + ck[2]);
  e.rv = uv[1] - (ck[1] * e.py * e.iz + ck[3]);
  e.chi2 = w[0] * e.ru * e.ru + 2.f * w[1] * e.ru * e.rv + w[3] * e.rv * e.rv;
  return e;
}

// The Huber IRLS weight of an edge (1 inside the kernel's threshold d^2).
__device__ __forceinline__ float huber_weight(float chi2, float huber_d, float huber_d2) {
  if (chi2 <= huber_d2) return 1.f;
  return huber_d / sqrtf(isnan(chi2) ? chi2 : fmaxf(chi2, 1e-30f));
}

// The analytic left-se(3) Jacobian of an edge's residual: u-row r0, v-row
// r1; columns 0-5 the camera [omega, v], 6-11 the object. Tc is T_GtoC.
__device__ __forceinline__ void edge_jacobian(const float* Tc, const float* ck, const Edge& e,
                                              float r0[12], float r1[12]) {
  const float fx = ck[0], fy = ck[1];
  const float A = fx * e.iz;
  const float B = -fx * e.px * e.iz * e.iz;
  const float C = fy * e.iz;
  const float D = -fy * e.py * e.iz * e.iz;
  // camera columns: -(Jproj @ [-hat(p_C) | I])
  r0[0] = -B * e.py; r0[1] = B * e.px - A * e.pz; r0[2] = A * e.py;
  r0[3] = -A;        r0[4] = 0.f;                 r0[5] = -B;
  r1[0] = C * e.pz - D * e.py; r1[1] = D * e.px; r1[2] = -C * e.px;
  r1[3] = 0.f;                 r1[4] = -C;       r1[5] = -D;
  // object columns: M = Jproj @ R_cw, then -(M @ [-hat(p_G) | I])
  float M0[3], M1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    M0[j] = A * Tc[0 * 4 + j] + B * Tc[2 * 4 + j];
    M1[j] = C * Tc[1 * 4 + j] + D * Tc[2 * 4 + j];
  }
  r0[6] = M0[1] * e.gz - M0[2] * e.gy;
  r0[7] = -(M0[0] * e.gz - M0[2] * e.gx);
  r0[8] = M0[0] * e.gy - M0[1] * e.gx;
  r0[9] = -M0[0]; r0[10] = -M0[1]; r0[11] = -M0[2];
  r1[6] = M1[1] * e.gz - M1[2] * e.gy;
  r1[7] = -(M1[0] * e.gz - M1[2] * e.gx);
  r1[8] = M1[0] * e.gy - M1[1] * e.gx;
  r1[9] = -M1[0]; r1[10] = -M1[1]; r1[11] = -M1[2];
}

// 6x6 lower Cholesky factor of sym(A) (row-major), unblocked as LAPACK's
// potf2; a pivot that is not > 0 (or NaN) makes the whole factor NaN, as
// `jax.lax.linalg.cholesky` gives it.
__device__ inline void chol6(const float* A, float* L) {
  float S[36];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) S[i * 6 + j] = 0.5f * (A[i * 6 + j] + A[j * 6 + i]);
  bool ok = true;
  for (int i = 0; i < 36; ++i) L[i] = 0.f;
  for (int j = 0; j < 6 && ok; ++j) {
    float d = S[j * 6 + j];
    for (int k = 0; k < j; ++k) d -= L[j * 6 + k] * L[j * 6 + k];
    if (!(d > 0.f)) { ok = false; break; }
    const float ljj = sqrtf(d);
    L[j * 6 + j] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      float a = S[i * 6 + j];
      for (int k = 0; k < j; ++k) a -= L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = a / ljj;
    }
  }
  if (!ok)
    for (int i = 0; i < 36; ++i) L[i] = nanf("");
}

// x = L^-T L^-1 b for a 6x6 lower factor L
__device__ __forceinline__ void cho_solve6(const float* L, const float* b, float* x) {
  float z[6];
  for (int i = 0; i < 6; ++i) {
    float a = b[i];
    for (int k = 0; k < i; ++k) a -= L[i * 6 + k] * z[k];
    z[i] = a / L[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    float a = z[i];
    for (int k = i + 1; k < 6; ++k) a -= L[k * 6 + i] * x[k];
    x[i] = a / L[i * 6 + i];
  }
}

// damped (H + lam * max(diag, 1e-9) on the diagonal), then masked (H for a
// free state, I for a frozen one): entry (i, j) of one 6x6 block
__device__ __forceinline__ float damp_mask(const float* H, int i, int j, float lam, float m) {
  const float d = clampmin(H[i * 6 + i], 1e-9f);
  const float hd = H[i * 6 + j] + lam * d * (i == j ? 1.f : 0.f);
  return hd * m + (1.f - m) * (i == j ? 1.f : 0.f);
}

// T <- se3_exp(d) @ T for one row-major 4x4 pose (the port's `core/lie.py`
// `se3_exp`: Rodrigues with its small-angle Taylor branches, t = V(w) v):
// K14's pose update and K15's (`pnp_ransac.cu`) Gauss-Newton step.
// a * b + c: two roundings, as the plain version's separate multiply and add
// (with --fmad=false), or with kFused one fused multiply-add, for callers
// whose result is held to its outcome rather than its bits (K15's
// Gauss-Newton, where fewer instructions make a shorter step)
template <bool kFused>
__device__ __forceinline__ float mad(float a, float b, float c) {
  return kFused ? __fmaf_rn(a, b, c) : a * b + c;
}

template <bool kFused = false>
__device__ inline void exp_compose(const float* d, const float* T, float* out) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float theta2 = mad<kFused>(w2, w2, mad<kFused>(w0, w0, w1 * w1));
  const float theta = sqrtf(clampmin(theta2, 0.f));
  // the small-angle series or the closed form, whichever the plain version's
  // `where` keeps: a branch, so the other side is not computed
  float A, B, C;
  if (theta2 < 1e-8f) {
    A = 1.f - theta2 / 6.f;
    B = 0.5f - theta2 / 24.f;
    C = (1.f / 6.f) - theta2 / 120.f;
  } else {
    float st, ct;
    sincosf(theta, &st, &ct);  // sinf's and cosf's values, one range reduction
    A = st / sqrtf(theta2);
    B = (1.f - ct) / theta2;
    C = (theta - st) / (theta2 * sqrtf(theta2));
  }
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float WW[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)  // (W_i0 W_0j + W_i1 W_1j) + W_i2 W_2j
      WW[i * 3 + j] = mad<kFused>(W[i * 3 + 2], W[2 * 3 + j],
                                  mad<kFused>(W[i * 3 + 0], W[0 * 3 + j],
                                              W[i * 3 + 1] * W[1 * 3 + j]));
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // (I + A W) + B WW
      const float I = i == j ? 1.f : 0.f;
      E[i * 4 + j] = mad<kFused>(B, WW[i * 3 + j], mad<kFused>(A, W[i * 3 + j], I));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Vr[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)  // (I + B W) + C WW
      Vr[j] = mad<kFused>(C, WW[i * 3 + j], mad<kFused>(B, W[i * 3 + j], i == j ? 1.f : 0.f));
    E[i * 4 + 3] = mad<kFused>(Vr[2], d[5], mad<kFused>(Vr[0], d[3], Vr[1] * d[4]));
  }
  E[12] = 0.f; E[13] = 0.f; E[14] = 0.f; E[15] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // ((E_i0 T_0j + E_i1 T_1j) + E_i2 T_2j) + E_i3 T_3j
      out[i * 4 + j] = mad<kFused>(E[i * 4 + 3], T[3 * 4 + j],
                                   mad<kFused>(E[i * 4 + 2], T[2 * 4 + j],
                                               mad<kFused>(E[i * 4 + 0], T[0 * 4 + j],
                                                           E[i * 4 + 1] * T[1 * 4 + j])));
}

}  // namespace suo_ba
