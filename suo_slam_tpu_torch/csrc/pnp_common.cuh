// Device math shared by the PnP kernels K3 (`pnp_hypotheses.cu`) and K15
// (`pnp_ransac.cu`): LambdaTwist P3P on 3 points and its disambiguation by a
// 4th (`solve_pose`, scalar code for one thread), and the inlier test of a
// pose (`is_inlier`, `count_inliers`) — the two halves of one RANSAC
// hypothesis. It mirrors `solvers/p3p.py` operation by
// operation (same Newton trip counts, same guards, same failure contract:
// identity pose and ok = false). The two kernels include this one header, so
// they compute the same hypotheses by construction. Compiled with
// --fmad=false (see `kernels/_build.py`): every a*b+c below is two rounded
// operations, as PyTorch's separate elementwise kernels compute it in the
// plain versions.

#pragma once

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace suo_pnp {

constexpr int kCubicIters = 50;
constexpr int kRefineIters = 5;
constexpr float kTiny = 1e-30f;
constexpr float kThird = 1.f / 3.f;  // x * (1/3), as solvers/p3p.py writes it

// x with |x| < 1e-30 replaced by sign * 1e-30 (`p3p._nz`)
__device__ __forceinline__ float nz(float x, float sign = 1.f) {
  return fabsf(x) < kTiny ? sign * kTiny : x;
}

// max(x, 0) that keeps NaN, like torch.clamp / jnp.maximum (fmaxf drops it)
__device__ __forceinline__ float clamp0(float x) {
  return isnan(x) ? x : fmaxf(x, 0.f);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void root2real(float b, float c, float& r1,
                                          float& r2, bool& ok) {
  const float v = b * b - 4.f * c;
  ok = v >= 0.f;
  const float y = sqrtf(clamp0(v));
  const float dp = nz(-b + y), dm = nz(-b - y);
  r1 = b < 0.f ? 0.5f * (-b + y) : 2.f * c / dp;
  r2 = b < 0.f ? 0.5f * (-b - y) : 2.f * c / dm;
}

__device__ inline float cubick(float b, float c, float d) {
  const float disc = b * b - 3.f * c;
  const bool has_stat = disc >= 0.f;
  const float v = sqrtf(clamp0(disc));
  const float t1 = (-b - v) * kThird;
  const float k1 = ((t1 + b) * t1 + c) * t1 + d;
  const float t2 = (-b + v) * kThird;
  const float k2 = ((t2 + b) * t2 + c) * t2 + d;
  const float r0_left = t1 - sqrtf(clamp0(-k1 / nz(3.f * t1 + b, -1.f)));
  const float r0_right = t2 + sqrtf(clamp0(-k2 / nz(3.f * t2 + b)));
  const float r0_stat = k1 > 0.f ? r0_left : r0_right;
  float r0_mono = -b * kThird;
  const float dh = (3.f * r0_mono + 2.f * b) * r0_mono + c;
  r0_mono = fabsf(dh) < 1e-4f ? r0_mono + 1.f : r0_mono;
  float r = has_stat ? r0_stat : r0_mono;
  // kCubicIters Newton steps r <- r - f(r) / f'(r). A step is a function of
  // r alone, so once an iterate repeats bit for bit — the step returns to
  // the iterate m <= 4 steps back (a fixed point, or a cycle near a double
  // root) — the sequence is periodic from there, every later iterate is
  // known, and the loop ends with the value the full trip count gives
  // (`p3p._cubick`'s).
  float h1 = r, h2 = r, h3 = r;  // the iterates 1, 2 and 3 steps before r
  for (int it = 0; it < kCubicIters; ++it) {
    const float fx = ((r + b) * r + c) * r + d;
    const float fpx = nz((3.f * r + 2.f * b) * r + c);
    const float next = r - fx / fpx;
    const int nb = __float_as_int(next);
    // period m from iterate it + 1 - m: the last iterate is the one (m - 1)
    // - (kCubicIters - (it + 1 - m)) % m steps before r
    int m = 0;
    if (nb == __float_as_int(r)) m = 1;
    else if (it >= 1 && nb == __float_as_int(h1)) m = 2;
    else if (it >= 2 && nb == __float_as_int(h2)) m = 3;
    else if (it >= 3 && nb == __float_as_int(h3)) m = 4;
    if (m) {
      const int back = (m - 1) - (kCubicIters - (it + 1 - m)) % m;
      return back == 0 ? r : back == 1 ? h1 : back == 2 ? h2 : h3;
    }
    h3 = h2;
    h2 = h1;
    h1 = r;
    r = next;
  }
  return r;
}

__device__ __forceinline__ void residuals(float l1, float l2, float l3,
                                          float a12, float a13, float a23,
                                          float b12, float b13, float b23,
                                          float& r1, float& r2, float& r3) {
  r1 = l1 * l1 + l2 * l2 + b12 * l1 * l2 - a12;
  r2 = l1 * l1 + l3 * l3 + b13 * l1 * l3 - a13;
  r3 = l2 * l2 + l3 * l3 + b23 * l2 * l3 - a23;
}

__device__ inline void refine_L(float& l1, float& l2, float& l3, float a12, float a13,
                                float a23, float b12, float b13, float b23) {
  for (int it = 0; it < kRefineIters; ++it) {
    float r1, r2, r3;
    residuals(l1, l2, l3, a12, a13, a23, b12, b13, b23, r1, r2, r3);
    const float dr1dl1 = 2.f * l1 + b12 * l2;
    const float dr1dl2 = 2.f * l2 + b12 * l1;
    const float dr2dl1 = 2.f * l1 + b13 * l3;
    const float dr2dl3 = 2.f * l3 + b13 * l1;
    const float dr3dl2 = 2.f * l2 + b23 * l3;
    const float dr3dl3 = 2.f * l3 + b23 * l2;
    const float det_d = -dr1dl1 * dr2dl3 * dr3dl2 - dr1dl2 * dr2dl1 * dr3dl3;
    const float det = 1.f / nz(det_d);
    const float s1 = -dr2dl3 * dr3dl2 * r1 + -dr1dl2 * dr3dl3 * r2 + dr1dl2 * dr2dl3 * r3;
    const float s2 = -dr2dl1 * dr3dl3 * r1 + dr1dl1 * dr3dl3 * r2 + -dr1dl1 * dr2dl3 * r3;
    const float s3 = dr2dl1 * dr3dl2 * r1 + -dr1dl1 * dr3dl2 * r2 + -dr1dl2 * dr2dl1 * r3;
    const float n1 = l1 - det * s1, n2 = l2 - det * s2, n3 = l3 - det * s3;
    float q1, q2, q3;
    residuals(n1, n2, n3, a12, a13, a23, b12, b13, b23, q1, q2, q3);
    if (fabsf(q1) + fabsf(q2) + fabsf(q3) <= fabsf(r1) + fabsf(r2) + fabsf(r3)) {
      l1 = n1; l2 = n2; l3 = n3;
    }
  }
}

__device__ __forceinline__ void eigvec(float e, float A00, float A02, float A11,
                                       float A12, float mx0011, float x01_sq,
                                       float prec_0, float prec_1, float* out) {
  const float tmp_d = e * (A00 + A11) + mx0011 - e * e + x01_sq;
  const float tmp = 1.f / nz(tmp_d);
  const float a1 = -(e * A02 + prec_0) * tmp;
  const float a2 = -(e * A12 + prec_1) * tmp;
  const float rnorm = 1.f / sqrtf(a1 * a1 + a2 * a2 + 1.f);
  out[0] = a1 * rnorm;
  out[1] = a2 * rnorm;
  out[2] = rnorm;
}

// The squared reprojection error of the 4th point (xq, yq) under candidate
// (R, t), or +inf where the candidate is not good: invalid, the point behind
// the camera, R^T R off the identity by 1e-2 or more, or a non-finite error
// (`p3p.p4p`'s disambiguation).
__device__ __forceinline__ float fourth_point_err(const float R[9], const float t[3], bool valid,
                                                  const float* xq, const float* yq) {
  float xr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xr[i] = R[i * 3 + 0] * xq[0] + R[i * 3 + 1] * xq[1] + R[i * 3 + 2] * xq[2] + t[i];
  const bool z_ok = xr[2] > 0.f;
  const float iz = 1.f / nz(xr[2]);
  const float du = xr[0] * iz - yq[0];
  const float dv = xr[1] * iz - yq[1];
  const float e = du * du + dv * dv;
  float dev = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float rtr = R[0 * 3 + i] * R[0 * 3 + j] + R[1 * 3 + i] * R[1 * 3 + j] + R[2 * 3 + i] * R[2 * 3 + j];
      dev = fmaxf(dev, fabsf(rtr - (i == j ? 1.f : 0.f)));
    }
  }
  const bool good = valid && z_ok && (dev < 1e-2f) && isfinite(e);
  return good ? e : INFINITY;
}

// What P3P's four candidates share (`p3p.p3p` up to the candidates): the
// bearings, the squared distances and cosines, the root of the cubic, the
// eigenvectors and v of the degenerate conic, and the inverse of the model
// triangle's frame.
struct P3pPrefix {
  float y1[3], y2[3], y3[3];
  float a12, a13, a23, b12, b13, b23;
  float v1[3], v2[3], v;
  float Xinv[3][3];
};

// P3P's shared part for rows y[3][3] (bearings) and x[3][3].
__device__ inline void p3p_prefix(const float y[3][3], const float x[3][3], P3pPrefix& P) {
  {
    const float n1 = sqrtf(dot3(y[0], y[0]));
    const float n2 = sqrtf(dot3(y[1], y[1]));
    const float n3 = sqrtf(dot3(y[2], y[2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P.y1[k] = y[0][k] / n1; P.y2[k] = y[1][k] / n2; P.y3[k] = y[2][k] / n3;
    }
  }
  const float b12 = -2.f * dot3(P.y1, P.y2);
  const float b13 = -2.f * dot3(P.y1, P.y3);
  const float b23 = -2.f * dot3(P.y2, P.y3);
  float d12[3], d13[3], d23[3], d12xd13[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d12[k] = x[0][k] - x[1][k];
    d13[k] = x[0][k] - x[2][k];
    d23[k] = x[1][k] - x[2][k];
  }
  cross3(d12, d13, d12xd13);
  const float a12 = dot3(d12, d12), a13 = dot3(d13, d13), a23 = dot3(d23, d23);

  const float c31 = -0.5f * b13, c23 = -0.5f * b23, c12 = -0.5f * b12;
  const float blob = c12 * c23 * c31 - 1.f;
  const float s31_sq = 1.f - c31 * c31;
  const float s23_sq = 1.f - c23 * c23;
  const float s12_sq = 1.f - c12 * c12;
  const float p3 = a13 * (a23 * s31_sq - a13 * s23_sq);
  const float p2 = 2.f * blob * a23 * a13 + a13 * (2.f * a12 + a13) * s23_sq + a23 * (a23 - a12) * s31_sq;
  const float p1 = a23 * (a13 - a23) * s12_sq - a12 * a12 * s23_sq - 2.f * a12 * (blob * a23 + a13 * s23_sq);
  const float p0 = a12 * (a12 * s23_sq - a23 * s12_sq);
  const float ip3 = 1.f / nz(p3);
  const float g = cubick(p2 * ip3, p1 * ip3, p0 * ip3);

  const float A00 = a23 * (1.f - g);
  const float A01 = (a23 * b12) * 0.5f;
  const float A02 = (a23 * b13 * g) * (-0.5f);
  const float A11 = a23 - a12 + a13 * g;
  const float A12 = b23 * (a13 * g - a12) * 0.5f;
  const float A22 = g * (a13 - a23) - a12;

  // eigendecomposition with the known zero eigenvalue
  const float x01_sq = A01 * A01;
  const float eb = -A00 - A11 - A22;
  const float ec = -x01_sq - A02 * A02 - A12 * A12 + A00 * (A11 + A22) + A11 * A22;
  float e1, e2;
  bool eok;
  root2real(eb, ec, e1, e2, eok);
  if (fabsf(e1) < fabsf(e2)) { const float t_ = e1; e1 = e2; e2 = t_; }
  const float mx0011 = -A00 * A11;
  const float prec_0 = A01 * A12 - A02 * A11;
  const float prec_1 = A01 * A02 - A00 * A12;
  eigvec(e1, A00, A02, A11, A12, mx0011, x01_sq, prec_0, prec_1, P.v1);
  eigvec(e2, A00, A02, A11, A12, mx0011, x01_sq, prec_0, prec_1, P.v2);
  const float L0 = nz(e1);
  P.v = sqrtf(clamp0(-e2 / L0));

  // closed-form inverse of X = [d12 | d13 | d12xd13] (columns)
  const float Xr[3][3] = {{d12[0], d13[0], d12xd13[0]},
                          {d12[1], d13[1], d12xd13[1]},
                          {d12[2], d13[2], d12xd13[2]}};
  float c0[3], c1[3], c2[3];
  cross3(Xr[1], Xr[2], c0);
  cross3(Xr[2], Xr[0], c1);
  cross3(Xr[0], Xr[1], c2);
  const float idet = 1.f / nz(dot3(Xr[0], c0));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P.Xinv[i][0] = c0[i] * idet; P.Xinv[i][1] = c1[i] * idet; P.Xinv[i][2] = c2[i] * idet;
  }
  P.a12 = a12; P.a13 = a13; P.a23 = a23;
  P.b12 = b12; P.b13 = b13; P.b23 = b23;
}

// P3P candidate q = 2 sgn + r (`p3p.p3p`'s order: the sign of v, then the
// quadratic's root): its lambdas, refined, and the pose they give (R
// row-major, t). Returns the 4th point's error under it (`fourth_point_err`:
// +inf where the candidate is not good).
__device__ inline float p3p_candidate(const P3pPrefix& P, const float x0[3], int sgn, int r,
                                      const float* xq, const float* yq, float R[9],
                                      float t[3]) {
  const float a12 = P.a12, a13 = P.a13, a23 = P.a23;
  const float b12 = P.b12, b13 = P.b13, b23 = P.b23;
  const float s = sgn == 0 ? P.v : -P.v;
  const float w2 = 1.f / nz(s * P.v2[0] - P.v1[0]);
  const float w0 = (P.v1[1] - s * P.v2[1]) * w2;
  const float w1 = (P.v1[2] - s * P.v2[2]) * w2;
  const float a = 1.f / nz((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12);
  const float b = (a13 * b12 * w1 - a12 * b13 * w0 - 2.f * w0 * w1 * (a12 - a13)) * a;
  const float c = ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13) * a;
  float tau0, tau1;
  bool real;
  root2real(b, c, tau0, tau1, real);
  const float tau = r == 0 ? tau0 : tau1;
  const bool tau_ok = tau > 0.f;
  const float ts_ = tau_ok ? tau : 1.f;
  const float d_ = a23 / (ts_ * (b23 + ts_) + 1.f);
  float l2 = sqrtf(clamp0(d_));
  float l3 = ts_ * l2;
  float l1 = w0 * l2 + w1 * l3;
  const bool ok_l = real && tau_ok && (d_ > 0.f) && (l1 >= 0.f);
  refine_L(l1, l2, l3, a12, a13, a23, b12, b13, b23);
  float ry1[3], ry2[3], ry3[3], yd1[3], yd2[3], yd1xd2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ry1[k] = P.y1[k] * l1; ry2[k] = P.y2[k] * l2; ry3[k] = P.y3[k] * l3;
    yd1[k] = ry1[k] - ry2[k]; yd2[k] = ry1[k] - ry3[k];
  }
  cross3(yd1, yd2, yd1xd2);
  const float Yr[3][3] = {{yd1[0], yd2[0], yd1xd2[0]},
                          {yd1[1], yd2[1], yd1xd2[1]},
                          {yd1[2], yd2[2], yd1xd2[2]}};
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i * 3 + j] = Yr[i][0] * P.Xinv[0][j] + Yr[i][1] * P.Xinv[1][j] + Yr[i][2] * P.Xinv[2][j];
      finite = finite && isfinite(R[i * 3 + j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = ry1[i] - (R[i * 3 + 0] * x0[0] + R[i * 3 + 1] * x0[1] + R[i * 3 + 2] * x0[2]);
    finite = finite && isfinite(t[i]);
  }
  return fourth_point_err(R, t, ok_l && finite, xq, yq);
}

// P4P: P3P for rows y[3][3] (bearings) and x[3][3], its 4 candidates
// disambiguated by the 4th point (xq, yq), each scored as soon as it is
// solved; a strictly smaller error replaces the best (the first minimum, as
// torch.argmin). Unrolled, with every array indexed by constants: nothing
// lives in local memory. Writes the best (R, t) — identity and 0 where none
// is good — and returns whether one is.
__device__ inline bool p4p(const float y[3][3], const float x[3][3], const float* xq,
                           const float* yq, float R[9], float t[3]) {
  P3pPrefix P;
  p3p_prefix(y, x, P);
  float best_err = INFINITY;
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = (k % 4 == 0) ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float Rq[9], tq[3];
    const float err = p3p_candidate(P, x[0], q >> 1, q & 1, xq, yq, Rq, tq);
    if (err < best_err) {
      best_err = err;
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rq[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = tq[k];
    }
  }
  return isfinite(best_err);
}

// The rows of hypothesis id[0..3] from the staged points sx [N, 3] and sy
// [N, 2]: bearings y (z = 1) and model points x of points id[0..2]; false
// (and nothing read) where an index lies outside [0, N).
__device__ __forceinline__ bool gather_rows(const float* sx, const float* sy, int N,
                                            const int id[4], float y[3][3], float x[3][3]) {
  if (min(min(id[0], id[1]), min(id[2], id[3])) < 0 ||
      max(max(id[0], id[1]), max(id[2], id[3])) >= N)
    return false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    y[r][0] = sy[id[r] * 2 + 0];
    y[r][1] = sy[id[r] * 2 + 1];
    y[r][2] = 1.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) x[r][k] = sx[id[r] * 3 + k];
  }
  return true;
}

// P3P's pose for one RANSAC hypothesis against the staged points sx [N, 3]
// (preconditioned) and sy [N, 2]: `p4p` on points id[0..3]. Writes R
// (row-major 3x3) and t — identity and 0 where it failed — and returns ok.
// An index outside [0, N) fails the hypothesis rather than reading outside
// the staged points.
__device__ inline bool solve_pose(const float* sx, const float* sy, int N, const int id[4],
                                  float R[9], float t[3]) {
  float yb[3][3], xb[3][3];
  if (!gather_rows(sx, sy, N, id, yb, xb)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = (k % 4 == 0) ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = 0.f;
    return false;
  }
  return p4p(yb, xb, sx + id[3] * 3, sy + id[3] * 2, R, t);
}

// Whether staged point n is an inlier of pose (R, t): its squared
// normalized reprojection error under thr_sq, z > 0, valid (smk[n] != 0).
__device__ __forceinline__ bool is_inlier(const float* sx, const float* sy, const float* smk,
                                          int n, const float R[9], const float t[3],
                                          float thr_sq) {
  const float* xn = sx + n * 3;
  const float px = xn[0] * R[0] + xn[1] * R[1] + xn[2] * R[2] + t[0];
  const float py = xn[0] * R[3] + xn[1] * R[4] + xn[2] * R[5] + t[1];
  const float pz = xn[0] * R[6] + xn[1] * R[7] + xn[2] * R[8] + t[2];
  const float iz = 1.f / nz(pz);
  const float du = px * iz - sy[n * 2 + 0];
  const float dv = py * iz - sy[n * 2 + 1];
  const float err = pz > 0.f ? du * du + dv * dv : INFINITY;
  return err < thr_sq && smk[n] != 0.f;
}

// The inlier count of pose (R, t) over all N staged points, one after another.
__device__ inline int count_inliers(const float* sx, const float* sy, const float* smk, int N,
                                    const float R[9], const float t[3], float thr_sq) {
  int cnt = 0;
  for (int n = 0; n < N; ++n) cnt += is_inlier(sx, sy, smk, n, R, t, thr_sq) ? 1 : 0;
  return cnt;
}

}  // namespace suo_pnp
