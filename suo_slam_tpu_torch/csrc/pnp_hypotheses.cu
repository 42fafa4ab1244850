// K3 — PnP RANSAC hypotheses: LambdaTwist P3P on 4 sampled points,
// disambiguated by the 4th, then the inlier count of every hypothesis.
//
// Replaces `suo_slam_tpu/solvers/p3p.py` `p3p` / `p4p` (vmapped over the
// hypotheses) and the `count_inliers` stage of `solvers/pnp.py`
// `pnp_ransac`. On the TPU these are [O, n_hyp]-wide `where`-masked vector
// programs; here one thread owns one (object, hypothesis) and runs the
// solver as scalar code in registers, mirroring `solvers/p3p.py` operation
// by operation (same Newton trip counts, same guards, same failure contract:
// identity pose and ok = 0). The argmax over hypotheses, the two Gauss-Newton
// refines and the final gate stay in PyTorch (`solvers/pnp.py`).
//
// Bound on this card: latency. At the main path's shapes (O = 8 objects,
// n_hyp = 64, N = 41 points) the whole input is 8 x 41 x 24 B = 8 KB and the
// work ~8 x 64 x (~3k flops of P3P + 41 x ~15 flops of counting) ~ 2 MFLOP,
// i.e. well under a microsecond of either bytes or flops; one launch per
// view, so it costs its launch and one wave of 8 blocks. Design: one block
// per object stages that object's points in shared memory; each thread
// solves its hypothesis and counts against the staged points.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCubicIters = 50;
constexpr int kRefineIters = 5;
constexpr float kTiny = 1e-30f;
constexpr float kThird = 1.f / 3.f;  // x * (1/3), as solvers/p3p.py writes it

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

__device__ float cubick(float b, float c, float d) {
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
  for (int it = 0; it < kCubicIters; ++it) {
    const float fx = ((r + b) * r + c) * r + d;
    const float fpx = nz((3.f * r + 2.f * b) * r + c);
    r = r - fx / fpx;
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

__device__ void refine_L(float& l1, float& l2, float& l3, float a12, float a13,
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

// P3P for rows y[3][3] (bearings) and x[3][3]: 4 candidate (R, t, ok).
__device__ void p3p(const float y[3][3], const float x[3][3], float Rs[4][9],
                    float ts[4][3], bool valid[4]) {
  float y1[3], y2[3], y3[3];
  {
    const float n1 = sqrtf(dot3(y[0], y[0]));
    const float n2 = sqrtf(dot3(y[1], y[1]));
    const float n3 = sqrtf(dot3(y[2], y[2]));
    for (int k = 0; k < 3; ++k) {
      y1[k] = y[0][k] / n1; y2[k] = y[1][k] / n2; y3[k] = y[2][k] / n3;
    }
  }
  const float b12 = -2.f * dot3(y1, y2);
  const float b13 = -2.f * dot3(y1, y3);
  const float b23 = -2.f * dot3(y2, y3);
  float d12[3], d13[3], d23[3], d12xd13[3];
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
  if (fabsf(e1) < fabsf(e2)) { const float t = e1; e1 = e2; e2 = t; }
  const float mx0011 = -A00 * A11;
  const float prec_0 = A01 * A12 - A02 * A11;
  const float prec_1 = A01 * A02 - A00 * A12;
  float v1[3], v2[3];
  eigvec(e1, A00, A02, A11, A12, mx0011, x01_sq, prec_0, prec_1, v1);
  eigvec(e2, A00, A02, A11, A12, mx0011, x01_sq, prec_0, prec_1, v2);
  const float L0 = nz(e1);
  const float v = sqrtf(clamp0(-e2 / L0));

  // 4 lambda candidates: two signs of v, two quadratic roots each
  float Ls[4][3];
  bool oks[4];
  for (int sgn = 0; sgn < 2; ++sgn) {
    const float s = sgn == 0 ? v : -v;
    const float w2 = 1.f / nz(s * v2[0] - v1[0]);
    const float w0 = (v1[1] - s * v2[1]) * w2;
    const float w1 = (v1[2] - s * v2[2]) * w2;
    const float a = 1.f / nz((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12);
    const float b = (a13 * b12 * w1 - a12 * b13 * w0 - 2.f * w0 * w1 * (a12 - a13)) * a;
    const float c = ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13) * a;
    float tau[2];
    bool real;
    root2real(b, c, tau[0], tau[1], real);
    for (int r = 0; r < 2; ++r) {
      const bool tau_ok = tau[r] > 0.f;
      const float ts_ = tau_ok ? tau[r] : 1.f;
      const float d_ = a23 / (ts_ * (b23 + ts_) + 1.f);
      const float l2 = sqrtf(clamp0(d_));
      const float l3 = ts_ * l2;
      const float l1 = w0 * l2 + w1 * l3;
      const int q = sgn * 2 + r;
      Ls[q][0] = l1; Ls[q][1] = l2; Ls[q][2] = l3;
      oks[q] = real && tau_ok && (d_ > 0.f) && (l1 >= 0.f);
    }
  }

  // closed-form inverse of X = [d12 | d13 | d12xd13] (columns)
  const float Xr[3][3] = {{d12[0], d13[0], d12xd13[0]},
                          {d12[1], d13[1], d12xd13[1]},
                          {d12[2], d13[2], d12xd13[2]}};
  float c0[3], c1[3], c2[3];
  cross3(Xr[1], Xr[2], c0);
  cross3(Xr[2], Xr[0], c1);
  cross3(Xr[0], Xr[1], c2);
  const float idet = 1.f / nz(dot3(Xr[0], c0));
  float Xinv[3][3];
  for (int i = 0; i < 3; ++i) {
    Xinv[i][0] = c0[i] * idet; Xinv[i][1] = c1[i] * idet; Xinv[i][2] = c2[i] * idet;
  }

  for (int q = 0; q < 4; ++q) {
    float l1 = Ls[q][0], l2 = Ls[q][1], l3 = Ls[q][2];
    refine_L(l1, l2, l3, a12, a13, a23, b12, b13, b23);
    float ry1[3], ry2[3], ry3[3], yd1[3], yd2[3], yd1xd2[3];
    for (int k = 0; k < 3; ++k) {
      ry1[k] = y1[k] * l1; ry2[k] = y2[k] * l2; ry3[k] = y3[k] * l3;
      yd1[k] = ry1[k] - ry2[k]; yd2[k] = ry1[k] - ry3[k];
    }
    cross3(yd1, yd2, yd1xd2);
    const float Yr[3][3] = {{yd1[0], yd2[0], yd1xd2[0]},
                            {yd1[1], yd2[1], yd1xd2[1]},
                            {yd1[2], yd2[2], yd1xd2[2]}};
    float R[9], t[3];
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        R[i * 3 + j] = Yr[i][0] * Xinv[0][j] + Yr[i][1] * Xinv[1][j] + Yr[i][2] * Xinv[2][j];
        finite = finite && isfinite(R[i * 3 + j]);
      }
    }
    for (int i = 0; i < 3; ++i) {
      t[i] = ry1[i] - (R[i * 3 + 0] * x[0][0] + R[i * 3 + 1] * x[0][1] + R[i * 3 + 2] * x[0][2]);
      finite = finite && isfinite(t[i]);
    }
    const bool ok = oks[q] && finite;
    for (int k = 0; k < 9; ++k) Rs[q][k] = ok ? R[k] : ((k % 4 == 0) ? 1.f : 0.f);
    for (int k = 0; k < 3; ++k) ts[q][k] = ok ? t[k] : 0.f;
    valid[q] = ok;
  }
}

__global__ void pnp_hypotheses_kernel(const float* __restrict__ xp,
                                      const float* __restrict__ yn,
                                      const uint8_t* __restrict__ mask,
                                      const int* __restrict__ idx, int N,
                                      int H, float thr_sq,
                                      float* __restrict__ T_out,
                                      uint8_t* __restrict__ ok_out,
                                      int* __restrict__ count_out) {
  extern __shared__ float sm[];
  float* sx = sm;             // [N, 3]
  float* sy = sm + 3 * N;     // [N, 2]
  float* smk = sm + 5 * N;    // [N]
  const int o = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = xp[((long long)o * N + n) * 3 + k];
    for (int k = 0; k < 2; ++k) sy[n * 2 + k] = yn[((long long)o * N + n) * 2 + k];
    smk[n] = mask[(long long)o * N + n] ? 1.f : 0.f;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int* id = idx + ((long long)o * H + h) * 4;
    float* To = T_out + ((long long)o * H + h) * 16;
    if (min(min(id[0], id[1]), min(id[2], id[3])) < 0 ||
        max(max(id[0], id[1]), max(id[2], id[3])) >= N) {
      // an index outside the point set: a failed hypothesis (identity,
      // ok = 0, count -1) rather than a read outside the staged points
      for (int k = 0; k < 16; ++k) To[k] = (k % 5 == 0) ? 1.f : 0.f;
      ok_out[(long long)o * H + h] = 0;
      count_out[(long long)o * H + h] = -1;
      continue;
    }
    float yb[3][3], xb[3][3];
    for (int r = 0; r < 3; ++r) {
      yb[r][0] = sy[id[r] * 2 + 0];
      yb[r][1] = sy[id[r] * 2 + 1];
      yb[r][2] = 1.f;
      for (int k = 0; k < 3; ++k) xb[r][k] = sx[id[r] * 3 + k];
    }
    float Rs[4][9], ts[4][3];
    bool valid[4];
    p3p(yb, xb, Rs, ts, valid);

    // disambiguate by the 4th point
    const float* xq = sx + id[3] * 3;
    const float* yq = sy + id[3] * 2;
    int best = 0;
    float best_err = INFINITY;
    for (int q = 0; q < 4; ++q) {
      const float* R = Rs[q];
      float xr[3];
      for (int i = 0; i < 3; ++i)
        xr[i] = R[i * 3 + 0] * xq[0] + R[i * 3 + 1] * xq[1] + R[i * 3 + 2] * xq[2] + ts[q][i];
      const bool z_ok = xr[2] > 0.f;
      const float iz = 1.f / nz(xr[2]);
      const float du = xr[0] * iz - yq[0];
      const float dv = xr[1] * iz - yq[1];
      const float e = du * du + dv * dv;
      float dev = 0.f;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          const float rtr = R[0 * 3 + i] * R[0 * 3 + j] + R[1 * 3 + i] * R[1 * 3 + j] + R[2 * 3 + i] * R[2 * 3 + j];
          dev = fmaxf(dev, fabsf(rtr - (i == j ? 1.f : 0.f)));
        }
      }
      const bool good = valid[q] && z_ok && (dev < 1e-2f) && isfinite(e);
      const float err = good ? e : INFINITY;
      if (err < best_err) { best_err = err; best = q; }
    }
    const bool ok = isfinite(best_err);
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = ok ? Rs[best][k] : ((k % 4 == 0) ? 1.f : 0.f);
    for (int k = 0; k < 3; ++k) t[k] = ok ? ts[best][k] : 0.f;

    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) To[i * 4 + j] = R[i * 3 + j];
      To[i * 4 + 3] = t[i];
    }
    To[12] = 0.f; To[13] = 0.f; To[14] = 0.f; To[15] = 1.f;
    ok_out[(long long)o * H + h] = ok ? 1 : 0;

    // inliers: squared normalized reprojection error under thr, z > 0
    int cnt = 0;
    for (int n = 0; n < N; ++n) {
      const float* xn = sx + n * 3;
      const float px = xn[0] * R[0] + xn[1] * R[1] + xn[2] * R[2] + t[0];
      const float py = xn[0] * R[3] + xn[1] * R[4] + xn[2] * R[5] + t[1];
      const float pz = xn[0] * R[6] + xn[1] * R[7] + xn[2] * R[8] + t[2];
      const float iz = 1.f / nz(pz);
      const float du = px * iz - sy[n * 2 + 0];
      const float dv = py * iz - sy[n * 2 + 1];
      const float err = pz > 0.f ? du * du + dv * dv : INFINITY;
      cnt += (err < thr_sq && smk[n] != 0.f) ? 1 : 0;
    }
    count_out[(long long)o * H + h] = ok ? cnt : -1;
  }
}

}  // namespace

extern "C" int suo_pnp_hypotheses(const void* xp, const void* yn,
                                  const void* mask, const void* idx, int O,
                                  int N, int H, float thr_sq, void* T_out,
                                  void* ok_out, void* count_out, void* stream) {
  if (O > 0 && H > 0) {
    const int threads = H >= 128 ? 128 : ((H + 31) / 32) * 32;
    const size_t shmem = (size_t)6 * N * sizeof(float);
    pnp_hypotheses_kernel<<<O, threads, shmem, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)yn, (const uint8_t*)mask,
        (const int*)idx, N, H, thr_sq, (float*)T_out, (uint8_t*)ok_out,
        (int*)count_out);
  }
  return (int)cudaGetLastError();
}
