// K7 — the camera-block part of bundle adjustment's Schur-complement solve:
// LM damping, the freeze masks and Jacobi scaling of the normal equations,
// the 6x6 Cholesky factor of every camera block, the two triangular solves
// against [Hco_s | gc_s], the reduction to the objects' 6O x 6O Schur system,
// and, after that system is solved, the cameras' back-substitution.
//
// Replaces the camera elimination of `suo_slam_tpu/solvers/ba.py`
// `_solve_normal_eq_schur` (`:267-368`), which on the TPU is a batched
// `lax.linalg.cholesky` + two batched `triangular_solve`s over a merged
// [V, 6, 6O+1] right-hand side and two einsums. Three entry points:
//
//   suo_ba_schur_cams   one block per camera v: damp, mask and scale Hcc[v]
//       (and, in every block, the objects' scales io; block 0 also writes
//       Hoo_s and go_s), factor Lc[v] = chol(sym(Hcc_s[v])) in shared
//       memory (NaN factor when not positive definite, as
//       `jax.lax.linalg.cholesky` gives it), then one thread per column of
//       [Hco_s[v] | gc_s[v]] solves Lc Lc^T x = column -> X[v] [6, 6O+1].
//       With with_objects = 0 (tracking: every object frozen, so Hco_s = 0
//       and d_obj = 0) it solves Lc Lc^T d = -gc_s at once and writes the
//       camera step d_cam = d * ic * mc: the whole solve is this one launch.
//   suo_ba_schur_reduce one thread per entry of
//       S = blockdiag(Hoo_s) - sum_v Hco_s[v]^T X[v] + 1e-9 I   [6O, 6O]
//       b = -go_s + sum_v Hco_s[v]^T y_c[v]                      [6O]
//       summed over v (then the 6 rows) in a fixed order, no atomics, so
//       the result repeats run to run.
//   suo_ba_schur_back   one thread per camera: rhs = -gc_s - Hco_s d_obj_s,
//       d_cam = (Lc^-T Lc^-1 rhs) * ic * mc from the stored factor.
// The reduced 6O x 6O system between reduce and back stays on
// torch.linalg.cholesky_ex + solve_triangular (`solvers/ba.py`), as the JAX
// package leaves it to XLA.
//
// Bound on this card: latency. At the SLAM path's shapes (global BA: V = 32
// cameras, O = 8 objects; tracking: V = 1) the inputs are < 80 KB and the
// work ~V x (200 flops of factor + 49 columns x 72 flops of solves) plus
// (48^2 + 48) x V x 12 flops of reduction = ~1.3 MFLOP: far below one
// launch either way. Design: no launch per 6x6 operation (the plain version
// issues ~40 small PyTorch operations per solve), everything in registers
// and shared memory, compiled with --fmad=false.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCamThreads = 64;
constexpr int kReduceThreads = 256;
constexpr int kBackThreads = 32;

// max(x, lo) that keeps NaN, like torch.clamp
__device__ __forceinline__ float clampmin(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// 6x6 lower Cholesky factor of sym(A) (row-major), unblocked as LAPACK's
// potf2; a pivot that is not > 0 (or NaN) makes the whole factor NaN.
__device__ void chol6(const float* A, float* L) {
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
__device__ __forceinline__ float damp_mask(const float* H, int i, int j, float lam,
                                           float m) {
  const float d = clampmin(H[i * 6 + i], 1e-9f);
  const float hd = H[i * 6 + j] + lam * d * (i == j ? 1.f : 0.f);
  return hd * m + (1.f - m) * (i == j ? 1.f : 0.f);
}

__global__ void __launch_bounds__(kCamThreads)
ba_schur_kernel_cams(const float* __restrict__ Hcc, const float* __restrict__ Hoo,
                     const float* __restrict__ Hco, const float* __restrict__ gc,
                     const float* __restrict__ go, const uint8_t* __restrict__ cam_free,
                     const uint8_t* __restrict__ obj_free, const float* __restrict__ lam_p,
                     int V, int O, int with_objects, float* __restrict__ Lc_out,
                     float* __restrict__ ic_out, float* __restrict__ io_out,
                     float* __restrict__ Hoo_s, float* __restrict__ go_s,
                     float* __restrict__ Hco_s, float* __restrict__ gc_s,
                     float* __restrict__ X, float* __restrict__ d_cam) {
  extern __shared__ float io[];  // [O * 6] objects' Jacobi scales
  __shared__ float L[36], ic[6], gs[6];
  const int v = blockIdx.x;
  const float lam = *lam_p;
  const float mc = cam_free[v] ? 1.f : 0.f;
  const float* H = Hcc + (long long)v * 36;

  if (with_objects) {
    for (int r = threadIdx.x; r < O * 6; r += blockDim.x) {
      const int o = r / 6, a = r % 6;
      const float mo = obj_free[o] ? 1.f : 0.f;
      const float dd = damp_mask(Hoo + (long long)o * 36, a, a, lam, mo);
      io[r] = 1.f / sqrtf(clampmin(dd, 1e-12f));
    }
  }
  if (threadIdx.x == 0) {
    float Hs[36];
    for (int i = 0; i < 6; ++i)
      ic[i] = 1.f / sqrtf(clampmin(damp_mask(H, i, i, lam, mc), 1e-12f));
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j)
        Hs[i * 6 + j] = damp_mask(H, i, j, lam, mc) * ic[i] * ic[j] + (i == j ? 1e-9f : 0.f);
    chol6(Hs, L);
    for (int i = 0; i < 6; ++i) gs[i] = gc[(long long)v * 6 + i] * mc * ic[i];
  }
  __syncthreads();

  if (!with_objects) {
    if (threadIdx.x == 0) {
      float b[6], x[6];
      for (int i = 0; i < 6; ++i) b[i] = -gs[i];
      cho_solve6(L, b, x);
      for (int i = 0; i < 6; ++i) d_cam[(long long)v * 6 + i] = x[i] * ic[i] * mc;
    }
    return;
  }

  if (threadIdx.x < 36) Lc_out[(long long)v * 36 + threadIdx.x] = L[threadIdx.x];
  if (threadIdx.x < 6) {
    ic_out[(long long)v * 6 + threadIdx.x] = ic[threadIdx.x];
    gc_s[(long long)v * 6 + threadIdx.x] = gs[threadIdx.x];
  }
  if (v == 0) {
    for (int r = threadIdx.x; r < O * 36; r += blockDim.x) {
      const int o = r / 36, a = (r / 6) % 6, b = r % 6;
      const float mo = obj_free[o] ? 1.f : 0.f;
      Hoo_s[r] = damp_mask(Hoo + (long long)o * 36, a, b, lam, mo) * io[o * 6 + a] * io[o * 6 + b];
    }
    for (int r = threadIdx.x; r < O * 6; r += blockDim.x) {
      const float mo = obj_free[r / 6] ? 1.f : 0.f;
      io_out[r] = io[r];
      go_s[r] = go[r] * mo * io[r];
    }
  }
  // one thread per column c of [Hco_s[v] | gc_s[v]]: column (o, a) holds
  // Hco_s[v, o, :, a]
  const int C = 6 * O + 1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float b[6], x[6];
    if (c < 6 * O) {
      const int o = c / 6, a = c % 6;
      const float mo = obj_free[o] ? 1.f : 0.f;
      const float* Hvo = Hco + ((long long)v * O + o) * 36;
      float* Hs = Hco_s + ((long long)v * O + o) * 36;
      for (int i = 0; i < 6; ++i) {
        b[i] = Hvo[i * 6 + a] * mc * mo * ic[i] * io[o * 6 + a];
        Hs[i * 6 + a] = b[i];
      }
    } else {
      for (int i = 0; i < 6; ++i) b[i] = gs[i];
    }
    cho_solve6(L, b, x);
    for (int i = 0; i < 6; ++i) X[((long long)v * 6 + i) * C + c] = x[i];
  }
}

__global__ void __launch_bounds__(kReduceThreads)
ba_schur_kernel_reduce(const float* __restrict__ Hoo_s, const float* __restrict__ go_s,
                       const float* __restrict__ Hco_s, const float* __restrict__ X,
                       int V, int O, float* __restrict__ S, float* __restrict__ bvec) {
  const int n = 6 * O, C = 6 * O + 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n * n) {
    const int r = t / n, q = t % n;
    const int o = r / 6, a = r % 6, p = q / 6, b = q % 6;
    float acc = 0.f;
    for (int v = 0; v < V; ++v) {
      const float* Hs = Hco_s + ((long long)v * O + o) * 36;
      const float* Xv = X + (long long)v * 6 * C;
      for (int i = 0; i < 6; ++i) acc += Hs[i * 6 + a] * Xv[i * C + q];
    }
    float s = -acc;
    if (o == p) s += Hoo_s[(long long)o * 36 + a * 6 + b];
    if (r == q) s += 1e-9f;
    S[t] = s;
  } else if (t < n * n + n) {
    const int r = t - n * n;
    const int o = r / 6, a = r % 6;
    float acc = 0.f;
    for (int v = 0; v < V; ++v) {
      const float* Hs = Hco_s + ((long long)v * O + o) * 36;
      const float* Xv = X + (long long)v * 6 * C;
      for (int i = 0; i < 6; ++i) acc += Hs[i * 6 + a] * Xv[i * C + n];
    }
    bvec[r] = -go_s[r] + acc;
  }
}

__global__ void __launch_bounds__(kBackThreads)
ba_schur_kernel_back(const float* __restrict__ Lc, const float* __restrict__ ic,
                     const uint8_t* __restrict__ cam_free, const float* __restrict__ Hco_s,
                     const float* __restrict__ gc_s, const float* __restrict__ d_obj_s,
                     int V, int O, float* __restrict__ d_cam) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float L[36], b[6], x[6];
  for (int i = 0; i < 36; ++i) L[i] = Lc[(long long)v * 36 + i];
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int o = 0; o < O; ++o) {
      const float* Hs = Hco_s + ((long long)v * O + o) * 36;
      for (int c = 0; c < 6; ++c) acc += Hs[i * 6 + c] * d_obj_s[o * 6 + c];
    }
    b[i] = -gc_s[(long long)v * 6 + i] - acc;
  }
  cho_solve6(L, b, x);
  const float mc = cam_free[v] ? 1.f : 0.f;
  for (int i = 0; i < 6; ++i) d_cam[(long long)v * 6 + i] = x[i] * ic[(long long)v * 6 + i] * mc;
}

}  // namespace

extern "C" int suo_ba_schur_cams(const void* Hcc, const void* Hoo, const void* Hco,
                                 const void* gc, const void* go, const void* cam_free,
                                 const void* obj_free, const void* lam, int V, int O,
                                 int with_objects, void* Lc, void* ic, void* io,
                                 void* Hoo_s, void* go_s, void* Hco_s, void* gc_s,
                                 void* X, void* d_cam, void* stream) {
  if (V > 0) {
    const size_t shmem = (size_t)6 * (O > 0 ? O : 1) * sizeof(float);
    ba_schur_kernel_cams<<<V, kCamThreads, shmem, (cudaStream_t)stream>>>(
        (const float*)Hcc, (const float*)Hoo, (const float*)Hco, (const float*)gc,
        (const float*)go, (const uint8_t*)cam_free, (const uint8_t*)obj_free,
        (const float*)lam, V, O, with_objects, (float*)Lc, (float*)ic, (float*)io,
        (float*)Hoo_s, (float*)go_s, (float*)Hco_s, (float*)gc_s, (float*)X,
        (float*)d_cam);
  }
  return (int)cudaGetLastError();
}

extern "C" int suo_ba_schur_reduce(const void* Hoo_s, const void* go_s, const void* Hco_s,
                                   const void* X, int V, int O, void* S, void* b,
                                   void* stream) {
  const int n = 6 * O;
  const int total = n * n + n;
  if (total > 0) {
    ba_schur_kernel_reduce<<<(total + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                             0, (cudaStream_t)stream>>>(
        (const float*)Hoo_s, (const float*)go_s, (const float*)Hco_s, (const float*)X, V, O,
        (float*)S, (float*)b);
  }
  return (int)cudaGetLastError();
}

extern "C" int suo_ba_schur_back(const void* Lc, const void* ic, const void* cam_free,
                                 const void* Hco_s, const void* gc_s, const void* d_obj_s,
                                 int V, int O, void* d_cam, void* stream) {
  if (V > 0) {
    ba_schur_kernel_back<<<(V + kBackThreads - 1) / kBackThreads, kBackThreads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)Lc, (const float*)ic, (const uint8_t*)cam_free, (const float*)Hco_s,
        (const float*)gc_s, (const float*)d_obj_s, V, O, (float*)d_cam);
  }
  return (int)cudaGetLastError();
}
