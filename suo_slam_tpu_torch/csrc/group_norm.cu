// K20 — GroupNorm + ReLU forward, and K21 — its backward, f32 or bf16
// activations in NHWC memory.
//
// Replace `suo_slam_tpu/models/hourglass.py` `Norm(kind="group")`
// (`:104-111`: flax's `GroupNorm(num_groups=g, epsilon=1e-6)` on f32(x), cast
// back) with the `nn.relu` that follows every norm of the net, and the
// gradient XLA derives for the pair. Per sample n and group k (C / G
// consecutive channels), over H x W x C / G values, M of them:
//   mean = sum x / M,  var = max(sum x^2 / M - mean^2, 0),  rstd = 1 / sqrt(var + eps)
//   y = relu(cast((x - mean) * (rstd * scale[c]) + bias[c]))
// flax's order of operations (its fast variance; the product rstd * scale
// rounded, then (x - mean) * that, then + bias, each rounded in f32). The
// sums are f64 partials (an f32 value and its square are exact in f64, so
// their order moves only the last bits of the f64 result), mean, var and
// rstd are f64 rounded once to f32 — flax sums in f32, so the two agree to
// f32 rounding.
//
// K21: with g = dy * [y > 0] (the mask recomputed from x with K20's exact
// arithmetic), xc = x - mean and h = scale[c] * g (f32):
//   dbias[c]  = sum over n, pixels of g
//   dscale[c] = sum over n of rstd[n, k] * sum over pixels of g * xc
//   dx = rstd (h - hbar[n, k]) - xc Q[n, k]
//   hbar = sum_group(h) / M,  Q = rstd^3 * sum_group(h xc) / M
// cast once to x's dtype. h - hbar is the mean-free gradient autodiff forms:
// in a group of one value it is exactly 0, as in JAX's gradient.
//
// Bound on this card: bytes. K20 must read x and write y; K21 must read x
// and dy and write dx (at [32, 256, 64, 64] bf16: 40.1 and 60.1 us at
// 3.35 TB/s).
//
// Two designs, chosen by shape (`hourglass.plan_gn`); every kernel's name
// starts with `gn_`.
//
// "cluster" (every shape whose pixel holds at most kGThreads channel
// vectors: all of the net's): one launch per call. GroupNorm's statistics
// are per sample, so each sample is reduced inside a thread-block cluster
// of k CTAs (`hourglass.plan_gn`: k from 1 to 16, grown until the sample's
// slice fits a CTA's shared memory or the clusters fill the card), CTA
// `rank` taking pixels [rank * ceil(HW / k), ...) of it; a small sample
// takes k = 1, and `spp` samples share a CTA, a team of kGThreads / spp
// threads each, with no cluster barrier at all. The grid is persistent: it
// holds as many CTA rows as the card runs at once, and row r takes the
// blocks of spp samples r, r + rows, ... in turn. A thread owns one 16-byte
// vector of channels (one value where C or the pointers do not allow it)
// and every lanes_p-th pixel of its slice. Its first `keep` pixels of a
// sample live in a ring of `slots` pixels in shared memory, copied there by
// cp.async (kKeepBatch pixels a group) as soon as their slots are free, so
// the next sample's copies fly while the current one is reduced and
// written; the rest (the tail) is loaded into registers kTailUnroll pixels
// at a time, addresses first and the loads in one straight run. Phase one
// adds the tail, then the kept pixels as they land, f64 per value, as the
// plain versions sum (K20: x and x^2; K21: g and g * xc, with g = dy [y >
// 0] by K20's exact arithmetic): f32 runs folded into f64 moved the last bit
// of statistics and dx coefficients, which the ill-conditioned bf16 train
// step does not absorb. The team folds its pixel lanes (warp shuffles, then
// rows in order through shared memory) into a per-channel row, then
// per-group partials (K21: weighted by scale), in one of two buffers that
// alternate with the samples. With k > 1 a cluster barrier follows, and
// every CTA reads the k ranks' group partials through distributed shared
// memory (every rank's loads issued together, then added in rank order),
// so all take the same statistics: K20's mean and rstd (f64, rounded once
// to f32; rank 0 writes them), K21's hbar and Q. K21's CTA `rank` also sums
// channel block `rank` of the per-channel rows over the ranks and writes
// its block's (sum g, rstd * sum g xc) to the workspace; the last CTA to
// arrive at the block's counter (in the per-stream workspace, which every
// launch leaves at zero) sums the blocks' rows in a fixed order into dbias
// and dscale: no float atomics, so repeated calls give equal bits. The
// second pass (K20's apply, K21's dx) re-reads the tail from device memory
// walking it back (its last pixels, read last, are the likeliest still in
// L2), then the kept pixels from the ring, and writes with streaming
// stores. A cluster barrier's arrive after the last sample's remote reads
// and its wait at the end keep a CTA's shared memory alive while the
// others read it.
//
// "split" (the first design; wider pixels): K16 / K17's split layout
// with per-sample statistics. The partial pass runs a block per (span of
// one sample's pixels, sample); a thread walks kIters pixels of the span
// with f64 accumulators; the block sums its pixel lanes in shared memory in
// a fixed order and writes one f64 pair per channel. The finalize sums a
// group's channels and spans on one warp in a fixed order. The apply and dx
// passes read x (and dy) again. Launches: K20 three (partial, finalize,
// apply), K21 four (partial, the per-sample finalize, the per-channel one,
// dx).
//
// With `cycles` (int64 [CTAs, phases], zeros) thread 0 of each cluster
// design CTA adds its SM clock cycles per phase (`hourglass.GN_FWD_PHASES`,
// `GN_BWD_PHASES`) to its CTA's row (blockIdx.y * k + rank).

#include <cooperative_groups.h>

#include "channel_vec.cuh"

namespace {

// K20's pre-activation ((x - mean) * mul) + bias, each operation rounded in
// f32, and its value in the storage dtype before the ReLU
__device__ __forceinline__ float pre_act(float xc, float mul, float bias) {
  return __fadd_rn(__fmul_rn(xc, mul), bias);
}
template <typename T>
__device__ __forceinline__ T pre_relu(float xc, float mul, float bias) {
  return from_f<T>(pre_act(xc, mul, bias));
}

// Partial sums of one span of sample n's HW pixels (block (span, n)), s1 and
// s2 per channel into part[((n * spans + span) * C + c) * 2 + {0, 1}].
// kMode 0 (K20): s1 = sum x, s2 = sum x^2.
// kMode 1 (K21): s1 = sum g, s2 = sum g * (x - mean).
template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ mean, const float* __restrict__ rstd, long long HW,
               int C, int G, double* __restrict__ part) {
  const Layout L(C, V);
  const int t = threadIdx.x, sub = t / L.lanes_c, jl = t % L.lanes_c;
  const int n = blockIdx.y, cpg = C / G;
  const long long p0 = blockIdx.x * L.pixels_per_block();
  const long long p1 = p0 + L.pixels_per_block() < HW ? p0 + L.pixels_per_block() : HW;
  const long long base = (long long)n * HW * C;
  double* out = part + ((long long)n * gridDim.x + blockIdx.x) * C * 2;
  __shared__ double red[2][kThreads];
  for (int jb = 0; jb < L.cv; jb += L.lanes_c) {  // channel-vector blocks when C / V > 256
    const int j = jb + jl;
    const bool active = sub < L.lanes_p && j < L.cv;
    double s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
    if (active) {
      float mu[V], mul[V], bs[V];
      if constexpr (kMode == 1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int c = j * V + k, q = n * G + c / cpg;
          mu[k] = mean[q];
          mul[k] = __fmul_rn(rstd[q], scale[c]);
          bs[k] = bias[c];
        }
      }
      for (long long p = p0 + sub; p < p1; p += L.lanes_p) {
        const long long i0 = base + p * C + (long long)j * V;
        const Vec<T, V> xv = load<T, V>(x + i0);
        if constexpr (kMode == 0) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const double v = (double)to_f(xv.v[k]);
            s1[k] += v;
            s2[k] += v * v;
          }
        } else {
          const Vec<T, V> dv = load<T, V>(dy + i0);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xc = __fsub_rn(to_f(xv.v[k]), mu[k]);
            const float g = to_f(pre_relu<T>(xc, mul[k], bs[k])) > 0.f ? to_f(dv.v[k]) : 0.f;
            s1[k] += (double)g;
            s2[k] += (double)g * (double)xc;
          }
        }
      }
    }
    // the block's pixel lanes, summed in lane order by lane 0
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][t] = s1[k];
      red[1][t] = s2[k];
      __syncthreads();
      if (sub == 0 && j < L.cv) {
        double a = red[0][t], b = red[1][t];
        for (int q = 1; q < L.lanes_p; ++q) {
          a += red[0][t + q * L.lanes_c];
          b += red[1][t + q * L.lanes_c];
        }
        out[(j * V + k) * 2] = a;
        out[(j * V + k) * 2 + 1] = b;
      }
      __syncthreads();
    }
  }
}

// a warp's two f64 sums, in a fixed tree (lane 0 holds them)
__device__ __forceinline__ void warp_sum(double& a, double& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
}

// K20's finalize: a warp per (n, k) sums its channels' partials of every
// span (lane l takes items l, l + 32, ...), then mean and rstd in f64,
// rounded once to f32
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const double* __restrict__ part, int spans, int N, long long HW, int C,
                      int G, double eps, float* __restrict__ mean, float* __restrict__ rstd) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;  // n * G + k
  if (q >= N * G) return;
  const int n = q / G, k = q - n * G, cpg = C / G;
  double a = 0.0, b = 0.0;
  for (int i = lane; i < spans * cpg; i += 32) {
    const int sp = i / cpg, c = k * cpg + (i - sp * cpg);
    const double* p = part + (((long long)n * spans + sp) * C + c) * 2;
    a += p[0];
    b += p[1];
  }
  warp_sum(a, b);
  if (lane != 0) return;
  const double M = (double)HW * cpg;
  const double mu = a / M;
  double v = b / M - mu * mu;
  v = v > 0.0 ? v : 0.0;
  mean[q] = (float)mu;
  rstd[q] = (float)(1.0 / sqrt(v + eps));
}

// K20's apply pass, a vector of V channels a thread
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ mean,
             const float* __restrict__ rstd, long long HW, int C, int G, long long n_vec,
             T* __restrict__ y) {
  const long long row = HW * C;
  const int cpg = C / G;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const long long i0 = v * V;
    const int n = (int)(i0 / row), c0 = (int)(i0 % C);
    const Vec<T, V> xv = load<T, V>(x + i0);
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = c0 + k, q = n * G + c / cpg;
      const float xc = __fsub_rn(to_f(xv.v[k]), mean[q]);
      const T z = pre_relu<T>(xc, __fmul_rn(rstd[q], scale[c]), bias[c]);
      out.v[k] = to_f(z) > 0.f ? z : from_f<T>(0.f);
    }
    store<T, V>(y + i0, out);
  }
}

// K21's per-sample finalize, a block per n: the per-channel sums over the
// spans (f64, into sums[n][c][2]), then per group hbar and Q (f32,
// coef[n][k][2])
__global__ void __launch_bounds__(kThreads)
gn_bwd_sample_kernel(const double* __restrict__ part, int spans, long long HW, int C, int G,
                  const float* __restrict__ scale, const float* __restrict__ rstd,
                  double* __restrict__ sums, float* __restrict__ coef) {
  const int n = blockIdx.x, cpg = C / G;
  double* sn = sums + (long long)n * C * 2;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    double a = 0.0, b = 0.0;
    for (int sp = 0; sp < spans; ++sp) {
      const double* p = part + (((long long)n * spans + sp) * C + c) * 2;
      a += p[0];
      b += p[1];
    }
    sn[c * 2] = a;
    sn[c * 2 + 1] = b;
  }
  __syncthreads();
  const double M = (double)HW * cpg;
  for (int k = threadIdx.x; k < G; k += kThreads) {
    double A = 0.0, B = 0.0;
    for (int i = 0; i < cpg; ++i) {
      const int c = k * cpg + i;
      A += sn[c * 2] * (double)scale[c];
      B += sn[c * 2 + 1] * (double)scale[c];
    }
    const double r = (double)rstd[n * G + k];
    coef[(n * G + k) * 2] = (float)(A / M);
    coef[(n * G + k) * 2 + 1] = (float)(r * r * r * B / M);
  }
}

// K21's per-channel finalize: dbias and dscale, summed over n in order
__global__ void __launch_bounds__(kThreads)
gn_bwd_channel_kernel(const double* __restrict__ sums, int N, int C, int G,
                   const float* __restrict__ rstd, float* __restrict__ dscale,
                   float* __restrict__ dbias) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = c / (C / G);
  double a = 0.0, b = 0.0;
  for (int n = 0; n < N; ++n) {
    a += sums[((long long)n * C + c) * 2];
    b += (double)rstd[n * G + k] * sums[((long long)n * C + c) * 2 + 1];
  }
  dbias[c] = (float)a;
  dscale[c] = (float)b;
}

// K21's dx pass: dx = rstd (scale g - hbar) - xc Q, one rounding to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ mean,
          const float* __restrict__ rstd, const float* __restrict__ coef, long long HW, int C,
          int G, long long n_vec, T* __restrict__ dx) {
  const long long row = HW * C;
  const int cpg = C / G;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const long long i0 = v * V;
    const int n = (int)(i0 / row), c0 = (int)(i0 % C);
    const Vec<T, V> xv = load<T, V>(x + i0);
    const Vec<T, V> dv = load<T, V>(dy + i0);
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = c0 + k, q = n * G + c / cpg;
      const float mul = __fmul_rn(rstd[q], scale[c]);
      const float xc = __fsub_rn(to_f(xv.v[k]), mean[q]);
      const float g = to_f(pre_relu<T>(xc, mul, bias[c])) > 0.f ? to_f(dv.v[k]) : 0.f;
      const float t = __fsub_rn(__fmul_rn(scale[c], g), coef[q * 2]);
      out.v[k] = from_f<T>(__fsub_rn(__fmul_rn(rstd[q], t), __fmul_rn(xc, coef[q * 2 + 1])));
    }
    store<T, V>(dx + i0, out);
  }
}

template <int V>
int spans_of(long long HW, int C) {
  const Layout L(C, V);
  return (int)((HW + L.pixels_per_block() - 1) / L.pixels_per_block());
}

template <typename T>
int spans_for(long long HW, int C, bool vec) {
  return vec ? spans_of<16 / sizeof(T)>(HW, C) : spans_of<1>(HW, C);
}

template <typename T, int V, int kMode>
void launch_partial(const void* x, const void* dy, const void* scale, const void* bias,
                    const void* mean, const void* rstd, int N, long long HW, int C, int G,
                    void* part, cudaStream_t s) {
  const dim3 grid((unsigned)spans_of<V>(HW, C), (unsigned)N);
  gn_partial_kernel<T, V, kMode><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)dy, (const float*)scale, (const float*)bias, (const float*)mean,
      (const float*)rstd, HW, C, G, (double*)part);
}

template <typename T>
int forward(const void* x, const void* scale, const void* bias, int N, long long HW, int C,
            int G, double eps, void* part, void* mean, void* rstd, void* y, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorizable<T>(C, {x, y});
  if (vec)
    launch_partial<T, V, 0>(x, nullptr, nullptr, nullptr, nullptr, nullptr, N, HW, C, G, part, s);
  else
    launch_partial<T, 1, 0>(x, nullptr, nullptr, nullptr, nullptr, nullptr, N, HW, C, G, part, s);
  const int warps = kThreads / 32;
  gn_stats_kernel<<<(N * G + warps - 1) / warps, kThreads, 0, s>>>(
      (const double*)part, spans_for<T>(HW, C, vec), N, HW, C, G, eps, (float*)mean,
      (float*)rstd);
  const long long n_val = (long long)N * HW * C;
  const int Vl = vec ? V : 1;
  const long long blocks = grid_of(n_val / Vl);
  if (vec)
    gn_apply_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (const float*)mean,
        (const float*)rstd, HW, C, G, n_val / V, (T*)y);
  else
    gn_apply_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (const float*)mean,
        (const float*)rstd, HW, C, G, n_val, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* dy, const void* scale, const void* bias,
             const void* mean, const void* rstd, int N, long long HW, int C, int G, void* part,
             void* sums, void* coef, void* dscale, void* dbias, void* dx, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorizable<T>(C, {x, dy, dx});
  if (vec)
    launch_partial<T, V, 1>(x, dy, scale, bias, mean, rstd, N, HW, C, G, part, s);
  else
    launch_partial<T, 1, 1>(x, dy, scale, bias, mean, rstd, N, HW, C, G, part, s);
  gn_bwd_sample_kernel<<<N, kThreads, 0, s>>>((const double*)part, spans_for<T>(HW, C, vec), HW, C,
                                           G, (const float*)scale, (const float*)rstd,
                                           (double*)sums, (float*)coef);
  gn_bwd_channel_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const double*)sums, N, C, G, (const float*)rstd, (float*)dscale, (float*)dbias);
  const long long n_val = (long long)N * HW * C;
  if (vec)
    gn_dx_kernel<T, V><<<(unsigned)grid_of(n_val / V), kThreads, 0, s>>>(
        (const T*)x, (const T*)dy, (const float*)scale, (const float*)bias, (const float*)mean,
        (const float*)rstd, (const float*)coef, HW, C, G, n_val / V, (T*)dx);
  else
    gn_dx_kernel<T, 1><<<(unsigned)grid_of(n_val), kThreads, 0, s>>>(
        (const T*)x, (const T*)dy, (const float*)scale, (const float*)bias, (const float*)mean,
        (const float*)rstd, (const float*)coef, HW, C, G, n_val, (T*)dx);
  return (int)cudaGetLastError();
}

bool valid(int N, long long HW, int C, int G) {
  return N > 0 && N <= 65535 && HW > 0 && C > 0 && G > 0 && C % G == 0;
}

// ============================================================ cluster design ==
namespace cg = cooperative_groups;

constexpr int kGThreads = 256;        // threads of a CTA
constexpr int kGMaxCluster = 16;      // CTAs of a cluster (above 8: a non-portable size)
constexpr int kGMaxTeams = 8;         // samples of a CTA (k = 1)
constexpr int kTailUnroll = 4;        // tail pixels a thread loads together
constexpr int kKeepBatch = 4;         // kept pixels in one cp.async group of a thread
constexpr int kGSumLoads = 8;         // K21's final sums: rows a lane loads together
constexpr int kGSmemBudget = 231424;  // dynamic shared memory of a CTA (227 KB less 1 KB)
constexpr unsigned kFull = 0xffffffffu;

// phases of `cycles` (hourglass.GN_FWD_PHASES / GN_BWD_PHASES)
enum GPhase { kGLoad, kGMath, kGFold, kGCluster, kGPass, kGFinal };
constexpr int kGFwdPhases = 5, kGBwdPhases = 6;

// A team's thread layout (`hourglass.plan_gn` mirrors it): tt threads, cv
// channel-vector lanes x lanes_p pixel lanes (team thread = sub * cv + jl);
// where cv divides 32 a warp holds q = 32 / cv pixel lanes of each vector
// and folds them by shuffles, leaving `rows` rows of per-channel sums.
struct GGeom {
  int cv, tt, lanes_p, q, rows;
  __host__ __device__ GGeom(int C, int V, int spp) {
    cv = C / V;
    tt = kGThreads / spp;
    lanes_p = tt / cv;
    q = (cv <= 32 && 32 % cv == 0) ? 32 / cv : 1;
    rows = q > 1 ? tt / 32 : lanes_p;
  }
};

// Byte offsets into a CTA's dynamic shared memory: the fold rows (at least
// kGThreads f64 pairs: the final sums reuse them), the per-channel rows and
// the group partials (f64 pairs, a set per team, two sets that alternate
// with the samples: the other CTAs of the cluster may still read the last
// sample's), the ring slots of x (and of dy), the group statistics (f32
// pairs, per team).
struct GLayout {
  long long red, crow, gpart, kx, kdy, gstat, total;
};

__host__ __device__ inline GLayout g_layout(const GGeom& g, int spp, int C, int G, int itemsize,
                                            int slots, bool bwd) {
  GLayout L;
  const long long pairs = (long long)spp * g.rows * C;
  L.red = 0;
  L.crow = 16 * (pairs > kGThreads ? pairs : kGThreads);
  L.gpart = L.crow + 32LL * spp * C;
  L.kx = L.gpart + 32LL * spp * G;
  const long long kb = (long long)spp * slots * g.lanes_p * C * itemsize;
  L.kdy = L.kx + kb;
  L.gstat = L.kdy + (bwd ? kb : 0);
  L.total = L.gstat + 8LL * spp * G;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most n of this thread's cp.async groups are in flight (more than
// 7: until 7 are)
__device__ __forceinline__ void cp_async_wait(long long n) {
  switch (n < 7 ? (int)n : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct GnArgs {
  const void* x;
  const void* dy;       // K21
  const float* scale;
  const float* bias;
  float* mean;          // [N, G]: K20 writes them, K21 reads them
  float* rstd;
  void* out;            // y (K20) or dx (K21)
  float* dscale;        // K21 [C]
  float* dbias;
  double* rows;         // K21 [blocks, C, 2] workspace
  unsigned* count;      // K21 [k] workspace counters: zeros, left zeros
  int N, C, G;
  long long HW;
  double eps;
  int k, spp, keep, slots;  // the plan
  long long* cycles;    // null or [CTA rows * k, phases]
};

// Whether the ReLU passes a pre-activation s: the cast to bf16 rounds s to a
// positive value exactly when s > 2^-134 (half the least bf16 subnormal
// rounds to even, to 0; NaN fails both), so relu_on<T>(s) ==
// (to_f(from_f<T>(s)) > 0) for every s, without the conversion
template <typename T>
__device__ __forceinline__ bool relu_on(float s) {
  if constexpr (sizeof(T) == 2) return s > 0x1p-134f;
  return s > 0.f;
}

// V f32 results rounded once to T (bf16 two at a time)
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> round_to(const float (&f)[V]) {
  Vec<T, V> o;
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int kk = 0; kk < V; kk += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[kk], f[kk + 1]);
      o.v[kk] = h.x;
      o.v[kk + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < V; ++kk) o.v[kk] = from_f<T>(f[kk]);
  }
  return o;
}

// One value's f64 terms: K20 x and x^2, K21 g and g * xc (exact products)
template <typename T, bool kBwd>
__device__ __forceinline__ void add_value(T xv, T dv, float mu, float mul, float bs, double& s1,
                                          double& s2) {
  if constexpr (!kBwd) {
    const double v = (double)to_f(xv);
    s1 += v;
    s2 = __fma_rn(v, v, s2);
  } else {
    const float xc = __fsub_rn(to_f(xv), mu);
    const float g = relu_on<T>(pre_act(xc, mul, bs)) ? to_f(dv) : 0.f;
    const double gd = (double)g;
    s1 += gd;
    s2 = __fma_rn(gd, (double)xc, s2);
  }
}

// K20 (kBwd false) and K21 in the cluster design: CTA (rank, row) of a grid
// (k, rows), clusters of k along x; CTA row `row` takes the blocks of spp
// samples row, row + rows, ... (see the top of this file).
template <typename T, int V, bool kBwd, bool kClock>
__device__ __forceinline__ void gn_cluster_body(const GnArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  constexpr int kPhases = kBwd ? kGBwdPhases : kGFwdPhases;
  const int C = a.C, G = a.G, cpg = C / G, k = a.k, spp = a.spp;
  const long long HW = a.HW;
  const int rank = (int)blockIdx.x, row0 = (int)blockIdx.y, P = (int)gridDim.y;
  const int t = threadIdx.x;
  const int blocks = (a.N + spp - 1) / spp;
  const int n_rows = row0 < blocks ? (blocks - 1 - row0) / P + 1 : 0;  // blocks this CTA takes
  Clk<kClock> clk(a.cycles ? a.cycles + ((long long)row0 * k + rank) * kPhases : nullptr);
  const GGeom g(C, V, spp);
  const GLayout L = g_layout(g, spp, C, G, (int)sizeof(T), a.slots, kBwd);
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* gstat = reinterpret_cast<float*>(smem + L.gstat);
  const int team = t / g.tt, tl = t % g.tt, sub = tl / g.cv, jl = tl % g.cv;
  const long long slice = (HW + k - 1) / k;
  const long long p0 = (long long)rank * slice < HW ? (long long)rank * slice : HW;
  const long long p1 = p0 + slice < HW ? p0 + slice : HW;
  // this thread's pixels of a sample: p0 + sub + i lanes_p, i < n_it; the
  // first nk in its ring of R slots in shared memory, the rest (the tail)
  // read from device memory in both passes
  const bool lane_on = sub < g.lanes_p && p0 + sub < p1;
  const int n_it = lane_on ? (int)((p1 - p0 - sub + g.lanes_p - 1) / g.lanes_p) : 0;
  const int nk = n_it < a.keep ? n_it : a.keep, R = a.slots;
  const long long pstep = (long long)g.lanes_p * C;
  const long long lane_off = (p0 + sub) * C + (long long)jl * V;
  const long long koff = ((long long)team * R * g.lanes_p + sub) * C + (long long)jl * V;
  T* kx = reinterpret_cast<T*>(smem + L.kx) + koff;
  T* kd = reinterpret_cast<T*>(smem + L.kdy) + koff;
  const T* __restrict__ X = static_cast<const T*>(a.x);
  const T* __restrict__ DY = kBwd ? static_cast<const T*>(a.dy) : X;
  // the sample of block j of this CTA (past N: a team that only keeps the
  // barriers), and its offset of this thread's values
  auto sample = [&](int j) { return (row0 + j * P) * spp + team; };
  auto offset = [&](int j) {
    const int n = sample(j);
    return (long long)(n < a.N ? n : 0) * HW * C + lane_off;
  };

  // The ring: kept pixel i of this CTA's j-th block is the thread's pixel
  // j nk + i of the sequence, in slot (j nk + i) % R; kKeepBatch of them a
  // cp.async group, issued as soon as their slots are free (the pixels R
  // before them consumed by the second pass): while one sample is folded,
  // reduced and written, the next one's copies are in flight.
  const int nbs = (nk + kKeepBatch - 1) / kKeepBatch;  // groups a block
  const int total = n_rows * nbs;
  int issued = 0, freed = 0;  // groups committed; kept pixels consumed
  auto issue = [&]() {
    if constexpr (V * sizeof(T) == 16) {
      const int j = issued / nbs, b0 = (issued % nbs) * kKeepBatch;
      if (sample(j) < a.N) {
        const long long base = offset(j);
        int slot = (j * nk + b0) % R;
#pragma unroll
        for (int u = 0; u < kKeepBatch; ++u) {
          const int i = b0 + u;
          if (i < nk) {
            cp_async16(kx + slot * pstep, X + base + i * pstep);
            if constexpr (kBwd) cp_async16(kd + slot * pstep, DY + base + i * pstep);
          }
          slot = slot + 1 == R ? 0 : slot + 1;
        }
      }
      cp_async_commit();
    }
    ++issued;
  };
  auto pump = [&]() {
    while (issued < total) {
      const int j = issued / nbs, b1 = (issued % nbs + 1) * kKeepBatch;
      if (j * nk + (b1 < nk ? b1 : nk) > freed + R) break;
      issue();
    }
  };
  pump();
  // the per-channel values of both passes, loaded while the copies fly
  float sc[V], bs[V];
#pragma unroll
  for (int kk = 0; kk < V; ++kk) sc[kk] = bs[kk] = 0.f;
  if (lane_on) {
#pragma unroll
    for (int kk = 0; kk < V; ++kk) {
      sc[kk] = __ldg(a.scale + jl * V + kk);
      bs[kk] = __ldg(a.bias + jl * V + kk);
    }
  }
  const double M = (double)HW * cpg;
  const int cb = (C + k - 1) / k;  // K21: channel block `rank` of the rows
  const int c0 = rank * cb < C ? rank * cb : C, c1 = c0 + cb < C ? c0 + cb : C;

  // phase one of block j: its f64 sums s1, s2 (K21 through the mean mu and
  // rstd * scale mul of its sample); the tail from device memory, then the
  // kept pixels in order
  double s1[V], s2[V];
  float mu[V], mul[V], rs[V];
  // K21: rstd of this thread's statistics' group, and of its row's channel
  // in the block's first sample
  float r_grp = 0.f, r_row = 0.f;
  auto begin_sums = [&](int j) {
    const int n = sample(j);
#pragma unroll
    for (int kk = 0; kk < V; ++kk) {
      s1[kk] = s2[kk] = 0.0;
      mu[kk] = mul[kk] = rs[kk] = 0.f;
    }
    if constexpr (kBwd) {
      const int blk = row0 + j * P;
      r_grp = n < a.N && tl < G ? __ldg(a.rstd + n * G + tl) : 0.f;
      r_row = c0 + t < c1 && blk * spp < a.N ? __ldg(a.rstd + blk * spp * G + (c0 + t) / cpg)
                                              : 0.f;
      if (n < a.N && lane_on) {
#pragma unroll
        for (int kk = 0; kk < V; ++kk) {
          const int q = n * G + (jl * V + kk) / cpg;
          mu[kk] = __ldg(a.mean + q);
          rs[kk] = __ldg(a.rstd + q);
          mul[kk] = __fmul_rn(rs[kk], sc[kk]);
        }
      }
    }
    if (!(n < a.N && lane_on)) return;
    // the tail: addresses first, then every load in one straight run (a
    // pixel past the end loads the last one, and is not added)
    const T* __restrict__ xs = X + offset(j);
    const T* __restrict__ ds = DY + offset(j);
    for (int i0 = nk; i0 < n_it; i0 += kTailUnroll) {
      Vec<T, V> xv[kTailUnroll], dv[kTailUnroll];
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {
        const int i = i0 + u < n_it ? i0 + u : n_it - 1;
        xv[u] = ldv<T, V>(xs + i * pstep, false);
        if constexpr (kBwd) dv[u] = ldv<T, V>(ds + i * pstep, false);
      }
      clk.mark(kGLoad, first_word(xv[0]));
#pragma unroll
      for (int u = 0; u < kTailUnroll; ++u) {
        if (i0 + u >= n_it) continue;
#pragma unroll
        for (int kk = 0; kk < V; ++kk)
          add_value<T, kBwd>(xv[u].v[kk], kBwd ? dv[u].v[kk] : xv[u].v[kk], mu[kk], mul[kk],
                             bs[kk], s1[kk], s2[kk]);
      }
      clk.mark(kGMath, low_word(s2[V - 1]));
    }
  };
  // kept pixel i of block j (in `slot`) into the sums, its group waited for
  // first (a thread reads only what it copied: no block barrier)
  auto add_kept = [&](int j, int i, int slot) {
    if (i % kKeepBatch == 0) cp_async_wait(issued - 1 - (j * nbs + i / kKeepBatch));
    if (!(sample(j) < a.N)) return;
    const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(kx + slot * pstep);
    const Vec<T, V> dv = kBwd ? *reinterpret_cast<const Vec<T, V>*>(kd + slot * pstep) : xv;
#pragma unroll
    for (int kk = 0; kk < V; ++kk)
      add_value<T, kBwd>(xv.v[kk], dv.v[kk], mu[kk], mul[kk], bs[kk], s1[kk], s2[kk]);
  };

  // block j's statistics: the team's fold (the q pixel lanes of a warp by
  // a shuffle tree, its rows in order into the per-channel row, a group's
  // channels in order, K21 weighting each by scale for hbar and Q), then the
  // k ranks' group partials in rank order; K21's rows of the block
  auto statistics = [&](int j) {
    const int blk = row0 + j * P, n = sample(j);
    const bool live = n < a.N;
    if (g.q > 1) {
      for (int o = g.q / 2; o >= 1; o >>= 1) {
#pragma unroll
        for (int kk = 0; kk < V; ++kk) {
          s1[kk] += __shfl_down_sync(kFull, s1[kk], o * g.cv);
          s2[kk] += __shfl_down_sync(kFull, s2[kk], o * g.cv);
        }
      }
    }
    const int row = g.q > 1 ? ((tl & 31) < g.cv ? tl / 32 : -1) : (sub < g.lanes_p ? sub : -1);
    double* tred = red + (long long)team * g.rows * C * 2;
    if (row >= 0) {
#pragma unroll
      for (int kk = 0; kk < V; ++kk) {
        tred[((long long)row * C + jl * V + kk) * 2] = s1[kk];
        tred[((long long)row * C + jl * V + kk) * 2 + 1] = s2[kk];
      }
    }
    __syncthreads();
    double* crow = reinterpret_cast<double*>(smem + L.crow) + (long long)(j & 1) * spp * C * 2;
    double* tcrow = crow + (long long)team * C * 2;
    for (int i = tl; i < 2 * C; i += g.tt) {  // i = channel * 2 + sum
      double acc = 0.0;
      for (int r = 0; r < g.rows; ++r) acc += tred[(long long)r * C * 2 + i];
      tcrow[i] = acc;
    }
    __syncthreads();
    double* tg =
        reinterpret_cast<double*>(smem + L.gpart) + ((long long)(j & 1) * spp + team) * G * 2;
    for (int i = tl; i < 2 * G; i += g.tt) {  // i = group * 2 + sum
      const int grp = i >> 1, w = i & 1;
      double acc = 0.0;
      for (int c = grp * cpg; c < (grp + 1) * cpg; ++c)
        acc += kBwd ? (double)__ldg(a.scale + c) * tcrow[c * 2 + w] : tcrow[c * 2 + w];
      tg[i] = acc;
    }
    clk.mark(kGFold);
    if (k > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    for (int grp = tl; grp < G; grp += g.tt) {
      double pa[kGMaxCluster], pb[kGMaxCluster];  // every rank's loads issued together
#pragma unroll
      for (int r = 0; r < kGMaxCluster; ++r) {
        if (r < k) {
          const double* q = k > 1 ? cg::this_cluster().map_shared_rank(tg, r) : tg;
          pa[r] = q[grp * 2];
          pb[r] = q[grp * 2 + 1];
        }
      }
      double A = 0.0, B = 0.0;
#pragma unroll
      for (int r = 0; r < kGMaxCluster; ++r) {
        if (r < k) {
          A += pa[r];
          B += pb[r];
        }
      }
      float* gs = gstat + ((long long)team * G + grp) * 2;
      if constexpr (!kBwd) {
        const double m = A / M;
        double v = B / M - m * m;
        v = v > 0.0 ? v : 0.0;
        const float mf = (float)m, rf = (float)(1.0 / sqrt(v + a.eps));
        gs[0] = mf;
        gs[1] = rf;
        if (live && rank == 0) {
          a.mean[n * G + grp] = mf;
          a.rstd[n * G + grp] = rf;
        }
      } else if (live) {
        const double r = (double)(grp == tl ? r_grp : __ldg(a.rstd + n * G + grp));
        gs[0] = (float)(A / M);              // hbar
        gs[1] = (float)(r * r * r * B / M);  // Q
      }
    }
    // K21: channel block `rank` of the block's per-sample sums, over the
    // ranks in order, then its samples in order: (sum g, rstd * sum g xc)
    if constexpr (kBwd) {
      for (int c = c0 + t; c < c1; c += kGThreads) {
        double a1 = 0.0, a2 = 0.0;
        for (int tm = 0; tm < spp && blk * spp + tm < a.N; ++tm) {
          double pa[kGMaxCluster], pb[kGMaxCluster];
#pragma unroll
          for (int r = 0; r < kGMaxCluster; ++r) {
            if (r < k) {
              const double* q = (k > 1 ? cg::this_cluster().map_shared_rank(crow, r) : crow) +
                                ((long long)tm * C + c) * 2;
              pa[r] = q[0];
              pb[r] = q[1];
            }
          }
          double sg = 0.0, sgc = 0.0;
#pragma unroll
          for (int r = 0; r < kGMaxCluster; ++r) {
            if (r < k) {
              sg += pa[r];
              sgc += pb[r];
            }
          }
          a1 += sg;
          const float rr = tm == 0 && c == c0 + t
                               ? r_row
                               : __ldg(a.rstd + (blk * spp + tm) * G + c / cpg);
          a2 += (double)rr * sgc;
        }
        a.rows[((long long)blk * C + c) * 2] = a1;
        a.rows[((long long)blk * C + c) * 2 + 1] = a2;
      }
    }
    // after the last block's remote reads, the arrive of the barrier that
    // keeps this CTA's shared memory alive until the others are done
    if (k > 1 && j == n_rows - 1) cluster_arrive();
    __syncthreads();  // the group statistics are written
    clk.mark(kGCluster);
  };

  // the second pass of block j: K20 y = relu(cast((x - mean) * (rstd *
  // scale) + bias)); K21 dx = rstd (scale g - hbar) - xc Q, one rounding to
  // T; streaming stores (K20's mu and mul from its statistics)
  float hb[V], qq[V];
  auto emit = [&](const Vec<T, V>& xv, const Vec<T, V>& dv) {
    float f[V];
#pragma unroll
    for (int kk = 0; kk < V; ++kk) {
      const float xc = __fsub_rn(to_f(xv.v[kk]), mu[kk]);
      const float pre = pre_act(xc, mul[kk], bs[kk]);
      if constexpr (!kBwd) {
        f[kk] = relu_on<T>(pre) ? pre : 0.f;  // relu(cast(pre)) == cast(relu_on ? pre : 0)
      } else {
        const float gg = relu_on<T>(pre) ? to_f(dv.v[kk]) : 0.f;
        const float u = __fsub_rn(__fmul_rn(sc[kk], gg), hb[kk]);
        f[kk] = __fsub_rn(__fmul_rn(rs[kk], u), __fmul_rn(xc, qq[kk]));
      }
    }
    return round_to<T, V>(f);
  };
  unsigned dep = 0u;

  // block by block: phase one, the statistics, the second pass (its kept
  // pixels' slots refilled with the next blocks' pixels as they are read)
  auto next_slot = [&](int slot) { return slot + 1 == R ? 0 : slot + 1; };
  for (int j = 0; j < n_rows; ++j) {
    const bool active = sample(j) < a.N && lane_on;
    begin_sums(j);
    int slot = nk > 0 ? (j * nk) % R : 0;
    for (int i = 0, sl = slot; i < nk; ++i, sl = next_slot(sl)) add_kept(j, i, sl);
    clk.mark(kGMath, low_word(s2[V - 1]));
    statistics(j);
#pragma unroll
    for (int kk = 0; kk < V; ++kk) {
      const float* gs = gstat + ((long long)team * G + (jl * V + kk) / cpg) * 2;
      if constexpr (!kBwd) {
        mu[kk] = gs[0];
        mul[kk] = __fmul_rn(gs[1], sc[kk]);
        hb[kk] = qq[kk] = 0.f;
      } else {
        hb[kk] = gs[0];
        qq[kk] = gs[1];
      }
    }
    const T* __restrict__ xs = X + offset(j);
    const T* __restrict__ ds = DY + offset(j);
    T* __restrict__ os = static_cast<T*>(a.out) + offset(j);
    if (active) {  // the tail again, walked back (streaming loads: their last use)
      for (int i0 = n_it - 1; i0 >= nk; i0 -= kTailUnroll) {
        Vec<T, V> xv[kTailUnroll], dv[kTailUnroll];
#pragma unroll
        for (int u = 0; u < kTailUnroll; ++u) {
          const int i = i0 - u >= nk ? i0 - u : nk;
          xv[u] = ldv<T, V>(xs + i * pstep, true);
          dv[u] = kBwd ? ldv<T, V>(ds + i * pstep, true) : xv[u];
        }
#pragma unroll
        for (int u = 0; u < kTailUnroll; ++u) {
          if (i0 - u < nk) continue;
          const Vec<T, V> o = emit(xv[u], dv[u]);
          stv_cs<T, V>(os + (i0 - u) * pstep, o);
          if constexpr (kClock) dep ^= first_word(o);
        }
      }
      for (int i = 0; i < nk; ++i, slot = next_slot(slot)) {
        const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(kx + slot * pstep);
        const Vec<T, V> dv = kBwd ? *reinterpret_cast<const Vec<T, V>*>(kd + slot * pstep) : xv;
        const Vec<T, V> o = emit(xv, dv);
        stv_cs<T, V>(os + i * pstep, o);
        if constexpr (kClock) dep ^= first_word(o);
        if ((i + 1) % kKeepBatch == 0) {  // the slots just read take the next blocks' pixels
          freed = j * nk + i + 1;
          pump();
        }
      }
      clk.mark(kGPass, dep);
    }
    freed = (j + 1) * nk;
    pump();
  }

  if constexpr (kBwd) {
    // every row written: the last CTA row to arrive at channel block
    // `rank` sums the block's rows into dbias and dscale, lane l of a
    // channel adding rows l, l + lanes, ... in order, then the lanes in order
    // (the block barrier orders every thread's rows before thread 0's fence
    // and count, the fence after the count before every read of the last)
    __syncthreads();
    if (t == 0) {
      __threadfence();
      s_last = atomicAdd(a.count + rank, 1u) == gridDim.y - 1;
      __threadfence();
    }
    __syncthreads();
    if (s_last) {
      for (int cc = c0; cc < c1; cc += kGThreads) {
        const int nc = c1 - cc < kGThreads ? c1 - cc : kGThreads;
        const int lanes = kGThreads / nc, ch = t % nc, lane = t / nc;
        __syncthreads();  // the previous chunk's readers of red are done
        if (lane < lanes) {
          double a1 = 0.0, a2 = 0.0;
          for (int b0 = lane; b0 < blocks; b0 += lanes * kGSumLoads) {
            double2 pv[kGSumLoads];
#pragma unroll
            for (int u = 0; u < kGSumLoads; ++u) {
              const int b = b0 + u * lanes;
              pv[u] = b < blocks ? __ldcg(reinterpret_cast<const double2*>(
                                       a.rows + ((long long)b * C + cc + ch) * 2))
                                 : make_double2(0.0, 0.0);
            }
#pragma unroll
            for (int u = 0; u < kGSumLoads; ++u) {
              a1 += pv[u].x;
              a2 += pv[u].y;
            }
          }
          red[(lane * nc + ch) * 2] = a1;
          red[(lane * nc + ch) * 2 + 1] = a2;
        }
        __syncthreads();
        if (t < nc) {
          double a1 = 0.0, a2 = 0.0;
          for (int l = 0; l < lanes; ++l) {
            a1 += red[(l * nc + t) * 2];
            a2 += red[(l * nc + t) * 2 + 1];
          }
          a.dbias[cc + t] = (float)a1;
          a.dscale[cc + t] = (float)a2;
        }
      }
      if (t == 0) a.count[rank] = 0u;
    }
    clk.mark(kGFinal);
  }
  if (k > 1) cluster_wait();  // no CTA leaves while another may read its shared memory
  clk.flush(kPhases);
}

template <typename T, int V, bool kClock>
__global__ void __launch_bounds__(kGThreads) gn_fwd_cluster_kernel(const __grid_constant__ GnArgs a) {
  gn_cluster_body<T, V, false, kClock>(a);
}

template <typename T, int V, bool kClock>
__global__ void __launch_bounds__(kGThreads) gn_bwd_cluster_kernel(const __grid_constant__ GnArgs a) {
  gn_cluster_body<T, V, true, kClock>(a);
}

// One launch of kKernel on a grid (k, rows) in clusters of k CTAs along x
// (no cluster attribute for k = 1), `smem` bytes of dynamic shared memory
// (the allowance raised once per instance to the most asked so far).
template <void (*kKernel)(GnArgs)>
int launch_cluster(const GnArgs& a, int rows, int smem, cudaStream_t s) {
  static int allowed = -1;  // -1: the cluster attribute not yet set
  cudaError_t err = cudaSuccess;
  if (allowed < 0) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    allowed = 48 * 1024;
  }
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.k, (unsigned)rows);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.k > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kKernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int run_cluster_v(const GnArgs& a, bool bwd, int rows, int smem, cudaStream_t s) {
  const bool clk = a.cycles != nullptr;
  if (bwd)
    return clk ? launch_cluster<gn_bwd_cluster_kernel<T, V, true>>(a, rows, smem, s)
               : launch_cluster<gn_bwd_cluster_kernel<T, V, false>>(a, rows, smem, s);
  return clk ? launch_cluster<gn_fwd_cluster_kernel<T, V, true>>(a, rows, smem, s)
             : launch_cluster<gn_fwd_cluster_kernel<T, V, false>>(a, rows, smem, s);
}

// A call's plan checked against this source's geometry and layout, then the
// launch; anything else is refused, never run another way.
template <typename T>
int run_cluster(const GnArgs& a, bool bwd, int vec, int rows, int smem,
                std::initializer_list<const void*> ptrs, cudaStream_t s) {
  const int V = vec ? 16 / (int)sizeof(T) : 1;
  if (a.k < 1 || a.k > kGMaxCluster || a.spp < 1 || a.spp > kGMaxTeams ||
      (a.spp & (a.spp - 1)) || (a.k > 1 && a.spp != 1) || a.keep < 0 || a.slots < a.keep ||
      (a.slots > 0 && a.keep == 0) || a.C % V || (vec && !vectorizable<T>(a.C, ptrs)) ||
      (!vec && a.slots > 0))
    return (int)cudaErrorInvalidValue;
  const GGeom g(a.C, V, a.spp);
  const int blocks = (a.N + a.spp - 1) / a.spp;
  if (g.cv < 1 || g.cv > g.tt || rows < 1 || rows > blocks) return (int)cudaErrorInvalidValue;
  const GLayout L = g_layout(g, a.spp, a.C, a.G, (int)sizeof(T), a.slots, bwd);
  if (L.total != smem || smem > kGSmemBudget) return (int)cudaErrorInvalidValue;
  if (vec) return run_cluster_v<T, 16 / sizeof(T)>(a, bwd, rows, smem, s);
  return run_cluster_v<T, 1>(a, bwd, rows, smem, s);
}

}  // namespace

// ---------------------------------------------------------- the split design
// K20. x, y [N, HW, C] (NHWC); scale, bias [C] f32; part: [N, spans, C, 2]
// f64 scratch (spans: `hourglass.plan_split(1, HW, C, ...)`, the partial
// blocks of one sample at the vector width x and y allow); mean, rstd [N, G]
// f32 (outputs, K21's inputs). dtype: 0 = f32, 1 = bf16.
extern "C" int suo_group_norm_relu(const void* x, const void* scale, const void* bias, int N,
                                   long long HW, int C, int G, double eps, void* part,
                                   void* mean, void* rstd, void* y, int dtype, void* stream) {
  if (!valid(N, HW, C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return forward<float>(x, scale, bias, N, HW, C, G, eps, part, mean, rstd, y, s);
  return forward<__nv_bfloat16>(x, scale, bias, N, HW, C, G, eps, part, mean, rstd, y, s);
}

// K21. x, dy, dx [N, HW, C]; scale, bias [C], mean, rstd [N, G] f32 (K20's);
// part as K20's; sums [N, C, 2] f64 and coef [N, G, 2] f32 scratch; dscale,
// dbias [C] f32 outputs.
extern "C" int suo_group_norm_relu_bwd(const void* x, const void* dy, const void* scale,
                                       const void* bias, const void* mean, const void* rstd,
                                       int N, long long HW, int C, int G, void* part, void* sums,
                                       void* coef, void* dscale, void* dbias, void* dx,
                                       int dtype, void* stream) {
  if (!valid(N, HW, C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return backward<float>(x, dy, scale, bias, mean, rstd, N, HW, C, G, part, sums, coef, dscale,
                           dbias, dx, s);
  return backward<__nv_bfloat16>(x, dy, scale, bias, mean, rstd, N, HW, C, G, part, sums, coef,
                                 dscale, dbias, dx, s);
}

// -------------------------------------------------------- the cluster design
// Both take the plan of `hourglass.plan_gn`: vec (1: 16-byte vectors), k
// (CTAs of a sample's cluster), spp (samples of a CTA, k = 1), keep (pixels
// of a sample a thread keeps in shared memory), slots (its ring's pixels),
// smem (dynamic shared-memory bytes, its layout's total); rows: the CTA
// rows launched, 1 to ceil(N / spp) (row r takes blocks r, r + rows, ...;
// the wrapper launches as many as run at once); cycles null or int64 zeros
// [k * rows, phases].

// K20. x, y [N, HW, C] (NHWC); scale, bias [C] f32; mean, rstd [N, G] f32 out.
extern "C" int suo_group_norm_relu_cluster(const void* x, const void* scale, const void* bias,
                                           int N, long long HW, int C, int G, double eps,
                                           void* mean, void* rstd, void* y, int dtype, int vec,
                                           int k, int spp, int keep, int slots, int rows,
                                           int smem, void* cycles, void* stream) {
  if (!valid(N, HW, C, G)) return (int)cudaErrorInvalidValue;
  GnArgs a = {};
  a.x = x;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.out = y;
  a.N = N;
  a.C = C;
  a.G = G;
  a.HW = HW;
  a.eps = eps;
  a.k = k;
  a.spp = spp;
  a.keep = keep;
  a.slots = slots;
  a.cycles = (long long*)cycles;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_cluster<float>(a, false, vec, rows, smem, {x, y}, s);
  return run_cluster<__nv_bfloat16>(a, false, vec, rows, smem, {x, y}, s);
}

// K21. x, dy, dx [N, HW, C]; scale, bias [C], mean, rstd [N, G] f32 (K20's);
// sums [ceil(N / spp), C, 2] f64 and count [k] uint32 (zeros, left zeros):
// the workspace; dscale, dbias [C] f32 out.
extern "C" int suo_group_norm_relu_bwd_cluster(const void* x, const void* dy, const void* scale,
                                               const void* bias, const void* mean,
                                               const void* rstd, int N, long long HW, int C,
                                               int G, void* sums, void* count, void* dscale,
                                               void* dbias, void* dx, int dtype, int vec, int k,
                                               int spp, int keep, int slots, int rows, int smem,
                                               void* cycles, void* stream) {
  if (!valid(N, HW, C, G)) return (int)cudaErrorInvalidValue;
  GnArgs a = {};
  a.x = x;
  a.dy = dy;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.out = dx;
  a.dscale = (float*)dscale;
  a.dbias = (float*)dbias;
  a.rows = (double*)sums;
  a.count = (unsigned*)count;
  a.N = N;
  a.C = C;
  a.G = G;
  a.HW = HW;
  a.k = k;
  a.spp = spp;
  a.keep = keep;
  a.slots = slots;
  a.cycles = (long long*)cycles;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_cluster<float>(a, true, vec, rows, smem, {x, dy, dx}, s);
  return run_cluster<__nv_bfloat16>(a, true, vec, rows, smem, {x, dy, dx}, s);
}

// The largest cluster of the cluster design's CTAs this card co-schedules
// when each CTA claims the whole shared-memory budget, into *out.
extern "C" int suo_group_norm_max_cluster(int* out) {
  int best = kGMaxCluster;
  for (auto kern : {gn_fwd_cluster_kernel<__nv_bfloat16, 8, false>,
                    gn_bwd_cluster_kernel<__nv_bfloat16, 8, false>}) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBudget);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kGMaxCluster);
    cfg.blockDim = dim3(kGThreads);
    cfg.dynamicSmemBytes = kGSmemBudget;
    int n = 0;
    err = cudaOccupancyMaxPotentialClusterSize(&n, (const void*)kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    best = n < best ? n : best;
  }
  *out = best;
  return 0;
}

// How many clusters of k CTAs (smem bytes of dynamic shared memory each) of
// the cluster design's K20 (bwd 0) or K21 kernel for dtype (0 f32, 1 bf16)
// and vec the card runs at once, into *out: the CTA rows a launch takes.
extern "C" int suo_group_norm_active_clusters(int k, int smem, int bwd, int dtype, int vec,
                                              int* out) {
  using Kern = void (*)(GnArgs);
  const Kern kerns[2][2][2] = {
      {{gn_fwd_cluster_kernel<float, 1, false>, gn_fwd_cluster_kernel<float, 4, false>},
       {gn_fwd_cluster_kernel<__nv_bfloat16, 1, false>,
        gn_fwd_cluster_kernel<__nv_bfloat16, 8, false>}},
      {{gn_bwd_cluster_kernel<float, 1, false>, gn_bwd_cluster_kernel<float, 4, false>},
       {gn_bwd_cluster_kernel<__nv_bfloat16, 1, false>,
        gn_bwd_cluster_kernel<__nv_bfloat16, 8, false>}}};
  const Kern kern = kerns[bwd != 0][dtype != 0][vec != 0];
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBudget);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k, 64);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kern, &cfg);
}
