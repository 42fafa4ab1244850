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
// Bound on this card: bytes. K20 must read x (twice: the statistics, then the
// apply pass; a second read of a [8, 256, 64, 64] bf16 tensor, 16.8 MB, is
// L2-resident only in part) and write y; K21 must read x and dy and write dx.
// Design: K16 / K17's layout (`bn_train.cu`) with the statistics per sample.
// The partial pass runs a block per (span of one sample's pixels, sample); a
// thread owns one 16-byte vector of channels (4 f32 or 8 bf16: at C = 256 one
// bf16 group of 8 channels is exactly one vector) and walks kIters pixels of
// the span with f64 accumulators; the block sums its pixel lanes in shared
// memory in a fixed order and writes one f64 pair per channel. The finalize
// sums a group's channels and spans on one warp in a fixed order (a
// shuffle tree): deterministic, no atomics. The apply and dx passes read and
// write the same vectors. Launches: K20 three (partial, finalize, apply), K21
// four (partial, the per-sample finalize, the per-channel one, dx); every
// kernel's name starts with `gn_`.

#include "channel_vec.cuh"

namespace {

// K20's value in the storage dtype before the ReLU: ((x - mean) * mul) +
// bias, each operation rounded in f32, then the cast
template <typename T>
__device__ __forceinline__ T pre_relu(float xc, float mul, float bias) {
  return from_f<T>(__fadd_rn(__fmul_rn(xc, mul), bias));
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

}  // namespace

// The partial spans per sample of a call: the wrapper allocates [N, spans,
// C, 2] f64 scratch. Pointers only decide vectorization: pass those of the
// call (x, y for K20; x, dy, dx for K21) or null.
extern "C" int suo_group_norm_spans(long long HW, int C, int dtype, const void* a,
                                    const void* b, const void* c) {
  if (dtype == 0) return spans_for<float>(HW, C, vectorizable<float>(C, {a, b, c}));
  return spans_for<__nv_bfloat16>(HW, C, vectorizable<__nv_bfloat16>(C, {a, b, c}));
}

// K20. x, y [N, HW, C] (NHWC); scale, bias [C] f32; part: the scratch above;
// mean, rstd [N, G] f32 (outputs, K21's inputs). dtype: 0 = f32, 1 = bf16.
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
