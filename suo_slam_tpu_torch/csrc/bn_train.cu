// K16 — masked BatchNorm batch statistics, and K17 — the backward of the
// norm + ReLU pair (K8), f32 or bf16 activations.
//
// Replace the training branch of `suo_slam_tpu/models/hourglass.py`
// `MaskedBatchNorm.__call__(train=True)` (`:69-85`) and the gradient XLA
// derives for it and for the `nn.relu` after it (`:133-139`, `:202`, `:222`).
//
// K16 `bn_stats`: per channel over the rows n with row_mask[n] (all rows when
// there is no mask), with M = max(sum(mask) * H * W, 1):
//   mean = sum(m x) / M,   var = sum(m x^2) / M - mean^2   (biased)
// One pass over x in f64 partial sums (an f32 value and its square are exact
// in f64, so the order of the sums moves only the last bits of the f64
// result), then a finalize that sums each channel's partials in a fixed
// order and rounds mean and var once to f32. JAX takes two f32 passes; the
// f64 sums agree with them to f32 rounding.
//
// K17 `norm_relu_bwd`: y = relu(cast(x * inv + shift)) with inv =
// rsqrt(var + eps) * scale and shift = bias - mean * inv (K8's forward). With
// g = dy * [y > 0] in f32 (the ReLU mask recomputed from x, inv and shift
// with K8's exact arithmetic) and xc = x - mean:
//   sum_g  = sum over ALL rows of g          (dbias, or d shift)
//   sum_gc = sum over ALL rows of g * xc     (dscale = sum_gc * rstd, or d inv
//                                             with mean = 0)
//   train: dx = inv * g - m_n * (inv * sum_g / M + xc * inv * rstd^2 * sum_gc / M)
//   fixed statistics (train = 0): dx = inv * g
// cast to x's dtype once. Padded rows (m_n = 0) carry gradient into the sums
// and their own dx (the validity loss reaches them) but not through the
// statistics, which they did not enter.
//
// Bound on this card: bytes. K16 reads x once (at the train step's largest
// norm, 32 x 64 x 64 x 256 bf16, 67 MB: 20 us at 3.35 TB/s); K17 must read
// x and dy and write dx. Design: the reductions keep enough bytes in flight
// to cover the memory latency — a thread owns one 16-byte vector of channels
// (4 f32 or 8 bf16; one value when C or the pointers do not allow it) and
// walks kIters pixels of its block's span of the flattened N * H * W pixels,
// f64 accumulators in registers, so a [16, 256, 64, 64] call runs 512 (bf16)
// or 1,024 (f32) blocks; each block reduces its pixel lanes in shared memory in a fixed
// order and writes one f64 partial per channel. The finalize gives each
// channel 8 partial lanes (a warp per 32 channels, 8 warps a block), adds
// their sums in a fixed order: deterministic, no atomics. K17's elementwise
// pass re-reads x and dy as the same vectors.

#include "channel_vec.cuh"

namespace {

constexpr int kFinLanes = 8;    // partial lanes per channel in the finalize

// K8's forward value before the ReLU, in the storage dtype, compared with 0:
// a product and a sum each rounded (--fmad=false), then the cast
template <typename T>
__device__ __forceinline__ bool relu_on(T x, float inv, float shift) {
  const float a = to_f(x) * inv;
  return to_f(from_f<T>(a + shift)) > 0.f;
}

// Partial sums of one block's span of the N * HW pixels: s1 and s2 per
// channel into part[block * C * 2 + c * 2 + {0, 1}].
// mode 0 (K16): s1 = sum x, s2 = sum x^2 over masked rows.
// mode 1 (K17): s1 = sum g, s2 = sum g * (x - mean) over every row.
template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const uint8_t* __restrict__ mask, const float* __restrict__ inv,
               const float* __restrict__ shift, const float* __restrict__ mean,
               long long n_pix, long long HW, int C, double* __restrict__ part) {
  const Layout L(C, V);
  const int t = threadIdx.x, sub = t / L.lanes_c, jl = t % L.lanes_c;
  const long long p0 = blockIdx.x * L.pixels_per_block();
  const long long p1 = p0 + L.pixels_per_block() < n_pix ? p0 + L.pixels_per_block() : n_pix;
  double* out = part + (long long)blockIdx.x * C * 2;
  __shared__ double red[2][kThreads];
  for (int jb = 0; jb < L.cv; jb += L.lanes_c) {  // channel-vector blocks when C / V > 256
    const int j = jb + jl;
    const bool active = sub < L.lanes_p && j < L.cv;
    double s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
    if (active) {
      float iv[V], sh[V], mu[V];
      if constexpr (kMode == 1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          iv[k] = inv[j * V + k];
          sh[k] = shift[j * V + k];
          mu[k] = mean[j * V + k];
        }
      }
      long long n = (p0 + sub) / HW;
      long long row_end = (n + 1) * HW;
      for (long long p = p0 + sub; p < p1; p += L.lanes_p) {
        while (p >= row_end) {
          ++n;
          row_end += HW;
        }
        const long long i0 = p * C + (long long)j * V;
        if constexpr (kMode == 0) {
          if (mask != nullptr && mask[n] == 0) continue;
          const Vec<T, V> xv = load<T, V>(x + i0);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const double v = (double)to_f(xv.v[k]);
            s1[k] += v;
            s2[k] += v * v;
          }
        } else {
          const Vec<T, V> xv = load<T, V>(x + i0);
          const Vec<T, V> dv = load<T, V>(dy + i0);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float g = relu_on(xv.v[k], iv[k], sh[k]) ? to_f(dv.v[k]) : 0.f;
            s1[k] += (double)g;
            s2[k] += (double)g * (double)(to_f(xv.v[k]) - mu[k]);
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

__device__ __forceinline__ double rows_count(const uint8_t* mask, int N, long long HW) {
  if (mask == nullptr) return (double)N * (double)HW;
  long long m = 0;
  for (int n = 0; n < N; ++n) m += mask[n] != 0;
  const double cnt = (double)m * (double)HW;
  return cnt > 1.0 ? cnt : 1.0;
}

// Each channel's two sums over n_part partials: 32 channels a warp, 8 warps
// a block, warp w summing partials w, w + 8, ...; thread w = 0 adds the
// eight in order. Returns true on the thread that holds channel c's sums.
__device__ __forceinline__ bool sum_partials(const double* __restrict__ part, int n_part, int C,
                                             int& c, double& s1, double& s2) {
  __shared__ double red[2][kFinLanes][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  c = blockIdx.x * 32 + lane;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int i = w; i < n_part; i += kFinLanes) {
      a += part[(long long)i * C * 2 + c * 2];
      b += part[(long long)i * C * 2 + c * 2 + 1];
    }
  }
  red[0][w][lane] = a;
  red[1][w][lane] = b;
  __syncthreads();
  if (w != 0 || c >= C) return false;
  s1 = s2 = 0.0;
  for (int q = 0; q < kFinLanes; ++q) {
    s1 += red[0][q][lane];
    s2 += red[1][q][lane];
  }
  return true;
}

// K16's finalize: mean and biased var per channel, f32
__global__ void __launch_bounds__(kThreads)
stats_finalize_kernel(const double* __restrict__ part, int n_part, const uint8_t* __restrict__ mask,
                      int N, long long HW, int C, float* __restrict__ mean,
                      float* __restrict__ var) {
  int c;
  double s1, s2;
  if (!sum_partials(part, n_part, C, c, s1, s2)) return;
  const double M = rows_count(mask, N, HW);
  const double mu = s1 / M;
  const double v = s2 / M - mu * mu;
  mean[c] = (float)mu;
  var[c] = (float)(v > 0.0 ? v : 0.0);
}

// K17's finalize: the two sums (f32 outputs) and dx's per-channel
// coefficients coef[c] = (inv, inv * sum_g / M, inv * rstd^2 * sum_gc / M)
__global__ void __launch_bounds__(kThreads)
bwd_finalize_kernel(const double* __restrict__ part, int n_part, const uint8_t* __restrict__ mask,
                    int N, long long HW, int C, const float* __restrict__ inv,
                    const float* __restrict__ rstd, int train, float* __restrict__ sum_g,
                    float* __restrict__ sum_gc, float* __restrict__ coef) {
  int c;
  double s1, s2;
  if (!sum_partials(part, n_part, C, c, s1, s2)) return;
  sum_g[c] = (float)s1;
  sum_gc[c] = (float)s2;
  const double iv = (double)inv[c];
  coef[c * 3] = inv[c];
  if (train) {
    const double M = rows_count(mask, N, HW);
    const double r = (double)rstd[c];
    coef[c * 3 + 1] = (float)(iv * s1 / M);
    coef[c * 3 + 2] = (float)(iv * r * r * s2 / M);
  } else {
    coef[c * 3 + 1] = 0.f;
    coef[c * 3 + 2] = 0.f;
  }
}

// K17's elementwise pass, a vector of V channels a thread:
// dx = a g - m_n (b + (x - mean) c), one rounding to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const uint8_t* __restrict__ mask,
          const float* __restrict__ inv, const float* __restrict__ shift,
          const float* __restrict__ mean, const float* __restrict__ coef, long long HW, int C,
          long long n_vec, int train, T* __restrict__ dx) {
  const long long row = HW * C;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const long long i0 = v * V;
    const int c0 = (int)(i0 % C);
    const bool on = train && (mask == nullptr || mask[i0 / row] != 0);
    const Vec<T, V> xv = load<T, V>(x + i0);
    const Vec<T, V> dv = load<T, V>(dy + i0);
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = c0 + k;
      const float g = relu_on(xv.v[k], inv[c], shift[c]) ? to_f(dv.v[k]) : 0.f;
      float d = coef[c * 3] * g;
      if (on) {
        const float corr = coef[c * 3 + 1] + (to_f(xv.v[k]) - mean[c]) * coef[c * 3 + 2];
        d = d - corr;
      }
      out.v[k] = from_f<T>(d);
    }
    store<T, V>(dx + i0, out);
  }
}

template <typename T, int V>
long long n_blocks(long long n_pix, int C) {
  const Layout L(C, V);
  return (n_pix + L.pixels_per_block() - 1) / L.pixels_per_block();
}

template <typename T>
int chunks_of(long long n_pix, int C, bool vec) {
  return (int)(vec ? n_blocks<T, 16 / sizeof(T)>(n_pix, C) : n_blocks<T, 1>(n_pix, C));
}

template <typename T, int V, int kMode>
void launch_partial(const void* x, const void* dy, const uint8_t* mask, const void* inv,
                    const void* shift, const void* mean, long long n_pix, long long HW, int C,
                    void* part, cudaStream_t s) {
  const long long blocks = n_blocks<T, V>(n_pix, C);
  if (blocks > 0)
    partial_kernel<T, V, kMode><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
        (const float*)mean, n_pix, HW, C, (double*)part);
}

template <typename T>
int stats(const void* x, const uint8_t* mask, int N, long long HW, int C, void* part,
          void* mean, void* var, cudaStream_t s) {
  const long long n_pix = (long long)N * HW;
  const bool vec = vectorizable<T>(C, {x});
  if (vec)
    launch_partial<T, 16 / sizeof(T), 0>(x, nullptr, mask, nullptr, nullptr, nullptr, n_pix, HW,
                                          C, part, s);
  else
    launch_partial<T, 1, 0>(x, nullptr, mask, nullptr, nullptr, nullptr, n_pix, HW, C, part, s);
  stats_finalize_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(
      (const double*)part, chunks_of<T>(n_pix, C, vec), mask, N, HW, C, (float*)mean,
      (float*)var);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* dy, const uint8_t* mask, const void* inv,
             const void* shift, const void* mean, const void* rstd, int N, long long HW, int C,
             int train, void* part, void* sum_g, void* sum_gc, void* coef, void* dx,
             cudaStream_t s) {
  const long long n_pix = (long long)N * HW;
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorizable<T>(C, {x, dy, dx});
  if (vec)
    launch_partial<T, V, 1>(x, dy, mask, inv, shift, mean, n_pix, HW, C, part, s);
  else
    launch_partial<T, 1, 1>(x, dy, mask, inv, shift, mean, n_pix, HW, C, part, s);
  bwd_finalize_kernel<<<(C + 31) / 32, kThreads, 0, s>>>(
      (const double*)part, chunks_of<T>(n_pix, C, vec), mask, N, HW, C, (const float*)inv,
      (const float*)rstd, train, (float*)sum_g, (float*)sum_gc, (float*)coef);
  const long long n_val = n_pix * C;
  if (vec) {
    const long long blocks = grid_of(n_val / V);
    if (blocks > 0)
      dx_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
          (const float*)mean, (const float*)coef, HW, C, n_val / V, train, (T*)dx);
  } else {
    const long long blocks = grid_of(n_val);
    if (blocks > 0)
      dx_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
          (const float*)mean, (const float*)coef, HW, C, n_val, train, (T*)dx);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The number of partial rows (blocks of the partial pass) of a call: the
// wrapper allocates [chunks, C, 2] f64 scratch. Pointers only decide
// vectorization: pass those of the call (x; and dy, dx for K17) or null.
extern "C" int suo_bn_chunks(long long n_pix, int C, int dtype, const void* x, const void* dy,
                             const void* dx) {
  if (dtype == 0) return chunks_of<float>(n_pix, C, vectorizable<float>(C, {x, dy, dx}));
  return chunks_of<__nv_bfloat16>(n_pix, C, vectorizable<__nv_bfloat16>(C, {x, dy, dx}));
}

// K16. x [N, HW, C] (NHWC), mask [N] uint8 or null, part: chunks * C * 2 f64
// scratch; mean, var [C] f32. dtype: 0 = f32, 1 = bf16.
extern "C" int suo_bn_stats(const void* x, const void* mask, int N, long long HW, int C,
                            void* part, void* mean, void* var, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == 0) return stats<float>(x, m, N, HW, C, part, mean, var, s);
  return stats<__nv_bfloat16>(x, m, N, HW, C, part, mean, var, s);
}

// K17. x, dy, dx [N, HW, C] (NHWC); inv, shift, mean, rstd [C] f32 (mean = 0
// and rstd unused for train = 0); mask [N] uint8 or null; part as K16's;
// sum_g, sum_gc [C] f32; coef [C * 3] f32 scratch.
extern "C" int suo_norm_relu_bwd(const void* x, const void* dy, const void* mask,
                                 const void* inv, const void* shift, const void* mean,
                                 const void* rstd, int N, long long HW, int C, int train,
                                 void* part, void* sum_g, void* sum_gc, void* coef, void* dx,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == 0)
    return backward<float>(x, dy, m, inv, shift, mean, rstd, N, HW, C, train, part, sum_g,
                           sum_gc, coef, dx, s);
  return backward<__nv_bfloat16>(x, dy, m, inv, shift, mean, rstd, N, HW, C, train, part, sum_g,
                                 sum_gc, coef, dx, s);
}
