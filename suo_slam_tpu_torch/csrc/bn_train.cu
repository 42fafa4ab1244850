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
// in f64 sums (an f32 value and its square are exact in f64, so the order of
// the sums moves only the last bits of the f64 result), mean and var rounded
// once to f32. JAX takes two f32 passes; the f64 sums agree with them to f32
// rounding. With the affine (the train-mode norm's call) it also writes, in
// f32 operations each rounded once (--fmad=false), exactly what
// `MaskedBatchNorm` computed around it in eager ops:
//   rstd = rsqrt(var + eps), inv = rstd * scale, shift = bias - mean * inv,
//   running mean / var <- running * momentum + batch * (1 - momentum).
//
// K17 `norm_relu_bwd`: y = relu(cast(x * inv + shift)) with inv =
// rsqrt(var + eps) * scale and shift = bias - mean * inv (K8's forward). With
// g = dy * [y > 0] in f32 (the ReLU mask recomputed from x, inv and shift
// with K8's exact arithmetic) and xc = x - mean:
//   sum_g  = sum over ALL rows of g          (dbias, or d shift)
//   sum_gc = sum over ALL rows of g * xc     (d inv with mean = 0)
//   dscale = f32(sum_gc) * rstd              (train mode, the scale's gradient)
//   train: dx = inv * g - m_n * (inv * sum_g / M + xc * inv * rstd^2 * sum_gc / M)
//   fixed statistics (train = 0): dx = inv * g
// cast to x's dtype once. Padded rows (m_n = 0) carry gradient into the sums
// and their own dx (the validity loss reaches them) but not through the
// statistics, which they did not enter.
//
// Bound on this card: bytes. K16 reads x's real rows once (at the train
// step's largest norm, 32 x 64 x 64 x 256 bf16 with 8 rows padded, 50 MB:
// 15 us at 3.35 TB/s); K17 must read x and dy and write dx (201 MB: 60 us).
//
// Two designs.
//
// "fused" (the main path): one cooperative launch per call. A persistent
// grid (`models/hourglass.py` `plan_bn`: at most one CTA of kFThreads per SM,
// fewer for small tensors) gives each CTA a contiguous slab of the flattened
// pixels (K16: of the real rows' pixels, so padded rows cost neither bytes
// nor balance); a thread owns one 16-byte vector of channels and loads
// kStatsUnroll (K16) or kBwdUnroll pixels' vectors (K17: x and dy) before it
// uses any — addresses first, then the loads in one straight run, so no use
// of a loaded word (a bf16 unpack) lands between two loads and serializes
// them — so each SM keeps ~64 KB of loads in flight. Both add in f64 per
// value, as the split design and the plain versions do (x and x^2; g and
// g * xc, an exact f64 product): their sums then differ from the plain
// versions' only in the order of f64 additions, so the f32 statistics and
// dx coefficients round alike, which the ill-conditioned bf16 train step
// needs (f32 runs folded into f64 moved the last f32 bit of many channels,
// and the step's gradient cosine to the plain run fell from >= 0.99 to 0.93
// on an H100). The block's pixel lanes fold by warp shuffles where a warp
// holds several pixels of one channel vector, then across warps through
// shared memory, each in a fixed order; one f64 pair per channel and CTA
// goes to a scratch row. A grid barrier (an arrival counter, released by
// thread 0 of each CTA and spun on with acquire loads; the grid is
// co-resident by the cooperative launch) separates the partials from the
// finalize, spread over the grid: a warp per channel sums the CTAs' rows in
// index order (lanes, then a shuffle tree), or on a grid of at most
// kThreadSums CTAs a thread per channel in row order — deterministic, no
// atomics. K16 then ends. K17 in train mode writes the dx coefficients (inv,
// inv sum_g / M, inv rstd^2 sum_gc / M) to scratch, passes a second barrier,
// stages its channels' coefficients in shared memory once a CTA (every
// thread reading them from L2 met on a few lines: 215 -> 118 us at the
// step's largest norm) and walks its slab back in reverse, so its first
// tiles are the ones phase one read last; its loads and dx stores are
// streaming (evict-first). With fixed statistics dx needs no sum: one pass
// writes dx beside the partials. The last CTA to leave resets the counters,
// so every launch leaves its workspace as it found it
// (`hourglass._bn_workspace`, one per device and stream).
//
// "split" (the first design, kept for comparison): a partial pass of
// kThreads-blocks walking kIters pixels each with f64 accumulators per value,
// reducing its pixel lanes through shared memory 2 x V barriers, then a
// finalize of C / 32 blocks, then (K17) a dx pass: two (K16) or three (K17)
// launches per call.
//
// Cross-rank modes (data parallelism: one process a card, the statistics of
// the global batch; `models/hourglass.py` `bn_train_stats_cross`,
// `norm_relu_bwd_cross`). K16 "partial": the fused kernel up to its grid
// barrier, whose finalize then writes this rank's grid-reduced f64 sums
// sums[c * 2 + {0, 1}] = (sum x, sum x^2) and sums[2C] = its count of values
// (real rows x HW, or N x HW without a mask) instead of the statistics; the
// caller all-reduces sums (SUM), then K16 "finalize" (a thread a channel)
// writes mean, var, rstd, inv, shift and the running averages from them with
// M = max(sum of the counts, 1), by the fused epilogue's own operations
// (`bn_epilogue`). K17 "sums": the fused backward up to its first barrier,
// whose finalize writes sums = (sum g, sum g * xc) and the count, and this
// rank's sum_g, sum_gc and dscale (the parameters' gradients, which the step
// sums over the ranks afterwards); after the all-reduce K17 "dx" (the fused
// plan's grid, no barrier) stages each channel block's dx coefficients from
// the global sums (`dx_coefs`, the fused finalize's formula) and runs the
// fused dx walk. On one rank both pairs give the fused kernels' bits: the
// same partial rows, summed in the same order, through the same arithmetic.
//
// With `cycles` (int64 [rows, phases], zeros) thread 0 of each block adds its
// SM clock cycles per phase (`hourglass.BN_STATS_PHASES`,
// `BN_BWD_PHASES`) to its block's row: a load's wait is read by a volatile
// shared-memory store of the loaded word, which stalls until it arrives.

#include "channel_vec.cuh"

namespace {

constexpr int kFinLanes = 8;      // split: partial lanes per channel in the finalize
constexpr int kFThreads = 512;    // fused: threads of a CTA (one CTA per SM)
constexpr int kStatsUnroll = 8;   // fused K16: pixels a thread loads before using them
constexpr int kBwdUnroll = 4;     // fused K17: pixels (x and dy) a thread loads together
constexpr int kSumLoads = 5;      // fused finalize: a lane's partial rows loaded at once
constexpr int kThreadSums = 32;   // fused finalize: a thread per channel up to this grid
constexpr unsigned kFull = 0xffffffffu;

// phases of `cycles` (hourglass.BN_STATS_PHASES / BN_BWD_PHASES)
enum Phase { kLoad, kMath, kReduce, kBarrier, kFinalize, kBarrier2, kDx };
constexpr int kStatsPhases = 5, kBwdPhases = 7;

// K8's forward value before the ReLU, in the storage dtype, compared with 0:
// a product and a sum each rounded (--fmad=false), then the cast
template <typename T>
__device__ __forceinline__ bool relu_on(T x, float inv, float shift) {
  const float a = to_f(x) * inv;
  return to_f(from_f<T>(a + shift)) > 0.f;
}

// The same test on the f32 pre-activation s: for bf16, the cast rounds s to a
// positive bf16 exactly when s > 2^-134 (half the least bf16 subnormal, which
// rounds to even, to 0); NaN fails both. So relu_on(x) == relu_pre<T>(x * inv
// + shift) for every input.
template <typename T>
__device__ __forceinline__ bool relu_pre(float s) {
  if constexpr (sizeof(T) == 2) return s > 0x1p-134f;
  return s > 0.f;
}

// =========================================================== split design ==
// Partial sums of one block's span of the N * HW pixels: s1 and s2 per
// channel into part[block * C * 2 + c * 2 + {0, 1}].
// mode 0 (K16): s1 = sum x, s2 = sum x^2 over masked rows.
// mode 1 (K17): s1 = sum g, s2 = sum g * (x - mean) over every row.
template <typename T, int V, int kMode, bool kClock>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const uint8_t* __restrict__ mask, const float* __restrict__ inv,
               const float* __restrict__ shift, const float* __restrict__ mean,
               long long n_pix, long long HW, int C, double* __restrict__ part,
               long long* __restrict__ cycles, int n_phases) {
  Clk<kClock> clk(cycles ? cycles + (long long)blockIdx.x * n_phases : nullptr);
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
          clk.mark(kLoad, first_word(xv));
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const double v = (double)to_f(xv.v[k]);
            s1[k] += v;
            s2[k] += v * v;
          }
          clk.mark(kMath, low_word(s2[V - 1]));
        } else {
          const Vec<T, V> xv = load<T, V>(x + i0);
          const Vec<T, V> dv = load<T, V>(dy + i0);
          clk.mark(kLoad, first_word(xv) ^ first_word(dv));
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float g = relu_on(xv.v[k], iv[k], sh[k]) ? to_f(dv.v[k]) : 0.f;
            s1[k] += (double)g;
            s2[k] += (double)g * (double)(to_f(xv.v[k]) - mu[k]);
          }
          clk.mark(kMath, low_word(s2[V - 1]));
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
    clk.mark(kReduce);
  }
  clk.flush(n_phases);
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
template <bool kClock>
__global__ void __launch_bounds__(kThreads)
stats_finalize_kernel(const double* __restrict__ part, int n_part, const uint8_t* __restrict__ mask,
                      int N, long long HW, int C, float* __restrict__ mean,
                      float* __restrict__ var, long long* __restrict__ cycles) {
  Clk<kClock> clk(cycles ? cycles + (long long)blockIdx.x * kStatsPhases : nullptr);
  int c;
  double s1, s2;
  const bool mine = sum_partials(part, n_part, C, c, s1, s2);
  if (mine) {
    const double M = rows_count(mask, N, HW);
    const double mu = s1 / M;
    const double v = s2 / M - mu * mu;
    mean[c] = (float)mu;
    var[c] = (float)(v > 0.0 ? v : 0.0);
  }
  clk.mark(kFinalize, mine ? __float_as_uint(var[c]) : 0u);
  clk.flush(kStatsPhases);
}

// K17's finalize: the two sums (f32 outputs) and dx's per-channel
// coefficients coef[c] = (inv, inv * sum_g / M, inv * rstd^2 * sum_gc / M)
template <bool kClock>
__global__ void __launch_bounds__(kThreads)
bwd_finalize_kernel(const double* __restrict__ part, int n_part, const uint8_t* __restrict__ mask,
                    int N, long long HW, int C, const float* __restrict__ inv,
                    const float* __restrict__ rstd, int train, float* __restrict__ sum_g,
                    float* __restrict__ sum_gc, float* __restrict__ coef,
                    long long* __restrict__ cycles) {
  Clk<kClock> clk(cycles ? cycles + (long long)blockIdx.x * kBwdPhases : nullptr);
  int c;
  double s1, s2;
  if (sum_partials(part, n_part, C, c, s1, s2)) {
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
    clk.mark(kFinalize, __float_as_uint(coef[c * 3 + 2]));
  }
  clk.flush(kBwdPhases);
}

// K17's elementwise pass, a vector of V channels a thread:
// dx = a g - m_n (b + (x - mean) c), one rounding to T
template <typename T, int V, bool kClock>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const uint8_t* __restrict__ mask,
          const float* __restrict__ inv, const float* __restrict__ shift,
          const float* __restrict__ mean, const float* __restrict__ coef, long long HW, int C,
          long long n_vec, int train, T* __restrict__ dx, long long* __restrict__ cycles,
          long long rows) {
  Clk<kClock> clk(cycles && blockIdx.x < rows ? cycles + (long long)blockIdx.x * kBwdPhases
                                              : nullptr);
  const long long row = HW * C;
  unsigned dep = 0u;
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
    if constexpr (kClock) dep ^= first_word(out);
  }
  clk.mark(kDx, dep);
  clk.flush(kBwdPhases);
}

// =========================================================== fused design ==
// A fused CTA's thread layout for C channels in vectors of V: lanes_c
// channel-vector lanes x lanes_p pixel lanes (thread t = sub * lanes_c + jl);
// where lanes_c divides 32 a warp holds q = 32 / lanes_c pixel lanes of each
// channel vector and folds them by shuffles, leaving `rows` = lanes_p / q
// rows of per-channel sums for the cross-warp step (`hourglass.plan_bn`
// mirrors it).
struct FLayout {
  int cv, lanes_c, lanes_p, q, rows;
  __host__ __device__ FLayout(int C, int V) {
    cv = C / V;
    lanes_c = cv < kFThreads ? (cv > 0 ? cv : 1) : kFThreads;
    lanes_p = kFThreads / lanes_c;
    q = (lanes_c <= 32 && 32 % lanes_c == 0) ? 32 / lanes_c : 1;
    rows = lanes_p / q;
  }
  // doubles of the cross-warp reduction buffer
  __host__ __device__ long long red_doubles(int V) const {
    return (long long)rows * lanes_c * V * 2;
  }
};

struct StatsArgs {
  const void* x;
  const uint8_t* mask;  // [N] or null
  int N, C;
  long long HW;
  const float* scale;   // null: statistics only
  const float* bias;
  float eps, mom, mom1;  // f32(eps), f32(momentum), f32(1 - momentum)
  float* run_mean;      // null: no running update
  float* run_var;
  double* part;         // [grid, C, 2]
  unsigned* bar;        // [2] zeros, left zeros
  float *mean, *var, *rstd, *inv, *shift;
  long long* cycles;    // null or [grid, kStatsPhases]
  double* sums;         // non-null: the cross-rank partial mode ([2C + 1] out)
};

struct BwdArgs {
  const void *x, *dy;
  const uint8_t* mask;  // [N] or null (train mode only)
  const float *inv, *shift, *mean, *rstd;  // mean, rstd null: fixed statistics
  int N, C;
  long long HW;
  double* part;         // [grid, C, 2]
  unsigned* bar;        // [2] zeros, left zeros
  float* coef;          // [C, 3] scratch
  float *sum_g, *sum_gc, *dscale;
  void* dx;
  long long* cycles;    // null or [grid, kBwdPhases]
  double* sums;         // non-null: the cross-rank sums mode ([2C + 1] out);
                        // the dx mode: the all-reduced sums (in)
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

// The k-th grid barrier of a launch (k = 1, 2): every CTA's writes before it
// are visible to every CTA after it — the CTA's writes ordered before thread
// 0's release by the block barrier, its acquire before the CTA's reads by
// the next (no full fence).
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    add_release(bar);
    const unsigned target = k * gridDim.x;
    while (ld_acquire(bar) < target) {
    }
  }
  __syncthreads();
}

// After a CTA's last barrier: the last CTA to leave zeroes both counters
// (every CTA has passed every barrier by then).
__device__ __forceinline__ void grid_leave(unsigned* bar) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

// This CTA's pixel slab [*p0, *p1) of n items split over the grid
__device__ __forceinline__ void slab_of(long long n, long long* p0, long long* p1) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long a = (long long)blockIdx.x * per;
  *p0 = a < n ? a : n;
  *p1 = a + per < n ? a + per : n;
}

// The block's per-thread sums s1[V], s2[V] (channel vector jl of this
// channel block, pixel lane sub) folded over its pixel lanes in a fixed
// order — shuffles inside a warp, then the warps' rows in order through
// `red` — into out[c * 2 + {0, 1}] for the block's cblk channels.
template <int V>
__device__ __forceinline__ void block_reduce(double (&s1)[V], double (&s2)[V], const FLayout& L,
                                             int sub, int jl, int cblk, double* red,
                                             double* __restrict__ out) {
  const int t = threadIdx.x;
  int row = sub;
  if (L.q > 1) {
    for (int o = L.q / 2; o >= 1; o >>= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += __shfl_down_sync(kFull, s1[k], o * L.lanes_c);
        s2[k] += __shfl_down_sync(kFull, s2[k], o * L.lanes_c);
      }
    }
    row = (t & 31) < L.lanes_c ? t / 32 : -1;
  } else if (sub >= L.lanes_p) {
    row = -1;
  }
  const int width = L.lanes_c * V;
  if (row >= 0 && jl * V < cblk) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[((long long)row * width + jl * V + k) * 2] = s1[k];
      red[((long long)row * width + jl * V + k) * 2 + 1] = s2[k];
    }
  }
  __syncthreads();
  for (int i = t; i < 2 * cblk; i += kFThreads) {  // i = channel * 2 + sum
    double a = 0.0;
    for (int r = 0; r < L.rows; ++r) a += red[(long long)r * width * 2 + i];
    out[i] = a;
  }
  __syncthreads();
}

// Channel c's two sums over the grid's rows of part, in row order (lane l
// adds rows l, l + 32, ...; then a shuffle tree to lane 0). Every lane of the
// warp calls it; lane 0's values are the result.
__device__ __forceinline__ void grid_sums(const double* __restrict__ part, int C, int c,
                                          double& s1, double& s2) {
  const int lane = threadIdx.x & 31;
  double a = 0.0, b = 0.0;
  for (int i0 = lane; i0 < (int)gridDim.x; i0 += 32 * kSumLoads) {
    double2 p[kSumLoads];  // the lane's rows loaded together, then added in order
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int i = i0 + 32 * u;
      p[u] = i < (int)gridDim.x
                 ? __ldcg(reinterpret_cast<const double2*>(part + ((long long)i * C + c) * 2))
                 : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      a += p[u].x;
      b += p[u].y;
    }
  }
  for (int o = 16; o >= 1; o >>= 1) {
    a += __shfl_down_sync(kFull, a, o);
    b += __shfl_down_sync(kFull, b, o);
  }
  s1 = a;
  s2 = b;
}

// Channel c's two sums over the grid's rows of part in row order, on one
// thread (the finalize of a grid of at most kThreadSums CTAs: a thread per
// channel, where a warp per channel would walk a CTA's channels one by one).
__device__ __forceinline__ void thread_sums(const double* __restrict__ part, int C, int c,
                                            double& s1, double& s2) {
  double a = 0.0, b = 0.0;
  for (int i0 = 0; i0 < (int)gridDim.x; i0 += kSumLoads) {
    double2 p[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int i = i0 + u;
      p[u] = i < (int)gridDim.x
                 ? __ldcg(reinterpret_cast<const double2*>(part + ((long long)i * C + c) * 2))
                 : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      a += p[u].x;
      b += p[u].y;
    }
  }
  s1 = a;
  s2 = b;
}

// The finalize, spread over the grid: out(c, s1, s2) for every channel, on
// the thread that holds its sums — a thread per channel on a grid of at most
// kThreadSums CTAs, else a warp per channel (lane 0 calls out). CTA b takes
// the channels c = b (mod the grid).
template <typename Out>
__device__ __forceinline__ void finalize_channels(const double* __restrict__ part, int C,
                                                  Out out) {
  const int t = threadIdx.x;
  if (gridDim.x <= kThreadSums) {
    for (int c = blockIdx.x + gridDim.x * t; c < C; c += gridDim.x * kFThreads) {
      double s1, s2;
      thread_sums(part, C, c, s1, s2);
      out(c, s1, s2);
    }
    return;
  }
  for (int c = blockIdx.x + gridDim.x * (t / 32); c < C; c += gridDim.x * (kFThreads / 32)) {
    double s1, s2;
    grid_sums(part, C, c, s1, s2);
    if ((t & 31) == 0) out(c, s1, s2);
  }
}

// M of the statistics: the real rows' values (at least 1), all values
// without a mask — `rows_count` of the split design, from a row count
__device__ __forceinline__ double count_of(bool has_mask, long long real_rows, int N,
                                           long long HW) {
  if (!has_mask) return (double)N * (double)HW;
  const double cnt = (double)real_rows * (double)HW;
  return cnt > 1.0 ? cnt : 1.0;
}

// the number of rows mask marks, on a whole warp
__device__ __forceinline__ long long warp_count_rows(const uint8_t* mask, int N) {
  const int lane = threadIdx.x & 31;
  long long m = 0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    m += __popc(__ballot_sync(kFull, n < N && __ldg(mask + n) != 0));
  }
  return m;
}

// MaskedBatchNorm's eager f32 operations on channel c's sums, in order: the
// fused finalize's and the cross-rank finalize's one code
__device__ __forceinline__ void bn_epilogue(int c, double s1, double s2, double M,
                                            const float* scale, const float* bias, float eps,
                                            float mom, float mom1, float* run_mean,
                                            float* run_var, float* mean, float* var,
                                            float* rstd, float* inv, float* shift) {
  const double mu = s1 / M;
  const double v = s2 / M - mu * mu;
  const float mf = (float)mu, vf = (float)(v > 0.0 ? v : 0.0);
  mean[c] = mf;
  var[c] = vf;
  if (scale != nullptr) {
    const float rs = rsqrtf(vf + eps);
    const float iv = rs * scale[c];
    rstd[c] = rs;
    inv[c] = iv;
    shift[c] = bias[c] - mf * iv;
    if (run_mean != nullptr) {
      run_mean[c] = run_mean[c] * mom + mf * mom1;
      run_var[c] = run_var[c] * mom + vf * mom1;
    }
  }
}

// dx's per-channel coefficients (inv, inv sum_g / M, inv rstd^2 sum_gc / M)
// from channel c's sums: the fused finalize's and the dx mode's one code
__device__ __forceinline__ void dx_coefs(float inv_c, float rstd_c, double s1, double s2,
                                         double M, float& c0, float& c1, float& c2) {
  const double iv = (double)inv_c, r = (double)rstd_c;
  c0 = inv_c;
  c1 = (float)(iv * s1 / M);
  c2 = (float)(iv * r * r * s2 / M);
}

// K16, fused. Dynamic shared memory: the reduction rows, then the indices of
// the real rows (int [N]).
template <typename T, int V, bool kClock>
__global__ void __launch_bounds__(kFThreads, 1) bn_stats_fused_kernel(const StatsArgs a) {
  extern __shared__ double smem[];
  __shared__ int s_rows;
  Clk<kClock> clk(a.cycles ? a.cycles + (long long)blockIdx.x * kStatsPhases : nullptr);
  const FLayout L(a.C, V);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int C = a.C;
  const long long HW = a.HW;
  int* real = reinterpret_cast<int*>(smem + L.red_doubles(V));
  const int t = threadIdx.x, lane = t & 31;
  if (t < 32) {  // the real rows in order (warp 0: a ballot compaction)
    int R = 0;
    for (int n0 = 0; n0 < a.N; n0 += 32) {
      const int n = n0 + lane;
      const bool v = n < a.N && (a.mask == nullptr || __ldg(a.mask + n) != 0);
      const unsigned b = __ballot_sync(kFull, v);
      if (v) real[R + __popc(b & ((1u << lane) - 1u))] = n;
      R += __popc(b);
    }
    if (lane == 0) s_rows = R;
  }
  __syncthreads();
  const int R = s_rows;
  long long q0, q1;  // this CTA's slab of the real rows' R * HW pixels
  slab_of((long long)R * HW, &q0, &q1);
  const int sub = t / L.lanes_c, jl = t % L.lanes_c;
  const long long step = (long long)L.lanes_p * kStatsUnroll;
  double* part_row = a.part + (long long)blockIdx.x * C * 2;
  for (int jb = 0; jb < L.cv; jb += L.lanes_c) {  // channel-vector blocks when C / V > 512
    const int j = jb + jl;
    const bool active = sub < L.lanes_p && j < L.cv;
    double s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
    if (active && q0 + sub < q1) {
      // walk of the real-row index r of pixel q (q - r HW is its pixel in
      // row real[r]); one division per thread
      int r = (int)((q0 + sub) / HW);
      long long r_end = (long long)(r + 1) * HW;
      long long off = (long long)(real[r] - r) * HW;  // pixel = q + off
      const T* xj = x + (long long)j * V;
      for (long long qb = q0 + sub; qb < q1; qb += step) {
        // addresses first, then every load in one straight run (a pixel
        // past the slab loads its last one, and is not added): no use of a
        // loaded word sits between two loads
        long long at[kStatsUnroll];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) {
          long long q = qb + (long long)u * L.lanes_p;
          if (q >= q1) q = q1 - 1;
          while (q >= r_end) {
            ++r;
            r_end += HW;
            off = (long long)(real[r] - r) * HW;
          }
          at[u] = (q + off) * C;
        }
        Vec<T, V> xv[kStatsUnroll];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) xv[u] = ldv<T, V>(xj + at[u], false);
        clk.mark(kLoad, first_word(xv[0]));
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) {
          if (qb + (long long)u * L.lanes_p >= q1) continue;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const double v = (double)to_f(xv[u].v[k]);
            s1[k] += v;
            s2[k] = __fma_rn(v, v, s2[k]);  // v * v is exact in f64
          }
        }
        clk.mark(kMath, low_word(s2[V - 1]));
      }
    }
    const int left = L.cv - jb;
    block_reduce<V>(s1, s2, L, sub, jl, (left < L.lanes_c ? left : L.lanes_c) * V, smem,
                    part_row + (long long)jb * V * 2);
    clk.mark(kReduce);
  }
  grid_barrier(a.bar, 1u);
  clk.mark(kBarrier);
  grid_leave(a.bar);
  if (a.sums != nullptr) {  // cross-rank partial mode: this rank's sums and count
    if (blockIdx.x == 0 && t == 0)
      a.sums[2 * C] = (a.mask != nullptr ? (double)R : (double)a.N) * (double)HW;
    finalize_channels(a.part, C, [&](int c, double s1, double s2) {
      a.sums[c * 2] = s1;
      a.sums[c * 2 + 1] = s2;
    });
  } else {
    const double M = count_of(a.mask != nullptr, R, a.N, HW);
    finalize_channels(a.part, C, [&](int c, double s1, double s2) {
      bn_epilogue(c, s1, s2, M, a.scale, a.bias, a.eps, a.mom, a.mom1, a.run_mean, a.run_var,
                  a.mean, a.var, a.rstd, a.inv, a.shift);
    });
  }
  clk.mark(kFinalize);
  clk.flush(kStatsPhases);
}

// K17's dx pass over the slab [p0, p1), walked back: dx = a g - m_n (b +
// (x - mean) c) with (a, b, c) of each channel from stage(c, a, b, c), staged
// in cf [5][width] once a channel block. Returns the clock's dependency word.
template <typename T, int V, bool kClock, typename Stage>
__device__ __forceinline__ unsigned dx_walk(const BwdArgs& a, const FLayout& L, long long p0,
                                            long long p1, int sub, int jl, float* cf,
                                            Stage stage) {
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dy = static_cast<const T*>(a.dy);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int C = a.C, t = threadIdx.x;
  const long long HW = a.HW;
  const long long step = (long long)L.lanes_p * kBwdUnroll;
  unsigned dep = 0u;
  const int width = L.lanes_c * V;
  for (int jb = ((L.cv - 1) / L.lanes_c) * L.lanes_c; jb >= 0; jb -= L.lanes_c) {
    const int left = L.cv - jb, cblk = (left < L.lanes_c ? left : L.lanes_c) * V;
    __syncthreads();  // the previous channel block's readers are done
    for (int i = t; i < cblk; i += kFThreads) {
      const int c = jb * V + i;
      stage(c, cf[i], cf[width + i], cf[2 * width + i]);
      cf[3 * width + i] = __ldg(a.shift + c);
      cf[4 * width + i] = __ldg(a.mean + c);
    }
    __syncthreads();
    const int j = jb + jl;
    if (!(sub < L.lanes_p && j < L.cv) || p0 + sub >= p1) continue;
    float iv[V], sh[V], mu[V], cb[V], cc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = jl * V + k;
      iv[k] = cf[i];
      cb[k] = cf[width + i];
      cc[k] = cf[2 * width + i];
      sh[k] = cf[3 * width + i];
      mu[k] = cf[4 * width + i];
    }
    const long long cj = (long long)j * V;
    const long long n_it = (p1 - (p0 + sub) + step - 1) / step;
    long long pl = p0 + sub + (n_it - 1) * step + (long long)(kBwdUnroll - 1) * L.lanes_p;
    if (pl >= p1) pl = p1 - 1;
    long long n = pl / HW;  // the row walk, backwards (one division per thread)
    long long row_start = n * HW;
    bool on = a.mask == nullptr || __ldg(a.mask + n) != 0;
    for (long long i = n_it - 1; i >= 0; --i) {
      const long long pb = p0 + sub + i * step;
      Vec<T, V> xv[kBwdUnroll], dv[kBwdUnroll];
#pragma unroll
      for (int u = kBwdUnroll - 1; u >= 0; --u) {
        long long p = pb + (long long)u * L.lanes_p;
        if (p >= p1) p = p1 - 1;
        xv[u] = ldv<T, V>(x + p * C + cj, true);
        dv[u] = ldv<T, V>(dy + p * C + cj, true);
      }
#pragma unroll
      for (int u = kBwdUnroll - 1; u >= 0; --u) {
        const long long p = pb + (long long)u * L.lanes_p;
        if (p >= p1) continue;
        if (p < row_start) {
          do {
            --n;
            row_start -= HW;
          } while (p < row_start);
          on = a.mask == nullptr || __ldg(a.mask + n) != 0;
        }
        Vec<T, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = to_f(xv[u].v[k]);
          const float g = relu_pre<T>(xf * iv[k] + sh[k]) ? to_f(dv[u].v[k]) : 0.f;
          float d = iv[k] * g;
          if (on) d = d - (cb[k] + (xf - mu[k]) * cc[k]);
          out.v[k] = from_f<T>(d);
        }
        stv_cs<T, V>(dx + p * C + cj, out);
        if constexpr (kClock) dep ^= first_word(out);
      }
    }
  }
  return dep;
}

// K17, fused. Dynamic shared memory: the reduction rows, then a channel
// block's five dx coefficients (read once a CTA: every thread of the grid
// reading them from L2 would meet on a few lines).
template <typename T, int V, bool kClock>
__global__ void __launch_bounds__(kFThreads, 1) bn_bwd_fused_kernel(const BwdArgs a) {
  extern __shared__ double smem[];
  Clk<kClock> clk(a.cycles ? a.cycles + (long long)blockIdx.x * kBwdPhases : nullptr);
  const FLayout L(a.C, V);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dy = static_cast<const T*>(a.dy);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int C = a.C;
  const long long HW = a.HW;
  const bool train = a.rstd != nullptr;
  const int t = threadIdx.x;
  __shared__ long long s_rows;  // the real rows (read after the block barriers below)
  if (t < 32 && train && a.mask != nullptr) {
    const long long m = warp_count_rows(a.mask, a.N);
    if (t == 0) s_rows = m;
  }
  long long p0, p1;
  slab_of((long long)a.N * HW, &p0, &p1);
  const int sub = t / L.lanes_c, jl = t % L.lanes_c;
  const long long step = (long long)L.lanes_p * kBwdUnroll;
  double* part_row = a.part + (long long)blockIdx.x * C * 2;
  for (int jb = 0; jb < L.cv; jb += L.lanes_c) {
    const int j = jb + jl;
    const bool active = sub < L.lanes_p && j < L.cv;
    double s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
    if (active) {
      float iv[V], sh[V], mu[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        iv[k] = __ldg(a.inv + j * V + k);
        sh[k] = __ldg(a.shift + j * V + k);
        mu[k] = train ? __ldg(a.mean + j * V + k) : 0.f;
      }
      const long long cj = (long long)j * V;
      for (long long pb = p0 + sub; pb < p1; pb += step) {
        // every load in one straight run (a pixel past the slab loads its
        // last one, and is not used)
        Vec<T, V> xv[kBwdUnroll], dv[kBwdUnroll];
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          long long p = pb + (long long)u * L.lanes_p;
          if (p >= p1) p = p1 - 1;
          xv[u] = ldv<T, V>(x + p * C + cj, !train);
          dv[u] = ldv<T, V>(dy + p * C + cj, !train);
        }
        clk.mark(kLoad, first_word(xv[0]) ^ first_word(dv[0]));
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          if (pb + (long long)u * L.lanes_p >= p1) continue;
          Vec<T, V> out;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xf = to_f(xv[u].v[k]);
            const float g = relu_pre<T>(xf * iv[k] + sh[k]) ? to_f(dv[u].v[k]) : 0.f;
            const double gd = (double)g;
            s1[k] += gd;
            s2[k] = __fma_rn(gd, (double)(xf - mu[k]), s2[k]);  // the product is exact
            if (!train) out.v[k] = from_f<T>(iv[k] * g);
          }
          if (!train) stv_cs<T, V>(dx + (pb + (long long)u * L.lanes_p) * C + cj, out);
        }
        clk.mark(kMath, low_word(s2[V - 1]));
      }
    }
    const int left = L.cv - jb;
    block_reduce<V>(s1, s2, L, sub, jl, (left < L.lanes_c ? left : L.lanes_c) * V, smem,
                    part_row + (long long)jb * V * 2);
    clk.mark(kReduce);
  }
  grid_barrier(a.bar, 1u);
  clk.mark(kBarrier);
  const bool cross = a.sums != nullptr;  // the cross-rank sums mode ends here
  if (!train || cross) grid_leave(a.bar);
  // the finalize, a warp per channel over the grid
  if (cross) {
    if (blockIdx.x == 0 && t == 0)
      a.sums[2 * C] = (a.mask != nullptr ? (double)s_rows : (double)a.N) * (double)HW;
    finalize_channels(a.part, C, [&](int c, double s1, double s2) {
      const float sg = (float)s1, sgc = (float)s2;
      a.sums[c * 2] = s1;
      a.sums[c * 2 + 1] = s2;
      a.sum_g[c] = sg;
      a.sum_gc[c] = sgc;
      a.dscale[c] = sgc * a.rstd[c];
    });
    clk.mark(kFinalize);
    clk.flush(kBwdPhases);
    return;
  }
  const double M = count_of(a.mask != nullptr, s_rows, a.N, HW);
  finalize_channels(a.part, C, [&](int c, double s1, double s2) {
    const float sg = (float)s1, sgc = (float)s2;
    a.sum_g[c] = sg;
    a.sum_gc[c] = sgc;
    if (train) {
      const float rf = a.rstd[c];
      a.dscale[c] = sgc * rf;
      dx_coefs(a.inv[c], rf, s1, s2, M, a.coef[c * 3], a.coef[c * 3 + 1], a.coef[c * 3 + 2]);
    }
  });
  clk.mark(kFinalize);
  if (!train) {
    clk.flush(kBwdPhases);
    return;
  }
  grid_barrier(a.bar, 2u);
  clk.mark(kBarrier2);
  grid_leave(a.bar);
  const unsigned dep = dx_walk<T, V, kClock>(
      a, L, p0, p1, sub, jl, reinterpret_cast<float*>(smem + L.red_doubles(V)),
      [&](int c, float& c0, float& c1, float& c2) {
        c0 = __ldcg(a.coef + c * 3);
        c1 = __ldcg(a.coef + c * 3 + 1);
        c2 = __ldcg(a.coef + c * 3 + 2);
      });
  clk.mark(kDx, dep);
  clk.flush(kBwdPhases);
}

// K17's cross-rank dx mode, on the fused plan's grid (its slabs): each CTA
// stages its channel blocks' coefficients from the all-reduced sums (count at
// sums[2C]) and walks its slab as the fused kernel's last phase does. Dynamic
// shared memory: the fused layout's (the coefficients after the reduction
// rows, which this mode leaves unused).
template <typename T, int V>
__global__ void __launch_bounds__(kFThreads, 1) bn_bwd_dx_kernel(const BwdArgs a) {
  extern __shared__ double smem[];
  const FLayout L(a.C, V);
  long long p0, p1;
  slab_of((long long)a.N * a.HW, &p0, &p1);
  const int sub = threadIdx.x / L.lanes_c, jl = threadIdx.x % L.lanes_c;
  const double cnt = __ldg(a.sums + 2 * a.C);
  const double M = cnt > 1.0 ? cnt : 1.0;
  dx_walk<T, V, false>(a, L, p0, p1, sub, jl, reinterpret_cast<float*>(smem + L.red_doubles(V)),
                       [&](int c, float& c0, float& c1, float& c2) {
                         dx_coefs(__ldg(a.inv + c), __ldg(a.rstd + c), __ldg(a.sums + c * 2),
                                  __ldg(a.sums + c * 2 + 1), M, c0, c1, c2);
                       });
}

// K16's cross-rank finalize: a thread a channel, from the all-reduced sums
__global__ void __launch_bounds__(kThreads) bn_cross_finalize_kernel(const StatsArgs a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.C) return;
  const double cnt = a.sums[2 * a.C];
  bn_epilogue(c, a.sums[c * 2], a.sums[c * 2 + 1], cnt > 1.0 ? cnt : 1.0, a.scale, a.bias, a.eps,
              a.mom, a.mom1, a.run_mean, a.run_var, a.mean, a.var, a.rstd, a.inv, a.shift);
}

// ============================================================== launches ==
template <typename T, int V, int kMode, bool kClock>
void launch_partial(const void* x, const void* dy, const uint8_t* mask, const void* inv,
                    const void* shift, const void* mean, long long n_pix, long long HW, int C,
                    void* part, long long* cycles, cudaStream_t s) {
  const Layout L(C, V);
  const long long blocks = (n_pix + L.pixels_per_block() - 1) / L.pixels_per_block();
  if (blocks > 0)
    partial_kernel<T, V, kMode, kClock><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
        (const float*)mean, n_pix, HW, C, (double*)part, cycles,
        kMode == 0 ? kStatsPhases : kBwdPhases);
}

template <typename T, bool kClock>
int stats_split(const void* x, const uint8_t* mask, int N, long long HW, int C, void* part,
                int n_part, void* mean, void* var, long long* cycles, cudaStream_t s) {
  const long long n_pix = (long long)N * HW;
  if (vectorizable<T>(C, {x}))
    launch_partial<T, 16 / sizeof(T), 0, kClock>(x, nullptr, mask, nullptr, nullptr, nullptr,
                                                 n_pix, HW, C, part, cycles, s);
  else
    launch_partial<T, 1, 0, kClock>(x, nullptr, mask, nullptr, nullptr, nullptr, n_pix, HW, C,
                                    part, cycles, s);
  stats_finalize_kernel<kClock><<<(C + 31) / 32, kThreads, 0, s>>>(
      (const double*)part, n_part, mask, N, HW, C, (float*)mean, (float*)var, cycles);
  return (int)cudaGetLastError();
}

template <typename T, bool kClock>
int backward_split(const void* x, const void* dy, const uint8_t* mask, const void* inv,
                   const void* shift, const void* mean, const void* rstd, int N, long long HW,
                   int C, int train, void* part, int n_part, void* sum_g, void* sum_gc,
                   void* coef, void* dx, long long* cycles, cudaStream_t s) {
  const long long n_pix = (long long)N * HW;
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorizable<T>(C, {x, dy, dx});
  if (vec)
    launch_partial<T, V, 1, kClock>(x, dy, mask, inv, shift, mean, n_pix, HW, C, part, cycles, s);
  else
    launch_partial<T, 1, 1, kClock>(x, dy, mask, inv, shift, mean, n_pix, HW, C, part, cycles, s);
  bwd_finalize_kernel<kClock><<<(C + 31) / 32, kThreads, 0, s>>>(
      (const double*)part, n_part, mask, N, HW, C, (const float*)inv, (const float*)rstd, train,
      (float*)sum_g, (float*)sum_gc, (float*)coef, cycles);
  const long long n_val = n_pix * C;
  if (vec) {
    const long long blocks = grid_of(n_val / V);
    if (blocks > 0)
      dx_kernel<T, V, kClock><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
          (const float*)mean, (const float*)coef, HW, C, n_val / V, train, (T*)dx, cycles,
          n_part);
  } else {
    const long long blocks = grid_of(n_val);
    if (blocks > 0)
      dx_kernel<T, 1, kClock><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const T*)x, (const T*)dy, mask, (const float*)inv, (const float*)shift,
          (const float*)mean, (const float*)coef, HW, C, n_val, train, (T*)dx, cycles, n_part);
  }
  return (int)cudaGetLastError();
}

// One cooperative launch of kKernel on `grid` CTAs with `smem` bytes of
// dynamic shared memory (raised above the 48 KB default once per kernel
// instance, to the most asked so far).
template <typename Args, void (*kKernel)(Args)>
int launch_fused(const Args& a, int grid, int smem, cudaStream_t s) {
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int stats_fused_v(const StatsArgs& a, int grid, int smem, cudaStream_t s) {
  if (a.cycles != nullptr)
    return launch_fused<StatsArgs, bn_stats_fused_kernel<T, V, true>>(a, grid, smem, s);
  return launch_fused<StatsArgs, bn_stats_fused_kernel<T, V, false>>(a, grid, smem, s);
}

template <typename T, int V>
int bwd_fused_v(const BwdArgs& a, int grid, int smem, cudaStream_t s) {
  if (a.cycles != nullptr)
    return launch_fused<BwdArgs, bn_bwd_fused_kernel<T, V, true>>(a, grid, smem, s);
  return launch_fused<BwdArgs, bn_bwd_fused_kernel<T, V, false>>(a, grid, smem, s);
}

template <typename T, int V>
int bwd_dx_v(const BwdArgs& a, int grid, int smem, cudaStream_t s) {
  return launch_fused<BwdArgs, bn_bwd_dx_kernel<T, V>>(a, grid, smem, s);
}

}  // namespace

// ---------------------------------------------------------- the split design
// K16. x [N, HW, C] (NHWC), mask [N] uint8 or null, part: n_part * C * 2 f64
// scratch (n_part: the partial pass's blocks, `hourglass.plan_split`); mean,
// var [C] f32; cycles null or int64 zeros [rows, 5]. dtype: 0 = f32, 1 = bf16.
extern "C" int suo_bn_stats(const void* x, const void* mask, int N, long long HW, int C,
                            void* part, int n_part, void* mean, void* var, int dtype,
                            void* cycles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  long long* cy = (long long*)cycles;
  if (dtype == 0)
    return cy ? stats_split<float, true>(x, m, N, HW, C, part, n_part, mean, var, cy, s)
              : stats_split<float, false>(x, m, N, HW, C, part, n_part, mean, var, cy, s);
  return cy ? stats_split<__nv_bfloat16, true>(x, m, N, HW, C, part, n_part, mean, var, cy, s)
            : stats_split<__nv_bfloat16, false>(x, m, N, HW, C, part, n_part, mean, var, cy, s);
}

// K17. x, dy, dx [N, HW, C] (NHWC); inv, shift, mean, rstd [C] f32 (mean = 0
// and rstd unused for train = 0); mask [N] uint8 or null; part as K16's;
// sum_g, sum_gc [C] f32; coef [C * 3] f32 scratch; cycles null or int64
// zeros [rows, 7] (rows = n_part; dx blocks past it do not record).
extern "C" int suo_norm_relu_bwd(const void* x, const void* dy, const void* mask,
                                 const void* inv, const void* shift, const void* mean,
                                 const void* rstd, int N, long long HW, int C, int train,
                                 void* part, int n_part, void* sum_g, void* sum_gc, void* coef,
                                 void* dx, int dtype, void* cycles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  long long* cy = (long long*)cycles;
  if (dtype == 0)
    return cy ? backward_split<float, true>(x, dy, m, inv, shift, mean, rstd, N, HW, C, train,
                                            part, n_part, sum_g, sum_gc, coef, dx, cy, s)
              : backward_split<float, false>(x, dy, m, inv, shift, mean, rstd, N, HW, C, train,
                                             part, n_part, sum_g, sum_gc, coef, dx, cy, s);
  return cy ? backward_split<__nv_bfloat16, true>(x, dy, m, inv, shift, mean, rstd, N, HW, C,
                                                  train, part, n_part, sum_g, sum_gc, coef, dx,
                                                  cy, s)
            : backward_split<__nv_bfloat16, false>(x, dy, m, inv, shift, mean, rstd, N, HW, C,
                                                   train, part, n_part, sum_g, sum_gc, coef, dx,
                                                   cy, s);
}

// ---------------------------------------------------------- the fused design
// Both take the plan of `hourglass.plan_bn`: vec (1: 16-byte vectors), grid
// (CTAs, co-resident), smem (dynamic shared-memory bytes). bar: the
// workspace's two uint32 counters (zeros, left zeros); part: grid * C * 2
// f64 scratch.

// K16: x [N, HW, C]; mask [N] uint8 or null; scale, bias [C] f32 or null
// (statistics only: rstd, inv, shift untouched); run_mean, run_var [C] f32
// updated in place, or null; mean, var, rstd, inv, shift [C] f32 out.
extern "C" int suo_bn_stats_fused(const void* x, const void* mask, int N, long long HW, int C,
                                  const void* scale, const void* bias, float eps, float mom,
                                  float mom1, void* run_mean, void* run_var, void* part,
                                  void* bar, void* mean, void* var, void* rstd, void* inv,
                                  void* shift, int dtype, int vec, int grid, int smem,
                                  void* cycles, void* stream) {
  StatsArgs a = {};
  a.x = x;
  a.mask = (const uint8_t*)mask;
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.eps = eps;
  a.mom = mom;
  a.mom1 = mom1;
  a.run_mean = (float*)run_mean;
  a.run_var = (float*)run_var;
  a.part = (double*)part;
  a.bar = (unsigned*)bar;
  a.mean = (float*)mean;
  a.var = (float*)var;
  a.rstd = (float*)rstd;
  a.inv = (float*)inv;
  a.shift = (float*)shift;
  a.cycles = (long long*)cycles;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? stats_fused_v<float, 4>(a, grid, smem, s)
               : stats_fused_v<float, 1>(a, grid, smem, s);
  return vec ? stats_fused_v<__nv_bfloat16, 8>(a, grid, smem, s)
             : stats_fused_v<__nv_bfloat16, 1>(a, grid, smem, s);
}

// K17: x, dy, dx [N, HW, C]; mask [N] uint8 or null; inv, shift [C] f32;
// mean, rstd [C] f32 (train mode) or both null (fixed statistics); coef
// [C * 3] f32 scratch; sum_g, sum_gc [C] f32 out; dscale [C] f32 out (train
// mode).
extern "C" int suo_norm_relu_bwd_fused(const void* x, const void* dy, const void* mask,
                                       const void* inv, const void* shift, const void* mean,
                                       const void* rstd, int N, long long HW, int C, void* part,
                                       void* bar, void* coef, void* sum_g, void* sum_gc,
                                       void* dscale, void* dx, int dtype, int vec, int grid,
                                       int smem, void* cycles, void* stream) {
  BwdArgs a = {};
  a.x = x;
  a.dy = dy;
  a.mask = (const uint8_t*)mask;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.mean = (const float*)mean;
  a.rstd = (const float*)rstd;
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.part = (double*)part;
  a.bar = (unsigned*)bar;
  a.coef = (float*)coef;
  a.sum_g = (float*)sum_g;
  a.sum_gc = (float*)sum_gc;
  a.dscale = (float*)dscale;
  a.dx = dx;
  a.cycles = (long long*)cycles;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? bwd_fused_v<float, 4>(a, grid, smem, s) : bwd_fused_v<float, 1>(a, grid, smem, s);
  return vec ? bwd_fused_v<__nv_bfloat16, 8>(a, grid, smem, s)
             : bwd_fused_v<__nv_bfloat16, 1>(a, grid, smem, s);
}

// ------------------------------------------------------- the cross-rank modes
// K16 partial: as suo_bn_stats_fused without the affine, writing this rank's
// sums [2C + 1] f64 (per channel sum x, sum x^2; then the count of values).
extern "C" int suo_bn_stats_partial(const void* x, const void* mask, int N, long long HW, int C,
                                    void* part, void* bar, void* sums, int dtype, int vec,
                                    int grid, int smem, void* stream) {
  StatsArgs a = {};
  a.x = x;
  a.mask = (const uint8_t*)mask;
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.part = (double*)part;
  a.bar = (unsigned*)bar;
  a.sums = (double*)sums;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? stats_fused_v<float, 4>(a, grid, smem, s)
               : stats_fused_v<float, 1>(a, grid, smem, s);
  return vec ? stats_fused_v<__nv_bfloat16, 8>(a, grid, smem, s)
             : stats_fused_v<__nv_bfloat16, 1>(a, grid, smem, s);
}

// K16 finalize: from the all-reduced sums [2C + 1] f64, mean, var, rstd, inv,
// shift [C] f32 out and run_mean, run_var [C] f32 updated in place (or null).
extern "C" int suo_bn_stats_finalize(const void* sums, int C, const void* scale,
                                     const void* bias, float eps, float mom, float mom1,
                                     void* run_mean, void* run_var, void* mean, void* var,
                                     void* rstd, void* inv, void* shift, void* stream) {
  StatsArgs a = {};
  a.C = C;
  a.sums = (double*)sums;
  a.scale = (const float*)scale;
  a.bias = (const float*)bias;
  a.eps = eps;
  a.mom = mom;
  a.mom1 = mom1;
  a.run_mean = (float*)run_mean;
  a.run_var = (float*)run_var;
  a.mean = (float*)mean;
  a.var = (float*)var;
  a.rstd = (float*)rstd;
  a.inv = (float*)inv;
  a.shift = (float*)shift;
  bn_cross_finalize_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K17 sums: train mode (mean, rstd given), as suo_norm_relu_bwd_fused up to its
// first barrier: sums [2C + 1] f64 out (sum g, sum g * xc; the count), and
// this rank's sum_g, sum_gc, dscale [C] f32; no dx.
extern "C" int suo_norm_relu_bwd_sums(const void* x, const void* dy, const void* mask,
                                      const void* inv, const void* shift, const void* mean,
                                      const void* rstd, int N, long long HW, int C, void* part,
                                      void* bar, void* sums, void* sum_g, void* sum_gc,
                                      void* dscale, int dtype, int vec, int grid, int smem,
                                      void* stream) {
  BwdArgs a = {};
  a.x = x;
  a.dy = dy;
  a.mask = (const uint8_t*)mask;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.mean = (const float*)mean;
  a.rstd = (const float*)rstd;
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.part = (double*)part;
  a.bar = (unsigned*)bar;
  a.sum_g = (float*)sum_g;
  a.sum_gc = (float*)sum_gc;
  a.dscale = (float*)dscale;
  a.sums = (double*)sums;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? bwd_fused_v<float, 4>(a, grid, smem, s) : bwd_fused_v<float, 1>(a, grid, smem, s);
  return vec ? bwd_fused_v<__nv_bfloat16, 8>(a, grid, smem, s)
             : bwd_fused_v<__nv_bfloat16, 1>(a, grid, smem, s);
}

// K17 dx: dx [N, HW, C] from the all-reduced sums [2C + 1] f64, on the fused
// plan's grid and shared memory (the K17 "bwd" plan).
extern "C" int suo_norm_relu_bwd_dx(const void* x, const void* dy, const void* mask,
                                    const void* inv, const void* shift, const void* mean,
                                    const void* rstd, const void* sums, int N, long long HW,
                                    int C, void* dx, int dtype, int vec, int grid, int smem,
                                    void* stream) {
  BwdArgs a = {};
  a.x = x;
  a.dy = dy;
  a.mask = (const uint8_t*)mask;
  a.inv = (const float*)inv;
  a.shift = (const float*)shift;
  a.mean = (const float*)mean;
  a.rstd = (const float*)rstd;
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.sums = (double*)sums;
  a.dx = dx;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? bwd_dx_v<float, 4>(a, grid, smem, s) : bwd_dx_v<float, 1>(a, grid, smem, s);
  return vec ? bwd_dx_v<__nv_bfloat16, 8>(a, grid, smem, s)
             : bwd_dx_v<__nv_bfloat16, 1>(a, grid, smem, s);
}
