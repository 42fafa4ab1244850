// K2 — heatmap readout: per-(crop, keypoint) spatial softmax + soft-argmax
// mean and covariance, plus the mean-pooled logit for the validity head; and
// K19 — its backward.
//
// Replaces `suo_slam_tpu/ops/heatmap.py` `spatial_softmax` + `soft_argmax`
// (what `models/pkpnet.py:127-133` calls) and `soft_argmax_from_logits`.
// On the TPU the moments are one [N*K, HW] x [HW, 6] MXU contraction. Here,
// per (n, k) plane, in f32: the max, then the six exp-weighted moments
// 1, u, v, u^2, v^2, uv:
//   uv  = (E[u], E[v]),  cov = E[pp^T] - uv uv^T + min_var * I,
//   pooled = mean of the raw logits (the validity head's input).
// Logits are f32 or bf16 (the int8 engine's head, `int8_forward.py:526-543`):
// for bf16 the shifted logit l - max rounds to bf16 before the f32 exp, as
// JAX subtracts in the logits' dtype (`ops/heatmap.py:84-85`), so the true
// per-plane max comes first (no online rescaling); the moments and the
// pooled mean stay f32.
//
// Bound on this card: bytes. At the main path's shapes (8 x 64 x 64 x 41
// f32) it must read 5.4 MB once: ~1.6 us at 3.35 TB/s; the outputs are 8 KB.
//
// Dense path (`heatmap_readout_kernel_dense`; `ops/heatmap.py`
// `plan_readout` picks it): the head's logits are NHWC views of a
// channels_last tensor, K = 41 innermost, and a crop's [H, W, K] slab (or
// [W, H, K] under transpose_heatmaps) is one contiguous block. A thread-block cluster of
// kCluster CTAs owns a crop; each CTA copies a strip of `rows` storage rows
// into shared memory by TMA bulk copies (one per row, each on its own
// mbarrier: coalesced, device memory read once), and its threads take one
// channel each over a stride of positions (thread t: channel t % K), so a
// warp reads consecutive shared-memory words. Pass 1 takes each channel's
// max and sum over the strip as the rows land; each CTA pushes its partials
// into the shared memory of the CTAs that need them (distributed shared
// memory: stores only, no remote load waits), and after a cluster barrier
// every CTA combines them in rank order. Pass 2 forms the moments from
// shared memory, factored by storage row (per row: sum e, sum e c,
// sum e c^2 over the row's inner coordinate c; the row's own coordinate
// multiplies them once); the CTAs push their partials to rank 0, which
// combines them in rank order after a second barrier and writes the
// outputs. The threads' partials are summed over (quantity, channel) pairs
// in parallel. Every sum runs in a
// fixed order that depends on the crop alone, so a crop's outputs are the
// same bits in any batch.
//
// Strided path (`heatmap_readout_kernel`, the earlier design; any strides):
// one 256-thread block per plane, two reads of it. On the channels_last
// head output neighbouring threads read values K x 4 bytes apart, one
// 32-byte sector each (8x the useful bytes in f32).
//
// K19 `heatmap_readout_bwd`: the gradient of the logits from those of uv,
// cov and pooled — what JAX derives for `spatial_softmax` -> `soft_argmax`
// and the mean pool of `models/pkpnet.py:125-128`. With p the softmax, the
// moments E[.] under p, f the derivative of the outputs in p,
//   f = du u + dv v + Dcuu (u^2 - 2 E[u] u) + Dcvv (v^2 - 2 E[v] v)
//       + Dcuv (u v - E[v] u - E[u] v),   Dcuv = dcov[0,1] + dcov[1,0],
//   d logit = p (f - E[f]) + d pooled / (H W),
// with E[f] = du E[u] + dv E[v] + Dcuu (E[u^2] - 2 E[u]^2)
//       + Dcvv (E[v^2] - 2 E[v]^2) + Dcuv (E[uv] - 2 E[u] E[v]).
// f32 throughout; the result rounds once to the logits' dtype. The max and
// the moments are recomputed from the logits, as K2 computes them. Bound:
// bytes, the logits read once and their gradient written once (at the train
// step's 32 x 41 planes of 64 x 64 f32: 21.5 MB, 6.4 us at 3.35 TB/s).
// Dense path (`heatmap_readout_bwd_kernel_dense`, the main path's:
// `ops/heatmap.py` `plan_readout_bwd` picks it wherever K2's dense path
// takes the layout): K2's cluster of kCluster CTAs per crop and its strip of
// storage rows, copied into shared memory once by TMA; pass 1 the channels'
// maxima, pushed to every CTA; pass 2 the six moments, pushed to EVERY CTA
// too (each needs E[u], E[v], E[u^2], E[v^2], E[uv] and so E[f]) and
// combined in rank order, so every CTA holds the same bits; pass 3 forms
// d logit in place in the strip (each thread its own positions) and the CTA
// writes the strip back with 16-byte stores in the slab's storage order. The
// logits are read from device memory once (the strided path read them three
// times, 41 x 4 bytes apart); every sum runs in a fixed order per crop, so a
// crop's gradient is the same bits in any batch. Strided path
// (`heatmap_readout_bwd_kernel`, the earlier design, for other layouts): a
// block per plane, three passes, written with the strides the caller gives.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// the shifted logit in the logits' dtype
__device__ __forceinline__ float shifted(float x, float shift, float) { return x - shift; }
__device__ __forceinline__ float shifted(float x, float shift, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x - shift));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
heatmap_readout_kernel(const T* __restrict__ logits, long long sn,
                       long long sh, long long sw, long long sk, int H, int W,
                       int K, float min_var, float* __restrict__ uv,
                       float* __restrict__ cov, float* __restrict__ pooled) {
  const int plane = blockIdx.x;  // n * K + k
  const int n = plane / K, k = plane % K;
  const T* base = logits + n * sn + k * sk;
  const int P = H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float red[6][kWarps];

  // pass 1: max (softmax shift) and sum (pooled mean)
  float mx = -FLT_MAX, sm = 0.f;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int h = p / W, w = p % W;
    const float x = to_f32(base[h * sh + w * sw]);
    mx = fmaxf(mx, x);
    sm += x;
  }
  mx = warp_max(mx);
  sm = warp_sum(sm);
  if (lane == 0) { red[0][warp] = mx; red[1][warp] = sm; }
  __syncthreads();
  if (warp == 0) {
    float a = lane < kWarps ? red[0][lane] : -FLT_MAX;
    float s = lane < kWarps ? red[1][lane] : 0.f;
    a = warp_max(a);
    s = warp_sum(s);
    if (lane == 0) { red[0][0] = a; red[1][0] = s; }
  }
  __syncthreads();
  const float shift = red[0][0];
  const float total = red[1][0];
  __syncthreads();

  // pass 2: the six exp-weighted moments over the NDC pixel-centre grid
  const float hw = 0.5f * (float)W, hh = 0.5f * (float)H;
  float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int h = p / W, w = p % W;
    const float e = expf(shifted(to_f32(base[h * sh + w * sw]), shift, T()));
    const float u = ((float)w + 0.5f) / hw - 1.f;
    const float v = 1.f - ((float)h + 0.5f) / hh;
    m[0] += e;
    m[1] += e * u;
    m[2] += e * v;
    m[3] += e * (u * u);
    m[4] += e * (v * v);
    m[5] += e * (u * v);
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float s = warp_sum(m[f]);
    if (lane == 0) red[f][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float s[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) s[f] = warp_sum(lane < kWarps ? red[f][lane] : 0.f);
    if (lane == 0) {
      const float z = fmaxf(s[0], FLT_MIN);
      const float eu = s[1] / z, ev = s[2] / z;
      const float euu = s[3] / z, evv = s[4] / z, euv = s[5] / z;
      uv[plane * 2 + 0] = eu;
      uv[plane * 2 + 1] = ev;
      const float cuv = euv - eu * ev;
      cov[plane * 4 + 0] = euu - eu * eu + min_var;
      cov[plane * 4 + 1] = cuv;
      cov[plane * 4 + 2] = cuv;
      cov[plane * 4 + 3] = evv - ev * ev + min_var;
      pooled[plane] = total / (float)P;
    }
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
heatmap_readout_bwd_kernel(const T* __restrict__ logits, long long sn, long long sh,
                           long long sw, long long sk, int H, int W, int K,
                           const float* __restrict__ guv, const float* __restrict__ gcov,
                           const float* __restrict__ gpool, T* __restrict__ dl, long long dn,
                           long long dh, long long dw, long long dk) {
  const int plane = blockIdx.x;  // n * K + k
  const int n = plane / K, k = plane % K;
  const T* base = logits + n * sn + k * sk;
  T* dbase = dl + n * dn + k * dk;
  const int P = H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float red[6][kWarps];

  // pass 1: the softmax shift
  float mx = -FLT_MAX;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int h = p / W, w = p % W;
    mx = fmaxf(mx, to_f32(base[h * sh + w * sw]));
  }
  mx = warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  if (warp == 0) {
    float a = lane < kWarps ? red[0][lane] : -FLT_MAX;
    a = warp_max(a);
    if (lane == 0) red[0][0] = a;
  }
  __syncthreads();
  const float shift = red[0][0];
  __syncthreads();

  // pass 2: the normalizer and the five moments
  const float hw = 0.5f * (float)W, hh = 0.5f * (float)H;
  float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int h = p / W, w = p % W;
    const float e = expf(shifted(to_f32(base[h * sh + w * sw]), shift, T()));
    const float u = ((float)w + 0.5f) / hw - 1.f;
    const float v = 1.f - ((float)h + 0.5f) / hh;
    m[0] += e;
    m[1] += e * u;
    m[2] += e * v;
    m[3] += e * (u * u);
    m[4] += e * (v * v);
    m[5] += e * (u * v);
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float s = warp_sum(m[f]);
    if (lane == 0) red[f][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float s[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) s[f] = warp_sum(lane < kWarps ? red[f][lane] : 0.f);
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < 6; ++f) red[f][0] = s[f];
    }
  }
  __syncthreads();
  const float z = fmaxf(red[0][0], FLT_MIN);
  const float eu = red[1][0] / z, ev = red[2][0] / z;
  const float euu = red[3][0] / z, evv = red[4][0] / z, euv = red[5][0] / z;
  const float du = guv[plane * 2], dv = guv[plane * 2 + 1];
  const float dcuu = gcov[plane * 4], dcvv = gcov[plane * 4 + 3];
  const float dcuv = gcov[plane * 4 + 1] + gcov[plane * 4 + 2];
  const float ef = du * eu + dv * ev + dcuu * (euu - 2.f * eu * eu) +
                   dcvv * (evv - 2.f * ev * ev) + dcuv * (euv - 2.f * eu * ev);
  const float dpool = gpool[plane] / (float)P;

  // pass 3: write p (f - E[f]) + d pooled / P
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int h = p / W, w = p % W;
    const float e = expf(shifted(to_f32(base[h * sh + w * sw]), shift, T()));
    const float u = ((float)w + 0.5f) / hw - 1.f;
    const float v = 1.f - ((float)h + 0.5f) / hh;
    const float f = du * u + dv * v + dcuu * (u * u - 2.f * eu * u) +
                    dcvv * (v * v - 2.f * ev * v) + dcuv * (u * v - ev * u - eu * v);
    dbase[h * dh + w * dw] = from_f32<T>((e / z) * (f - ef) + dpool);
  }
}

// ---- the dense path ------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kMaxDenseThreads = 1024;
constexpr int kMaxStripRows = 32;  // storage rows of a CTA's strip (one mbarrier each)
constexpr int kMaxK = 64;          // channels
constexpr int kCluster = 8;        // CTAs per crop (the portable cluster size)
constexpr int kPer = 8;            // inner positions of a row per thread

struct DenseArgs {
  const void* logits;
  long long sn;     // elements between crops
  int A, Bd, K;     // a crop in storage order [A, Bd, K]
  int transposed;   // 0: A = H, Bd = W; 1: A = W, Bd = H (transpose_heatmaps)
  int rows;         // storage rows of each CTA's strip
  int J;            // threads per channel: J * kPer = Bd
  int strip_bytes;  // the strip's space (at least the moments' scratch), 16-byte multiple
  float min_var;
  float* uv;
  float* cov;
  float* pooled;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A thread takes kPer inner positions of a row (b = j + q J, q < kPer), an
// exact count, so the loops unroll with no idle slot
template <typename T>
__global__ void __launch_bounds__(kMaxDenseThreads, 1)
heatmap_readout_kernel_dense(DenseArgs a) {
  // dynamic: the strip, whose space holds the per-thread moments after pass
  // 2 (6 x blockDim floats); then what the other CTAs push: the moments'
  // partials (at rank 0) [cluster][6][K], the maxima [cluster][K] and the
  // sums (at rank 0) [cluster][K]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* strip = reinterpret_cast<T*>(smem_raw);
  float* red2 = reinterpret_cast<float*>(smem_raw);  // [6][blockDim]
  __shared__ __align__(8) uint64_t bars[kMaxStripRows];
  __shared__ float red1[2][kMaxDenseThreads];
  __shared__ float gmax[kMaxK];
  __shared__ float ca[kMaxStripRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* rmom = reinterpret_cast<float*>(smem_raw + a.strip_bytes);
  float* rmax = rmom + kCluster * 6 * a.K;
  float* rsum = rmax + kCluster * a.K;
  const int n = blockIdx.x / kCluster;
  const int K = a.K, Bd = a.Bd, A = a.A;
  const int a0 = rank * a.rows;
  const int nrows = max(0, min(a.rows, A - a0));
  const int row_elems = Bd * K;
  const T* src = static_cast<const T*>(a.logits) + n * a.sn + (long long)a0 * row_elems;
  const int t = threadIdx.x, nt = blockDim.x;
  const int J = a.J;  // threads per channel
  const int j = t / K, k = t - j * K;
  const bool active = j < J;

  if (t < nrows) {  // thread r: row r's barrier and copy
    mbar_init(&bars[t], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster must have started before another writes into
  // its shared memory: arrive now, wait just before the first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();
  if (t < nrows) {
    const uint32_t row_bytes = (uint32_t)(row_elems * sizeof(T));
    mbar_expect_tx(&bars[t], row_bytes);
    bulk_load(strip + (long long)t * row_elems, src + (long long)t * row_elems, row_bytes,
              &bars[t]);
  }
  // the NDC coordinates (pixel centres; v up) while the rows land: c_a of
  // the strip's rows, c_b of the thread's inner positions b = j + q J
  const float hb = 0.5f * (float)Bd, ha = 0.5f * (float)A;
  for (int r = t; r < nrows; r += nt) {
    const float x = (float)(a0 + r) + 0.5f;
    ca[r] = a.transposed ? x / ha - 1.f : 1.f - x / ha;
  }
  float cb[kPer], cb2[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float x = (float)(j + q * J) + 0.5f;
    cb[q] = a.transposed ? 1.f - x / hb : x / hb - 1.f;
    cb2[q] = cb[q] * cb[q];
  }

  // pass 1: each channel's max (softmax shift) and sum (pooled mean)
  float mx = -FLT_MAX, sm = 0.f;
  for (int r = 0; r < nrows; ++r) {
    mbar_wait(&bars[r], 0);
    if (active) {
      const T* row = strip + r * row_elems + j * K + k;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float x = to_f32(row[q * J * K]);
        mx = fmaxf(mx, x);
        sm += x;
      }
    }
  }
  red1[0][t] = mx;
  red1[1][t] = sm;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < 2 * K) {  // (quantity, channel): over the channel's threads in order, then pushed
    const int f = t / K, c = t - f * K;
    float v = red1[f][c];
    for (int q = 1; q < J; ++q) v = f ? v + red1[1][q * K + c] : fmaxf(v, red1[0][q * K + c]);
    if (f == 0) {
      for (int d = 0; d < kCluster; ++d) cluster.map_shared_rank(rmax + rank * K + c, d)[0] = v;
    } else {
      cluster.map_shared_rank(rsum + rank * K + c, 0)[0] = v;
    }
  }
  cluster.sync();
  if (t < K) {
    float m = rmax[t];
    for (int c = 1; c < kCluster; ++c) m = fmaxf(m, rmax[c * K + t]);
    gmax[t] = m;
    if (rank == 0) {
      float s = rsum[t];
      for (int c = 1; c < kCluster; ++c) s += rsum[c * K + t];
      a.pooled[n * K + t] = s / (float)(A * Bd);
    }
  }
  __syncthreads();

  // pass 2: the moments, per storage row (coordinate c_a) over its inner
  // coordinate c_b: M0 = sum e, A1 = sum e c_a, B1 = sum e c_b,
  // AA = sum e c_a^2, BB = sum e c_b^2, AB = sum e c_a c_b
  float m0 = 0.f, a1 = 0.f, b1 = 0.f, aa = 0.f, bb = 0.f, ab = 0.f;
  if (active) {
    const float shift = gmax[k];
    for (int r = 0; r < nrows; ++r) {
      const T* row = strip + r * row_elems + j * K + k;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float e = expf(shifted(to_f32(row[q * J * K]), shift, T()));
        s0 += e;
        s1 += e * cb[q];
        s2 += e * cb2[q];
      }
      const float c = ca[r];
      m0 += s0;
      a1 += c * s0;
      b1 += s1;
      aa += (c * c) * s0;
      bb += s2;
      ab += c * s1;
    }
  }
  __syncthreads();  // the strip is read; its space takes the per-thread moments
  red2[0 * nt + t] = m0;
  red2[1 * nt + t] = a1;
  red2[2 * nt + t] = b1;
  red2[3 * nt + t] = aa;
  red2[4 * nt + t] = bb;
  red2[5 * nt + t] = ab;
  __syncthreads();
  if (t < 6 * K) {  // (moment, channel) over the channel's threads in order, pushed to rank 0
    const int f = t / K, c = t - f * K;
    const float* rf = red2 + f * nt + c;
    float v = rf[0];
    for (int q = 1; q < J; ++q) v += rf[q * K];
    cluster.map_shared_rank(rmom + (rank * 6 + f) * K + c, 0)[0] = v;
  }
  cluster.sync();
  if (rank == 0 && t < K) {
    float s[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      s[f] = rmom[f * K + t];
      for (int c = 1; c < kCluster; ++c) s[f] += rmom[(c * 6 + f) * K + t];
    }
    // storage moments -> (u, v): u is the inner coordinate unless transposed
    const float su = a.transposed ? s[1] : s[2], sv = a.transposed ? s[2] : s[1];
    const float suu = a.transposed ? s[3] : s[4], svv = a.transposed ? s[4] : s[3];
    const float z = fmaxf(s[0], FLT_MIN);
    const float eu = su / z, ev = sv / z;
    const float euu = suu / z, evv = svv / z, euv = s[5] / z;
    const int plane = n * K + t;
    a.uv[plane * 2 + 0] = eu;
    a.uv[plane * 2 + 1] = ev;
    const float cuv = euv - eu * ev;
    a.cov[plane * 4 + 0] = euu - eu * eu + a.min_var;
    a.cov[plane * 4 + 1] = cuv;
    a.cov[plane * 4 + 2] = cuv;
    a.cov[plane * 4 + 3] = evv - ev * ev + a.min_var;
  }
  // no CTA touches another's shared memory after the last cluster barrier
}

struct DenseBwdArgs {
  const void* logits;
  long long sn;     // elements between crops of the logits
  void* dl;         // the gradient, the logits' storage order
  long long dn;     // elements between crops of dl
  int A, Bd, K;     // a crop in storage order [A, Bd, K]
  int transposed;   // as DenseArgs
  int rows;         // storage rows of each CTA's strip
  int J;            // threads per channel: J * kPer = Bd
  int strip_bytes;  // the strip's space, a 16-byte multiple
  const float* guv;    // [N, K, 2]
  const float* gcov;   // [N, K, 2, 2]
  const float* gpool;  // [N, K]
};

// the per-channel values pass 3 reads: shift, 1 / z folded as z, E[u],
// E[v], du, dv, dcuu, dcvv, dcuv, E[f], d pooled / (H W)
enum { cShift, cZ, cEu, cEv, cDu, cDv, cDuu, cDvv, cDuv, cEf, cPool, kCoef };

template <typename T>
__global__ void __launch_bounds__(kMaxDenseThreads, 1)
heatmap_readout_bwd_kernel_dense(DenseBwdArgs a) {
  // dynamic: the strip; the per-thread moments [6][blockDim]; what the
  // other CTAs push: the moments' partials [cluster][6][K] and the maxima
  // [cluster][K] (at every rank)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* strip = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t bars[kMaxStripRows];
  __shared__ float red1[kMaxDenseThreads];
  __shared__ float cf[kCoef][kMaxK];
  __shared__ float ca[kMaxStripRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, nt = blockDim.x;
  float* red2 = reinterpret_cast<float*>(smem_raw + a.strip_bytes);  // [6][nt]
  float* rmom = red2 + 6 * nt;
  float* rmax = rmom + kCluster * 6 * a.K;
  const int n = blockIdx.x / kCluster;
  const int K = a.K, Bd = a.Bd, A = a.A;
  const int a0 = rank * a.rows;
  const int nrows = max(0, min(a.rows, A - a0));
  const int row_elems = Bd * K;
  const T* src = static_cast<const T*>(a.logits) + n * a.sn + (long long)a0 * row_elems;
  const int J = a.J;
  const int j = t / K, k = t - j * K;
  const bool active = j < J;

  if (t < nrows) {
    mbar_init(&bars[t], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();
  if (t < nrows) {
    const uint32_t row_bytes = (uint32_t)(row_elems * sizeof(T));
    mbar_expect_tx(&bars[t], row_bytes);
    bulk_load(strip + (long long)t * row_elems, src + (long long)t * row_elems, row_bytes,
              &bars[t]);
  }
  const float hb = 0.5f * (float)Bd, ha = 0.5f * (float)A;
  for (int r = t; r < nrows; r += nt) {
    const float x = (float)(a0 + r) + 0.5f;
    ca[r] = a.transposed ? x / ha - 1.f : 1.f - x / ha;
  }
  float cb[kPer], cb2[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float x = (float)(j + q * J) + 0.5f;
    cb[q] = a.transposed ? 1.f - x / hb : x / hb - 1.f;
    cb2[q] = cb[q] * cb[q];
  }

  // pass 1: each channel's max, pushed to every CTA
  float mx = -FLT_MAX;
  for (int r = 0; r < nrows; ++r) {
    mbar_wait(&bars[r], 0);
    if (active) {
      const T* row = strip + r * row_elems + j * K + k;
#pragma unroll
      for (int q = 0; q < kPer; ++q) mx = fmaxf(mx, to_f32(row[q * J * K]));
    }
  }
  red1[t] = mx;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < K) {
    float v = red1[t];
    for (int q = 1; q < J; ++q) v = fmaxf(v, red1[q * K + t]);
    for (int d = 0; d < kCluster; ++d) cluster.map_shared_rank(rmax + rank * K + t, d)[0] = v;
  }
  cluster.sync();
  if (t < K) {
    float m = rmax[t];
    for (int c = 1; c < kCluster; ++c) m = fmaxf(m, rmax[c * K + t]);
    cf[cShift][t] = m;
  }
  __syncthreads();

  // pass 2: the moments in storage coordinates (K2's), pushed to every CTA
  float m0 = 0.f, a1 = 0.f, b1 = 0.f, aa = 0.f, bb = 0.f, ab = 0.f;
  if (active) {
    const float shift = cf[cShift][k];
    for (int r = 0; r < nrows; ++r) {
      const T* row = strip + r * row_elems + j * K + k;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float e = expf(shifted(to_f32(row[q * J * K]), shift, T()));
        s0 += e;
        s1 += e * cb[q];
        s2 += e * cb2[q];
      }
      const float c = ca[r];
      m0 += s0;
      a1 += c * s0;
      b1 += s1;
      aa += (c * c) * s0;
      bb += s2;
      ab += c * s1;
    }
  }
  red2[0 * nt + t] = m0;
  red2[1 * nt + t] = a1;
  red2[2 * nt + t] = b1;
  red2[3 * nt + t] = aa;
  red2[4 * nt + t] = bb;
  red2[5 * nt + t] = ab;
  __syncthreads();
  if (t < 6 * K) {
    const int f = t / K, c = t - f * K;
    const float* rf = red2 + f * nt + c;
    float v = rf[0];
    for (int q = 1; q < J; ++q) v += rf[q * K];
    for (int d = 0; d < kCluster; ++d)
      cluster.map_shared_rank(rmom + (rank * 6 + f) * K + c, d)[0] = v;
  }
  cluster.sync();  // no CTA touches another's shared memory after this barrier
  if (t < K) {
    float s[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      s[f] = rmom[f * K + t];
      for (int c = 1; c < kCluster; ++c) s[f] += rmom[(c * 6 + f) * K + t];
    }
    const float su = a.transposed ? s[1] : s[2], sv = a.transposed ? s[2] : s[1];
    const float suu = a.transposed ? s[3] : s[4], svv = a.transposed ? s[4] : s[3];
    const float z = fmaxf(s[0], FLT_MIN);
    const float eu = su / z, ev = sv / z;
    const float euu = suu / z, evv = svv / z, euv = s[5] / z;
    const int plane = n * K + t;
    const float du = a.guv[plane * 2], dv = a.guv[plane * 2 + 1];
    const float dcuu = a.gcov[plane * 4], dcvv = a.gcov[plane * 4 + 3];
    const float dcuv = a.gcov[plane * 4 + 1] + a.gcov[plane * 4 + 2];
    cf[cZ][t] = z;
    cf[cEu][t] = eu;
    cf[cEv][t] = ev;
    cf[cDu][t] = du;
    cf[cDv][t] = dv;
    cf[cDuu][t] = dcuu;
    cf[cDvv][t] = dcvv;
    cf[cDuv][t] = dcuv;
    cf[cEf][t] = du * eu + dv * ev + dcuu * (euu - 2.f * eu * eu) +
                 dcvv * (evv - 2.f * ev * ev) + dcuv * (euv - 2.f * eu * ev);
    cf[cPool][t] = a.gpool[plane] / (float)(A * Bd);
  }
  __syncthreads();

  // pass 3: p (f - E[f]) + d pooled / (H W), in place in the strip
  if (active) {
    const float shift = cf[cShift][k], z = cf[cZ][k], eu = cf[cEu][k], ev = cf[cEv][k];
    const float du = cf[cDu][k], dv = cf[cDv][k], dcuu = cf[cDuu][k], dcvv = cf[cDvv][k];
    const float dcuv = cf[cDuv][k], ef = cf[cEf][k], dpool = cf[cPool][k];
    for (int r = 0; r < nrows; ++r) {
      T* row = strip + r * row_elems + j * K + k;
      const float c = ca[r];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float u = a.transposed ? c : cb[q], v = a.transposed ? cb[q] : c;
        const float e = expf(shifted(to_f32(row[q * J * K]), shift, T()));
        const float f = du * u + dv * v + dcuu * (u * u - 2.f * eu * u) +
                        dcvv * (v * v - 2.f * ev * v) + dcuv * (u * v - ev * u - eu * v);
        row[q * J * K] = from_f32<T>((e / z) * (f - ef) + dpool);
      }
    }
  }
  __syncthreads();
  // the strip back to device memory in its storage order, 16 bytes a store
  const int n16 = nrows * row_elems * (int)sizeof(T) / 16;
  const uint4* s16 = reinterpret_cast<const uint4*>(strip);
  uint4* d16 = reinterpret_cast<uint4*>(static_cast<T*>(a.dl) + n * a.dn +
                                        (long long)a0 * row_elems);
  for (int i = t; i < n16; i += nt) d16[i] = s16[i];
}

// one launch of `kern` on N clusters of kCluster CTAs; `raised` is the
// dynamic shared memory the kernel has been allowed so far
template <typename Args>
int launch_cluster(void (*kern)(Args), const Args& a, int N, int threads, size_t smem,
                   cudaStream_t st, size_t& raised) {
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * (unsigned)kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
}

template <typename T>
int launch_dense(const DenseArgs& a, int N, int threads, size_t smem, cudaStream_t st) {
  static size_t raised = 0;
  return launch_cluster(heatmap_readout_kernel_dense<T>, a, N, threads, smem, st, raised);
}

template <typename T>
int launch_dense_bwd(const DenseBwdArgs& a, int N, int threads, size_t smem, cudaStream_t st) {
  static size_t raised = 0;
  return launch_cluster(heatmap_readout_bwd_kernel_dense<T>, a, N, threads, smem, st, raised);
}

}  // namespace

// K19. logits and dl [N, H, W, K] with their own strides (elements); guv
// [N, K, 2], gcov [N, K, 2, 2], gpool [N, K] f32 contiguous. dtype as K2's.
extern "C" int suo_heatmap_readout_bwd(const void* logits, long long sn, long long sh,
                                       long long sw, long long sk, int N, int H, int W, int K,
                                       const void* guv, const void* gcov, const void* gpool,
                                       void* dl, long long dn, long long dh, long long dw,
                                       long long dk, int dtype, void* stream) {
  if (N * K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
      heatmap_readout_bwd_kernel<float><<<N * K, kThreads, 0, s>>>(
          (const float*)logits, sn, sh, sw, sk, H, W, K, (const float*)guv,
          (const float*)gcov, (const float*)gpool, (float*)dl, dn, dh, dw, dk);
    else
      heatmap_readout_bwd_kernel<__nv_bfloat16><<<N * K, kThreads, 0, s>>>(
          (const __nv_bfloat16*)logits, sn, sh, sw, sk, H, W, K, (const float*)guv,
          (const float*)gcov, (const float*)gpool, (__nv_bfloat16*)dl, dn, dh, dw, dk);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = f32 logits, 1 = bf16 logits (strides in elements).
extern "C" int suo_heatmap_readout(const void* logits, long long sn,
                                   long long sh, long long sw, long long sk,
                                   int N, int H, int W, int K, float min_var,
                                   void* uv, void* cov, void* pooled, int dtype,
                                   void* stream) {
  if (N * K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
      heatmap_readout_kernel<float><<<N * K, kThreads, 0, s>>>(
          (const float*)logits, sn, sh, sw, sk, H, W, K, min_var, (float*)uv,
          (float*)cov, (float*)pooled);
    else
      heatmap_readout_kernel<__nv_bfloat16><<<N * K, kThreads, 0, s>>>(
          (const __nv_bfloat16*)logits, sn, sh, sw, sk, H, W, K, min_var, (float*)uv,
          (float*)cov, (float*)pooled);
  }
  return (int)cudaGetLastError();
}

// The dense path: a crop's [A, Bd, K] slab contiguous (storage order), crops
// `sn` elements apart, kCluster CTAs of ceil(A / kCluster) storage rows; the
// alignment and sizes this entry assumes are checked by `ops/heatmap.py`
// `plan_readout`. dtype as above.
extern "C" int suo_heatmap_readout_dense(const void* logits, long long sn, int N, int A, int Bd,
                                         int K, int transposed, float min_var, void* uv,
                                         void* cov, void* pooled, int dtype, void* stream) {
  if (N * K > 0) {
    const int rows = (A + kCluster - 1) / kCluster;
    const int J = Bd / kPer;
    const int threads = (J * K + 31) / 32 * 32;
    if (K > kMaxK || rows > kMaxStripRows || J * kPer != Bd || threads > kMaxDenseThreads ||
        threads < 6 * K)
      return (int)cudaErrorInvalidValue;
    size_t strip = (size_t)rows * Bd * K * (dtype == 0 ? 4 : 2);
    if (strip < (size_t)6 * threads * 4) strip = (size_t)6 * threads * 4;
    const size_t smem = strip + (size_t)kCluster * K * 8 * 4;  // + rmom, rmax, rsum
    DenseArgs a{logits, sn, A, Bd, K, transposed, rows, J, (int)strip, min_var,
                (float*)uv, (float*)cov, (float*)pooled};
    cudaStream_t s = (cudaStream_t)stream;
    const int e = dtype == 0 ? launch_dense<float>(a, N, threads, smem, s)
                             : launch_dense<__nv_bfloat16>(a, N, threads, smem, s);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}

// K19's dense path: the logits' crops [A, Bd, K] contiguous in storage order
// (`sn` elements apart), dl written in the same order (`dn` apart), the
// geometry of K2's dense path (`ops/heatmap.py` `plan_readout_bwd` checks
// the alignment and sizes this entry assumes). guv, gcov, gpool as above.
extern "C" int suo_heatmap_readout_bwd_dense(const void* logits, long long sn, int N, int A,
                                             int Bd, int K, int transposed, const void* guv,
                                             const void* gcov, const void* gpool, void* dl,
                                             long long dn, int dtype, void* stream) {
  if (N * K > 0) {
    const int rows = (A + kCluster - 1) / kCluster;
    const int J = Bd / kPer;
    const int threads = (J * K + 31) / 32 * 32;
    const size_t es = dtype == 0 ? 4 : 2;
    const size_t strip = (size_t)rows * Bd * K * es;
    auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
    if (K > kMaxK || rows > kMaxStripRows || J * kPer != Bd || threads > kMaxDenseThreads ||
        threads < 6 * K || (Bd * K * es) % 16 || !al(logits) || !al(dl) ||
        (N > 1 && ((sn * es) % 16 || (dn * es) % 16)))
      return (int)cudaErrorInvalidValue;
    // + the per-thread moments, rmom and rmax
    const size_t smem = strip + (size_t)6 * threads * 4 + (size_t)kCluster * K * 7 * 4;
    DenseBwdArgs a{logits, sn, dl, dn, A, Bd, K, transposed, rows, J, (int)strip,
                   (const float*)guv, (const float*)gcov, (const float*)gpool};
    cudaStream_t s = (cudaStream_t)stream;
    const int e = dtype == 0 ? launch_dense_bwd<float>(a, N, threads, smem, s)
                             : launch_dense_bwd<__nv_bfloat16>(a, N, threads, smem, s);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
