// K5 — prior-keypoint render: per (crop, keypoint) one isotropic Gaussian of
// peak 1 at the keypoint's clipped NDC location, written as NHWC heatmaps
// [N, H, W, K] for the network's prior input, in f32 or bf16.
//
// Replaces `suo_slam_tpu/ops/heatmap.py` `render_prior_heatmaps` (`:166-201`),
// which on the TPU is one fused XLA elementwise pass over [N, H, W, K]:
//   du = (u_w - uc_k) / su,  dv = (v_h - vc_k) / sv,
//   out = valid_k ? exp(-0.5 (du^2 + dv^2)) : 0
// with uc, vc = clip(nan_to_num(uv), -1, 1), valid = mask && finite(uv), and
// the NDC pixel-centre grid of `ndc_grid` (v points up). In bf16 the f32
// value is rounded once to nearest even (what `.to(torch.bfloat16)` of the
// f32 map gives). The output is contiguous NHWC, so the post_stem projection
// (`_nhwc_to_cl`) and the concat `cat` read it without a copy.
//
// Bound on this card: bytes. At the SLAM path's symmetric group (4 crops,
// 64 x 64 x 41) it writes 2.7 MB in f32, 0.80 us at 3.35 TB/s (bf16 half);
// it reads ~1 KB. At that size the call is set by a chain of latencies —
// the keypoints' load, a barrier, the arithmetic of ~1,300 values a block,
// the stores — more than by its bytes. Design: du depends only on (w, k)
// and dv only on (h, k), so a block of kThreads owns a tile of kRows rows x
// kCols columns of one crop and stages, once, du for the tile's columns and
// dv for its rows in shared memory, each term computed with the plain
// version's operations from the keypoints' global loads (so each has its
// bits). The validity select is folded into dv: an invalid or non-finite
// keypoint's dv is +inf, and exp(-0.5 (du^2 + inf)) = +0, the bits of the
// plain version's g * 0 (du is always finite). A dv row holds K + V - 1
// terms (the first V - 1 repeated), so a vector's V keypoints k .. k + V - 1
// need no wrap. A value is then two shared loads (du as 16-byte loads), the
// exp and no division or select. The tile's values are walked flat, V at a
// time: 16-byte stores (4 f32 or 8 bf16) where W * K is a multiple of a
// vector and the output is 16-byte aligned (every run of a tile row then
// starts aligned), one value a store otherwise; (row, e = w K + k) by
// counters from one division a thread, as are the prologue's (w, k) and
// (h, k). One barrier. The mask is read as the bool tensor's bytes.
// Compiled without fast math: expf is PyTorch's exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 8;        // a block's tile: kRows rows x kCols columns
constexpr int kCols = 16;
constexpr int kThreads = 512;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float nan_to_num_clip(float a) {
  float x = isnan(a) ? 0.f : (isinf(a) ? (a > 0.f ? FLT_MAX : -FLT_MAX) : a);
  return fminf(fmaxf(x, -1.f), 1.f);
}

template <typename T, int V> struct Store;
template <> struct Store<float, 4> {
  static __device__ __forceinline__ void put(float* p, const float* g) {
    *reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);
  }
};
template <> struct Store<float, 1> {
  static __device__ __forceinline__ void put(float* p, const float* g) { *p = g[0]; }
};
template <> struct Store<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float* g) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(g[2 * i], g[2 * i + 1]);  // .x low
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Store<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float* g) {
    *p = __float2bfloat16_rn(g[0]);
  }
};

// dv's row stride: K + V - 1 terms
__host__ __device__ constexpr int dv_stride(int K, int V) { return K + V - 1; }
// du's floats, rounded up to a 16-byte multiple (dv follows it)
__host__ __device__ constexpr int du_floats(int K) { return (kCols * K + 3) & ~3; }

// grid (ceil(W / kCols), ceil(H / kRows), N); dynamic shared memory
// du_floats(K) + kRows dv_stride(K, V) floats.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
prior_render_kernel(const float* __restrict__ uv, const uint8_t* __restrict__ mask, int H,
                    int W, int K, float su, float sv, T* __restrict__ out) {
  extern __shared__ float4 sm[];
  float* du = reinterpret_cast<float*>(sm);  // [tw * K], w-major: (u_w - uc_k) / su
  const int KX = dv_stride(K, V);
  float* dv = du + du_floats(K);             // [th * KX], h-major: (v_h - vc_k) / sv or +inf
  const int t = threadIdx.x;
  const int n = blockIdx.z, h0 = blockIdx.y * kRows, w0 = blockIdx.x * kCols;
  const int tw = min(kCols, W - w0), th = min(kRows, H - h0);
  const float* p = uv + (size_t)n * K * 2;
  const uint8_t* m = mask + (size_t)n * K;
  const int len = tw * K;  // values a tile row
  {
    int w = t / K, k = t - w * K;
    const int dw = kThreads / K, dk = kThreads - dw * K;
    for (int i = t; i < len; i += kThreads) {
      const float u = ((float)(w0 + w) + 0.5f) / (0.5f * (float)W) - 1.f;
      du[i] = (u - nan_to_num_clip(p[2 * k])) / su;
      w += dw;
      k += dk;
      if (k >= K) { k -= K; ++w; }
    }
  }
  {
    int h = t / KX, k = t - h * KX;
    const int dh = kThreads / KX, dk = kThreads - dh * KX;
    for (int i = t; i < th * KX; i += kThreads) {
      int kk = k;  // k mod K: a row's last V - 1 terms repeat its first
      while (kk >= K) kk -= K;
      const float a = p[2 * kk], b = p[2 * kk + 1];
      const float v = 1.f - ((float)(h0 + h) + 0.5f) / (0.5f * (float)H);
      dv[i] = (m[kk] && isfinite(a) && isfinite(b)) ? (v - nan_to_num_clip(b)) / sv : INFINITY;
      h += dh;
      k += dk;
      if (k >= KX) { k -= KX; ++h; }
    }
  }
  __syncthreads();
  // the thread's first value (row, e = w * K + k of the row) by one division,
  // then counters: steps of kThreads * V values
  const int step = kThreads * V, drow = step / len, de = step - drow * len, dk = step % K;
  int row = t * V / len, e = t * V - row * len, k = e % K;
  T* base = out + (((size_t)n * H + h0) * W + w0) * K;
  while (row < th) {
    float a[V], g[V];
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 d = *reinterpret_cast<const float4*>(du + e + 4 * q);
        a[4 * q] = d.x; a[4 * q + 1] = d.y; a[4 * q + 2] = d.z; a[4 * q + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] = du[e + j];
    }
    const float* dvr = dv + row * KX + k;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float b = dvr[j];
      g[j] = expf(-0.5f * (a[j] * a[j] + b * b));
    }
    Store<T, V>::put(base + (size_t)row * W * K + e, g);
    e += de;
    row += drow;
    if (e >= len) { e -= len; ++row; }
    k += dk;
    if (k >= K) k -= K;
  }
}

template <typename T, int V>
int launch(const void* uv, const void* mask, int N, int H, int W, int K, float su, float sv,
           void* out, cudaStream_t s) {
  const size_t smem = (size_t)(du_floats(K) + kRows * dv_stride(K, V)) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        prior_render_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, N);
  prior_render_kernel<T, V><<<grid, kThreads, smem, s>>>(
      (const float*)uv, (const uint8_t*)mask, H, W, K, su, sv, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// uv [N, K, 2] f32, mask [N, K] bool bytes, out [N, H, W, K]. dtype: 0 = f32,
// 1 = bf16. vec: 1 = 16-byte stores (needs W * K a multiple of 16 /
// sizeof(T) and out 16-byte aligned), 0 = one value a store. Refuses what
// `ops/heatmap.py` `plan_prior_render` would (cudaErrorInvalidValue).
extern "C" int suo_prior_render(const void* uv, const void* mask, int N, int H, int W, int K,
                                float su, float sv, void* out, int dtype, int vec,
                                void* stream) {
  const int V = dtype == 0 ? 4 : 8;
  if (N < 0 || H < 0 || W < 0 || K < 0 || N > 65535 || (dtype != 0 && dtype != 1) ||
      (vec && (((long long)W * K) % V || (uintptr_t)out % 16)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0 || K == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? launch<float, 4>(uv, mask, N, H, W, K, su, sv, out, s)
               : launch<float, 1>(uv, mask, N, H, W, K, su, sv, out, s);
  return vec ? launch<__nv_bfloat16, 8>(uv, mask, N, H, W, K, su, sv, out, s)
             : launch<__nv_bfloat16, 1>(uv, mask, N, H, W, K, su, sv, out, s);
}
