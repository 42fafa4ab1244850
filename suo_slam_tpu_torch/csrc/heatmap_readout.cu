// K2 — heatmap readout: per-(crop, keypoint) spatial softmax + soft-argmax
// mean and covariance, plus the mean-pooled logit for the validity head; and
// K19 — its backward.
//
// Replaces `suo_slam_tpu/ops/heatmap.py` `spatial_softmax` + `soft_argmax`
// (what `models/pkpnet.py:127-133` calls) and `soft_argmax_from_logits`.
// On the TPU the moments are one [N*K, HW] x [HW, 6] MXU contraction; here a
// block owns one (n, k) plane and reduces it twice (max, then the six
// exp-weighted moments 1, u, v, u^2, v^2, uv), all in f32:
//   uv  = (E[u], E[v]),  cov = E[pp^T] - uv uv^T + min_var * I,
//   pooled = mean of the raw logits (the validity head's input).
// The plane is read with the strides the caller passes, so the NCHW /
// channels_last head output and the transpose_heatmaps view need no copy.
// Logits are f32 or bf16 (the int8 engine's head, `int8_forward.py:526-543`):
// for bf16 the shifted logit l - max rounds to bf16 before the f32 exp, as
// JAX subtracts in the logits' dtype (`ops/heatmap.py:84-85`); the moments
// and the pooled mean stay f32.
//
// Bound on this card: bytes. At the main path's shapes (8 x 41 planes of
// 64x64 f32) it must read 5.4 MB once: ~1.6 us at 3.35 TB/s; the outputs are
// 8 KB. Design: one 256-thread block per plane (328 blocks over 132 SMs), the
// second pass re-reads the 16 KB plane from L1/L2, warp-shuffle reductions.
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
// f32 throughout; the result rounds once to the logits' dtype and is written
// with the strides the caller gives (the logits' own layout). The max and
// the moments are recomputed from the logits, as K2 computes them. Bound:
// bytes, the logits read once and their gradient written once (at the train
// step's 32 x 41 planes of 64 x 64 f32: 21.5 MB, 6.4 us at 3.35 TB/s).
// Design: K2's block per plane, a third pass that writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cfloat>

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
