// K9 — the hourglass junction out = up1 + nearest2x(low), f32 or bf16, and
// K18 — its backward for low.
//
// Replaces `suo_slam_tpu/models/hourglass.py` `upsample2x` (`:35-39`, a
// reshape-broadcast that XLA fuses into the add) and the add at `:174`
// (`up1 + upsample2x(low)`), where eager PyTorch would materialise the
// upsampled tensor (`F.interpolate`) and read it back for the add.
//   out[n, h, w, c] = up1[n, h, w, c] + low[n, h / 2, w / 2, c]
// NHWC memory (NCHW channels_last), so c is the innermost index and a vector
// of channels maps to one pixel of each input. The sum is taken in f32 and
// rounded once to the storage dtype (round to nearest even), as PyTorch's
// elementwise add computes it for bf16, so the kernel equals the plain
// version exactly.
//
// Bound on this card: bytes — up1 and out [N, H, W, C] plus low
// [N, H/2, W/2, C]; at the largest call (8 x 64 x 64 x 256 f32) 33.5 + 8.4 MB
// read and 33.5 MB written, 22.5 us at 3.35 TB/s (bf16 half). Design: one
// thread per 16-byte vector of channels (4 f32 or 8 bf16 when C and the
// pointers allow, else one value), grid-stride; each low pixel is read by
// four output pixels, which L2 serves.
//
// K18 `upsample_add_bwd`: the cotangent of low, the transpose of JAX's
// broadcast-and-reshape upsample (`:35-39`, XLA's reduce over the broadcast
// axes):
//   d_low[n, i, j, c] = sum over a, b in {0, 1} of dy[n, 2i + a, 2j + b, c]
// summed in f32 and rounded once to the storage dtype. up1's cotangent is dy
// itself (the wrapper returns it; no kernel). Bound: bytes, dy read once and
// d_low written (a quarter of dy): at the largest junction of the train step
// (32 x 64 x 64 x 256 bf16) 67 + 17 MB, 25 us at 3.35 TB/s. Design: a thread
// per d_low value, four loads from two rows of dy, neighbouring threads on
// neighbouring channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
upsample_add_kernel(const T* __restrict__ up1, const T* __restrict__ low, T* __restrict__ out,
                    int N, int H, int W, int C) {
  const int cv = C / V;  // vectors per pixel
  const long long n_vec = (long long)N * H * W * cv;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const int c = (int)(v % cv) * V;
    const long long p = v / cv;  // output pixel n*H*W + h*W + w
    const int w = (int)(p % W);
    const long long q = p / W;
    const int h = (int)(q % H);
    const long long n = q / H;
    const long long lo = ((n * (H / 2) + h / 2) * (W / 2) + w / 2) * C + c;
    const long long i0 = p * C + c;
    if constexpr (V == 1) {
      out[i0] = add(up1[i0], low[lo]);
    } else {
      uint4 a = *reinterpret_cast<const uint4*>(up1 + i0);
      const uint4 b = *reinterpret_cast<const uint4*>(low + lo);
      T* ea = reinterpret_cast<T*>(&a);
      const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int k = 0; k < V; ++k) ea[k] = add(ea[k], eb[k]);
      *reinterpret_cast<uint4*>(out + i0) = a;
    }
  }
}

template <typename T, int V>
void launch(const void* up1, const void* low, void* out, int N, int H, int W, int C,
            cudaStream_t s) {
  const long long n_vec = (long long)N * H * W * (C / V);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (blocks > 0)
    upsample_add_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)up1, (const T*)low, (T*)out, N, H, W, C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_add_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dlow, int N, int H, int W,
                        int C) {
  const int h2 = H / 2, w2 = W / 2;
  const long long n_val = (long long)N * h2 * w2 * C;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n_val;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % C);
    const long long p = i / C;  // low pixel n*h2*w2 + y*w2 + x
    const int x = (int)(p % w2);
    const long long q = p / w2;
    const int y = (int)(q % h2);
    const long long n = q / h2;
    const long long r0 = ((n * H + 2 * y) * W + 2 * x) * C + c;
    const long long r1 = r0 + (long long)W * C;
    const float s = (to_f(dy[r0]) + to_f(dy[r0 + C])) + (to_f(dy[r1]) + to_f(dy[r1 + C]));
    dlow[i] = from_f<T>(s);
  }
}

}  // namespace

// K18. dy [N, H, W, C], d_low [N, H/2, W/2, C] (NHWC). dtype: 0 = f32, 1 = bf16.
extern "C" int suo_upsample_add_bwd(const void* dy, void* dlow, int N, int H, int W, int C,
                                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_val = (long long)N * (H / 2) * (W / 2) * C;
  long long blocks = (n_val + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (blocks > 0) {
    if (dtype == 0)
      upsample_add_bwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const float*)dy, (float*)dlow, N, H, W, C);
    else
      upsample_add_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)dy, (__nv_bfloat16*)dlow, N, H, W, C);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16. up1 and out [N, H, W, C], low [N, H/2, W/2, C].
extern "C" int suo_upsample_add(const void* up1, const void* low, void* out, int N, int H,
                                int W, int C, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)up1 % 16 == 0) && ((uintptr_t)low % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  if (dtype == 0) {
    if (aligned && C % 4 == 0) launch<float, 4>(up1, low, out, N, H, W, C, s);
    else launch<float, 1>(up1, low, out, N, H, W, C, s);
  } else {
    if (aligned && C % 8 == 0) launch<__nv_bfloat16, 8>(up1, low, out, N, H, W, C, s);
    else launch<__nv_bfloat16, 1>(up1, low, out, N, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
