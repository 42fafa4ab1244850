// K8 — fused BatchNorm affine + ReLU of the hourglass backbone, f32 or bf16.
//
// Replaces the norm epilogues of `suo_slam_tpu/models/hourglass.py`: the
// inference affine of `MaskedBatchNorm` (`:88-90`, y = x * inv + shift in f32,
// cast back to the storage dtype) and the `nn.relu` after it (`:133-139` in
// every residual block, `:201-202` after the stem, `:221-222` after each
// stack's 1x1). XLA fuses each pair into the adjacent convolution; in the port
// cuDNN runs the convolutions and this kernel is the one pass between them.
//   y[n, h, w, c] = relu(cast(x[n, h, w, c] * inv[c] + shift[c]))
// with inv = rsqrt(var + eps) * scale and shift = bias - mean * inv (f32 [C],
// computed once per module by the wrapper). NHWC memory (NCHW channels_last),
// so c is the innermost index. The affine is computed in f32 whatever the
// storage dtype: a product and a sum, each rounded (--fmad=false), as the
// plain version's two PyTorch elementwise kernels round them; the f32 result
// then rounds once to the storage dtype (round to nearest even) and the ReLU
// keeps its sign, so the kernel equals the plain version exactly.
//
// Bound on this card: bytes. The largest call on the main path (8 crops x
// 64 x 64 x 256 f32, a residual's first norm) reads 33.5 MB and writes
// 33.5 MB: 20 us at 3.35 TB/s; bf16 halves it. Design: one thread per
// 16-byte vector (4 f32 or 8 bf16 values, when C and the pointers allow;
// else one value a thread), grid-stride, the per-channel inv and shift read
// through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// to_f: storage -> f32; relu_cast: f32 -> storage, rounded to nearest even,
// then the ReLU (a NaN passes, as torch.relu keeps it)
template <typename T> struct Op;
template <> struct Op<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float relu_cast(float v) {
    return (v > 0.f || v != v) ? v : 0.f;
  }
};
template <> struct Op<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 relu_cast(float v) {
    const __nv_bfloat16 r = __float2bfloat16_rn(v);
    const float f = __bfloat162float(r);
    return (f > 0.f || f != f) ? r : __float2bfloat16_rn(0.f);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
norm_relu_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                 const float* __restrict__ shift, T* __restrict__ y, long long n_vec, int C) {
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const long long i0 = v * V;
    const int c0 = (int)(i0 % C);
    if constexpr (V == 1) {
      const float a = Op<T>::to_f(x[i0]) * __ldg(inv + c0);
      y[i0] = Op<T>::relu_cast(a + __ldg(shift + c0));
    } else {
      // 16 bytes in, 16 bytes out; C % V == 0 keeps the vector in one pixel
      uint4 u = *reinterpret_cast<const uint4*>(x + i0);
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float a = Op<T>::to_f(e[k]) * __ldg(inv + c0 + k);
        e[k] = Op<T>::relu_cast(a + __ldg(shift + c0 + k));
      }
      *reinterpret_cast<uint4*>(y + i0) = u;
    }
  }
}

template <typename T, int V>
void launch(const void* x, const void* inv, const void* shift, void* y, long long n, int C,
            cudaStream_t s) {
  const long long n_vec = n / V;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (blocks > 0)
    norm_relu_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, (const float*)inv, (const float*)shift, (T*)y, n_vec, C);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. x and y hold n = N*H*W*C values in NHWC order.
extern "C" int suo_norm_relu(const void* x, const void* inv, const void* shift, void* y,
                             long long n, int C, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (dtype == 0) {
    if (aligned && C % 4 == 0) launch<float, 4>(x, inv, shift, y, n, C, s);
    else launch<float, 1>(x, inv, shift, y, n, C, s);
  } else {
    if (aligned && C % 8 == 0) launch<__nv_bfloat16, 8>(x, inv, shift, y, n, C, s);
    else launch<__nv_bfloat16, 1>(x, inv, shift, y, n, C, s);
  }
  return (int)cudaGetLastError();
}
