// K12 — the int8 engine's quantize family: one pass over an NHWC tensor that
// writes its s8 codes, its normalised s8 codes, or both.
//
// Replaces `suo_slam_tpu/models/int8_forward.py` `_Int8Engine.quant`
// (`:218-221`), `quant_pair` (`:223-235`, the dual-output fusion XLA forms at
// every chained block boundary) and `nrq` (`:246-252`):
//   raw:  out_raw[i]  = clip(rint(R(x[i] / div[c])), -127, 127)
//   norm: out_norm[i] = clip(rint(max(R(R(x[i] * m[c]) + cc[c]), 0)), -127, 127)
// with c = i % C and R the rounding to the operation's dtype: identity for an
// f32 input, bf16 for a bf16 input and for s8 codes (`nrq` converts its codes
// to bf16, exactly). The wrapper expands per-tensor scales to [C] and passes
// div, m and cc already rounded to the operation's dtype; every product, sum
// and quotient rounds on its own (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`,
// `--fmad=false`), as XLA on the CPU and PyTorch's elementwise operations
// compute them.
//
// Bound on this card: bytes — the input once and each output once (8 x 64 x
// 64 x 256 bf16 in, two s8 outputs: 16.8 + 16.8 MB, 10 us at 3.35 TB/s).
// Design: one thread per element, grid-stride; the per-channel vectors stay
// in L1. A first version that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load(const int8_t* x, long long i) { return (float)x[i]; }

__device__ __forceinline__ int8_t to_s8(float v) {  // v already integral
  return (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
int8_quant_kernel(const T* __restrict__ x, long long n, int C, const float* __restrict__ div,
                  const float* __restrict__ m, const float* __restrict__ cc,
                  int8_t* __restrict__ out_raw, int8_t* __restrict__ out_norm) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % C);
    const float v = load(x, i);
    if (out_raw != nullptr) {
      float q = __fdiv_rn(v, div[c]);
      if (kBf16) q = bf16r(q);
      out_raw[i] = to_s8(rintf(q));
    }
    if (out_norm != nullptr) {
      float y = __fmul_rn(v, m[c]);
      if (kBf16) y = bf16r(y);
      y = __fadd_rn(y, cc[c]);
      if (kBf16) y = bf16r(y);
      out_norm[i] = to_s8(rintf(fmaxf(y, 0.f)));
    }
  }
}

template <typename T, bool kBf16>
void launch(const void* x, long long n, int C, const void* div, const void* m, const void* cc,
            void* out_raw, void* out_norm, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (blocks > 0)
    int8_quant_kernel<T, kBf16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const T*)x, n, C, (const float*)div, (const float*)m, (const float*)cc,
        (int8_t*)out_raw, (int8_t*)out_norm);
}

}  // namespace

// x: n elements of an NHWC tensor with C channels, xdtype 0 = f32, 1 = bf16,
// 2 = s8. div [C] (raw output) and m, cc [C] (normalised output) are f32
// arrays; out_raw / out_norm may be null to skip that output.
extern "C" int suo_int8_quant(const void* x, int xdtype, long long n, int C, const void* div,
                              const void* m, const void* cc, void* out_raw, void* out_norm,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (xdtype == 0) launch<float, false>(x, n, C, div, m, cc, out_raw, out_norm, s);
  else if (xdtype == 1) launch<__nv_bfloat16, true>(x, n, C, div, m, cc, out_raw, out_norm, s);
  else launch<int8_t, true>(x, n, C, div, m, cc, out_raw, out_norm, s);
  return (int)cudaGetLastError();
}
