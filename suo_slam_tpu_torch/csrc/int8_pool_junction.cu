// K13 — the int8 engine's s8 2x2 max-pool and s8 hourglass junction: the
// earlier design, off the int8 forward since K12's pool and junction modes
// (`csrc/int8_quant.cu`) do this work inside the quantize pass that follows
// it; kept as the reference those modes are held against on the card.
//
// Replaces `suo_slam_tpu/models/int8_forward.py` `_Int8Engine.maxpool`
// (`:286-290`, a VALID 2x2 / stride-2 `reduce_window` on the codes: the scale
// is positive, so the max commutes with dequantisation; PyTorch's CUDA
// `max_pool2d` takes no int8) and `upsample_add` (`:292-300`):
//   maxpool: out[n, h, w, c] = max of x[n, 2h + i, 2w + j, c], i, j in {0, 1}
//   junction: out[n, h, w, c] = bf16(bf16(up1[n, h, w, c] * e_up[c])
//                                    + bf16(low[n, h/2, w/2, c] * e_low[c]))
// e_up / e_low are the two tensors' scales rounded to bf16 (per-tensor scales
// expanded to [C] by the wrapper); each product and the sum round to bf16 on
// their own, as XLA on the CPU computes JAX's bf16 expression. The nearest-2x
// upsample of `low` is read through indices: the 4x tensor is never written.
//
// Bound on this card: bytes. At the largest calls (8 x 64 x 64 x 256): the
// pool reads 8.4 MB and writes 2.1 MB (3.1 us at 3.35 TB/s); the junction
// reads 8.4 + 2.1 MB and writes 16.8 MB of bf16 (8.1 us). Design: one thread
// per 4 channels of an output pixel (4-byte loads of codes), grid-stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one thread per 4 channels (C % 4 == 0, checked by the wrapper)
__global__ void __launch_bounds__(kThreads)
int8_pool_junction_kernel_maxpool(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                  int N, int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2, cv = C / 4;
  const long long n_vec = (long long)N * Ho * Wo * cv;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const int c = (int)(v % cv) * 4;
    const long long p = v / cv;
    const int wo = (int)(p % Wo);
    const long long q = p / Wo;
    const int ho = (int)(q % Ho);
    const long long n = q / Ho;
    char4 r = make_char4(-128, -128, -128, -128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const char4 e = *reinterpret_cast<const char4*>(
            x + ((n * H + 2 * ho + i) * W + 2 * wo + j) * (long long)C + c);
        r.x = max(r.x, e.x);
        r.y = max(r.y, e.y);
        r.z = max(r.z, e.z);
        r.w = max(r.w, e.w);
      }
    }
    *reinterpret_cast<char4*>(out + p * C + c) = r;
  }
}

__global__ void __launch_bounds__(kThreads)
int8_pool_junction_kernel_upadd(const int8_t* __restrict__ up1, const int8_t* __restrict__ low,
                                const float* __restrict__ e_up,
                                const float* __restrict__ e_low,
                                __nv_bfloat16* __restrict__ out, int N, int H, int W, int C) {
  const int cv = C / 4;
  const long long n_vec = (long long)N * H * W * cv;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < n_vec;
       v += (long long)gridDim.x * kThreads) {
    const int c = (int)(v % cv) * 4;
    const long long p = v / cv;  // output pixel n*H*W + h*W + w
    const int w = (int)(p % W);
    const long long q = p / W;
    const int h = (int)(q % H);
    const long long n = q / H;
    const long long lo = ((n * (H / 2) + h / 2) * (W / 2) + w / 2) * C + c;
    const char4 a = *reinterpret_cast<const char4*>(up1 + p * C + c);
    const char4 b = *reinterpret_cast<const char4*>(low + lo);
    const signed char av[4] = {a.x, a.y, a.z, a.w};
    const signed char bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float du = bf16r(__fmul_rn((float)av[k], e_up[c + k]));
      const float dl = bf16r(__fmul_rn((float)bv[k], e_low[c + k]));
      out[p * C + c + k] = __float2bfloat16_rn(__fadd_rn(du, dl));
    }
  }
}

unsigned grid(long long n_vec) {
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)blocks;
}

}  // namespace

// x [N, H, W, C] s8 -> out [N, H/2, W/2, C] s8; C % 4 == 0, 4-byte aligned.
extern "C" int suo_int8_maxpool(const void* x, void* out, int N, int H, int W, int C,
                                void* stream) {
  const long long n_vec = (long long)N * (H / 2) * (W / 2) * (C / 4);
  if (n_vec > 0)
    int8_pool_junction_kernel_maxpool<<<grid(n_vec), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (int8_t*)out, N, H, W, C);
  return (int)cudaGetLastError();
}

// up1 [N, H, W, C] s8, low [N, H/2, W/2, C] s8, e_up / e_low [C] f32 holding
// bf16 values -> out [N, H, W, C] bf16; C % 4 == 0, 4-byte aligned.
extern "C" int suo_int8_upsample_add(const void* up1, const void* low, const void* e_up,
                                     const void* e_low, void* out, int N, int H, int W, int C,
                                     void* stream) {
  const long long n_vec = (long long)N * H * W * (C / 4);
  if (n_vec > 0)
    int8_pool_junction_kernel_upadd<<<grid(n_vec), kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)up1, (const int8_t*)low, (const float*)e_up, (const float*)e_low,
        (__nv_bfloat16*)out, N, H, W, C);
  return (int)cudaGetLastError();
}
