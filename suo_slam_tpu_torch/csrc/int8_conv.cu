// K11 — the int8 engine's convolution: s8 x s8 -> exact s32 sums, rounded once
// to bf16, then the engine's folded epilogue in bf16.
//
// Replaces `suo_slam_tpu/models/int8_forward.py` `_Int8Engine._conv_i8`
// (`:254-271`, XLA's s8 convolution with `preferred_element_type=bf16`) and
// the epilogues of `conv_raw` (`:273-275`) and `conv_nrq` (`:277-284`):
//   y   = bf16(sum_{r,s,ci} x[n, ho*st-pad+r, wo*st-pad+s, ci] * w[co, r, s, ci])
//   z   = bf16(bf16(y * e1[co]) + e2[co])
//   raw: out = z (bf16);   nrq: out = clip(rint(max(z, 0)), -127, 127) (s8)
// with e1, e2 the per-output-channel multiplier and offset the wrapper folds
// from the scales (raw: s_in * s_w and the bias; nrq: the BatchNorm affine and
// the output scale too), rounded to bf16. XLA on the CPU rounds after every
// bf16 operation, so each step here rounds too (`__fmul_rn`, `__fadd_rn`,
// `--fmad=false`); the s32 -> bf16 conversion rounds once, to nearest even,
// through an f32 truncation with a sticky bit (an s32 above 2^24 would
// otherwise round twice).
//
// Layout: activations NHWC [N, H, W, Cin] s8 with Cin % 16 == 0 (the wrapper
// pads the prior's 41 channels to 48); weights [Cout, KH, KW, Cin] s8 (arranged
// once by `quantize_weights`); output NHWC [N, Ho, Wo, Cout].
//
// Bound on this card: int8 tensor-core operations at 1,979 TOP/s for the 3x3
// convolutions, bytes at 3.35 TB/s for most 1x1 ones (at 8 x 64 x 64: 3x3
// 128->128 is 9.66 G operations, 4.9 us; 1x1 256->128 moves 8.4 + 8.4 MB of s8
// in and bf16 / s8 out). Design: an implicit GEMM (M = output pixels, N = Cout,
// K = KH x KW x Cin) on `mma.sync.m16n8k32` s8 tensor-core instructions. A
// block of 8 warps owns 128 pixels x 64 output channels; each warp a 32 x 32
// sub-tile (2 x 4 instructions per 32 bytes of K). Per (r, s) tap and 64-byte
// channel chunk, the block stages the pixels' input vectors (zero outside the
// image) and the weights in shared memory with 16-byte loads, in rows of 20
// words so that the fragment reads hit 32 distinct banks. One stage, no
// pipelining: a first version that is right; the epilogue writes scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBM = 128;          // output pixels per block
constexpr int kBN = 64;           // output channels per block
constexpr int kBK = 64;           // bytes of K (input channels) per stage
constexpr int kThreads = 256;     // 8 warps: 4 along M x 2 along N
constexpr int kLds = kBK / 4 + 4; // 32-bit words per shared row

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* e1;
  const float* e2;
  void* out;
  int N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, out_s8;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// int32 -> bf16, one round to nearest even
__device__ __forceinline__ float s32_to_bf16(int v) {
  float rz = __int2float_rz(v);
  if ((int)rz != v) rz = __uint_as_float(__float_as_uint(rz) | 1u);
  return bf16r(rz);
}

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) int8_conv_kernel(ConvArgs a) {
  __shared__ __align__(16) unsigned As[kBM][kLds];
  __shared__ __align__(16) unsigned Bs[kBN][kLds];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const long long M = (long long)a.N * a.Ho * a.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's two 16-byte vectors of the A tile (128 rows x 4 vectors)
  int a_row[2], a_vec[2], a_hi[2], a_wi[2];
  long long a_n[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    a_row[i] = idx >> 2;
    a_vec[i] = idx & 3;
    const long long m = m0 + a_row[i];
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int wo = (int)(mm % a.Wo);
    const long long q = mm / a.Wo;
    const int ho = (int)(q % a.Ho);
    a_n[i] = q / a.Ho;
    a_hi[i] = ho * a.stride - a.pad;
    a_wi[i] = wo * a.stride - a.pad;
  }
  // and its one vector of the B tile (64 rows x 4 vectors)
  const int b_row = tid >> 2, b_vec = tid & 3;
  const int b_co = n0 + b_row;
  const bool b_ok = b_co < a.Cout;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0;

  const int n_chunks = (a.Cin + kBK - 1) / kBK;
  for (int r = 0; r < a.KH; ++r) {
    for (int s = 0; s < a.KW; ++s) {
      for (int kc = 0; kc < n_chunks; ++kc) {
        const int c0 = kc * kBK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          int4 v = make_int4(0, 0, 0, 0);
          const int hi = a_hi[i] + r, wi = a_wi[i] + s;
          const int c = c0 + a_vec[i] * 16;
          if (a_ok[i] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W && c < a.Cin)
            v = *reinterpret_cast<const int4*>(
                a.x + ((a_n[i] * a.H + hi) * a.W + wi) * (long long)a.Cin + c);
          *reinterpret_cast<int4*>(&As[a_row[i]][a_vec[i] * 4]) = v;
        }
        {
          int4 v = make_int4(0, 0, 0, 0);
          const int c = c0 + b_vec * 16;
          if (b_ok && c < a.Cin)
            v = *reinterpret_cast<const int4*>(
                a.w + (((long long)b_co * a.KH + r) * a.KW + s) * a.Cin + c);
          *reinterpret_cast<int4*>(&Bs[b_row][b_vec * 4]) = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const int k0 = kk * 8;  // first word of this 32-byte step
          unsigned af[2][4], bf[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int row = wm * 32 + mi * 16 + g;
            af[mi][0] = As[row][k0 + t];
            af[mi][1] = As[row + 8][k0 + t];
            af[mi][2] = As[row][k0 + 4 + t];
            af[mi][3] = As[row + 8][k0 + 4 + t];
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = wn * 32 + ni * 8 + g;
            bf[ni][0] = Bs[col][k0 + t];
            bf[ni][1] = Bs[col][k0 + 4 + t];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: accumulator k of (mi, ni) is row g (+8 for k >= 2), column
  // 2t + (k & 1) of the 16 x 8 tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long m = m0 + wm * 32 + mi * 16 + g + (k >> 1) * 8;
        const int co = n0 + wn * 32 + ni * 8 + 2 * t + (k & 1);
        if (m >= M || co >= a.Cout) continue;
        const float y = s32_to_bf16(acc[mi][ni][k]);
        float z = bf16r(__fmul_rn(y, a.e1[co]));
        z = bf16r(__fadd_rn(z, a.e2[co]));
        const long long o = m * a.Cout + co;
        if (a.out_s8) {
          z = fminf(rintf(fmaxf(z, 0.f)), 127.f);
          reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)(int)z;
        } else {
          reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(z);
        }
      }
    }
  }
}

}  // namespace

// x [N, H, W, Cin] s8 (Cin % 16 == 0, 16-byte aligned), w [Cout, KH, KW, Cin]
// s8, e1 / e2 [Cout] f32 holding bf16 values, out [N, Ho, Wo, Cout] s8
// (out_s8 = 1) or bf16.
extern "C" int suo_int8_conv(const void* x, const void* w, const void* e1, const void* e2,
                             void* out, int N, int H, int W, int Cin, int Cout, int KH,
                             int KW, int stride, int pad, int Ho, int Wo, int out_s8,
                             void* stream) {
  ConvArgs a{(const int8_t*)x, (const int8_t*)w, (const float*)e1, (const float*)e2, out,
             N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, out_s8};
  const long long M = (long long)N * Ho * Wo;
  if (M > 0 && Cout > 0) {
    dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Cout + kBN - 1) / kBN));
    int8_conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
