// K12 — the int8 engine's quantize family: one pass over an NHWC tensor that
// writes its s8 codes, its normalised s8 codes, or both, behind a prologue
// that forms the input from s8 operands the way the JAX traversal writes it.
//
// Replaces `suo_slam_tpu/models/int8_forward.py` `_Int8Engine.quant`
// (`:218-221`), `quant_pair` (`:223-235`, the dual-output fusion XLA forms at
// every chained block boundary) and `nrq` (`:246-252`), and the dequantize
// and add that feed them (`dequant`, `:237-238`, at `:329-336`, `:367`,
// `:475-479` and `:517-518`; XLA fuses them into the quantize):
//   v = x                                      (f32, bf16, or s8 codes)
//   or v = R(q1 * s1[c]) [+ R(q2 * s2[c])] [+ add]   (the prologue, left to right)
//   raw:  out_raw[p, c]  = clip(rint(R(v / div[c])), -127, 127)
//   norm: out_norm[p, c] = clip(rint(max(R(R(v * m[c]) + cc[c]), 0)), -127, 127)
// with R the rounding to the operation's dtype: identity for an f32 input,
// bf16 otherwise (s8 codes convert to bf16 exactly). `add` is a bf16 tensor
// of the input's shape or an f32 [C] vector of bf16 values. Every product,
// sum and quotient rounds on its own, as XLA on the CPU and PyTorch's
// elementwise operations compute them (f32, then rounded to bf16): here the
// bf16 chain runs on bf16x2 pairs of channels, whose single rounding equals
// that double one (see `bmul2`), and a quotient is x * RN(1 / d) wherever
// that provably rounds as x / d does, else `__fdiv_rn` (`quot_bf16`,
// `code_div`). The outputs are Cp >= C channels wide, zero beyond C: the
// prior's 41 channels land in the 48-wide rows K11 reads, so K11 pads
// nothing.
//
// Bound on this card: bytes, each input once and each output once (at 8 x
// 64 x 64 x 256, a bf16 input and two s8 outputs: 16.8 + 16.8 MB, 10 us at
// 3.35 TB/s). Design: each thread handles 16 channels of one pixel — one
// 16-byte load per s8 operand, 32 bytes of bf16, 64 of f32, kept packed in
// registers (two vectors' loads in flight before any arithmetic), and one
// 16-byte store per output; the channel index comes from the vector's
// start; the per-channel vectors sit in shared memory, laid out so that a
// warp's reads of them meet no bank conflict. The element-wise version was
// bound by the SM's conversion unit (int -> float, float -> bf16, rint,
// float -> int, the reciprocal: 16 results per clock against 128 for f32
// arithmetic), so codes convert by integer tricks (`s8pair`, `code`).
// Rows whose width is not a multiple of 16 (the prior's 41 f32 channels, the
// heads' 41 bf16 logits) load element by element; their stores stay 16 bytes
// wide when Cp allows.
//
// Two prologue modes take the hourglass's max-pool and junction, the work of
// K13 (`csrc/int8_pool_junction.cu`, kept as the earlier design), into this
// pass (`kMode`; the plain instances compile as before):
//   pool (`maxpool` `:286-290`, then the `nrq` that reads its result): the
//     s8 input of output pixel (n, h, w) is the max of x's 2x2 window at
//     (n, 2h, 2w) — four 16-byte loads and `__vmaxs4` — and the raw output
//     is that pooled code itself (the pooled tensor, which the block's skip
//     reads), the normalised output its nrq;
//   junction (`upsample_add` `:292-300`, then its `quant` / `quant_pair`):
//     x2 is read at (n, h / 2, w / 2) of its [N, H/2, W/2, C] codes, the
//     nearest-2x upsample through indices; the prologue's sum is the
//     junction's bf16(q1 s1) + bf16(q2 s2), so its bf16 tensor is never
//     written (at 8 x 64 x 64 x 256 the junction and its quant_pair move
//     27.3 MB instead of 60.9).
// Both derive the pixel's (n, h, w) from its index with one 32-bit division
// by the row width (and one by the height for an odd pooled height).
//
// f32 operations (`f32_ops`): the raw codes of the quantized PkpNet's
// convolution inputs, `suo_slam_tpu/models/quant.py` `Conv` (`:84-87`):
//   out_raw[p, c] = clip(rint(RN_f32(f32(x) / div[c])), -127, 127)
// with div the per-tensor f32 s_x broadcast over C: a bf16 input is widened
// to f32 (exactly) and takes the f32 path (`code_div`) instead of the bf16
// chain; an f32 input computes so anyway. No prologue in this mode. The
// outputs stay Cp wide and zero beyond C, as K11 reads them (the stem's 3
// channels in 16-byte rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 1024;  // per-channel vectors in shared memory: 288 B per 16 channels

struct QuantArgs {
  const void* x;         // [P, C] f32 / bf16 / s8
  const int8_t* x2;      // [P, C] s8 or null
  const __nv_bfloat16* add;  // [P, C] bf16 or null
  const float* vec[6];   // s1, s2, add vector, div, m, cc ([C] f32 or null)
  int8_t* out_raw;       // [P, Cp] or null
  int8_t* out_norm;      // [P, Cp] or null
  long long P;           // output pixels
  int C, Cp;
  int wide;              // Cp % 16 == 0 and both outputs 16-byte aligned
  int H, W;              // pool: x's (unpooled) extents; junction: the output's
};

enum { kS1, kS2, kAddV, kDiv, kM, kCc };
enum { kPlain = 0, kPool = 1, kUp = 2 };  // the prologue modes (the entry's `mode`)

// bf16x2 arithmetic, each half rounded once to nearest even (sm_90). On bf16
// operands it equals the f32 operation rounded to bf16, which is what the
// plain version and XLA compute: f32 carries p' = 24 >= 2p + 2 bits for
// bf16's p = 8, so that double rounding is innocuous (Figueroa).
__device__ __forceinline__ unsigned bmul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned badd2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float lo_f(unsigned p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(unsigned p) { return __uint_as_float(p & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_rn(float lo, float hi) {  // each rounded to bf16
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The conversions below avoid the SM's conversion unit (16 results per clock
// against 128 for f32 arithmetic), which bound the element-wise version.
//
// s8 codes: bytes k0, k0 + 1 of w as a bf16x2 (exact). A byte permute makes
// the f32 2^23 + (b + 128) of each byte b; less 2^23 + 128 it is b, whose
// high half is its bf16.
__device__ __forceinline__ unsigned s8pair(unsigned w, int k0) {
  const unsigned u = w ^ 0x80808080u;
  const float f0 = __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | k0)),
                             -8388736.f);
  const float f1 = __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + k0)),
                             -8388736.f);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// clip(rint(v), -127, 127) in the low byte of the result: clipped first
// (rint keeps [-127, 127]), then rounded to nearest even by the addition of
// 1.5 * 2^23, after which the low mantissa bits hold the integer.
__device__ __forceinline__ unsigned code(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
}

// four codes' low bytes as one word
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// bf16(x / d) for bf16 x and d, r = RN(1 / d), is bf16(x r): x r is within
// 2 f32 ulps of x / d, while x / d is never a bf16 midpoint m (x = m d would
// need the 9 significant bits of m's odd significand times d's) and lies
// more than 128 ulps from every one (x - m d is a nonzero multiple of
// 2^(em + ed - 15), and d < 2^(ed + 1)), so both round alike.
__device__ __forceinline__ float quot_bf16(float x, float r) { return __fmul_rn(x, r); }

// The code of x / d for f32 x and d (r = RN(1 / d)): x r is within 2 ulps of
// x / d, so it has the rint of RN(x / d) unless a half-integer lies within
// 2^-10 of it; there the correctly rounded quotient decides, computed only
// by the lanes that need it (a select would compute it everywhere).
__device__ __forceinline__ unsigned code_div(float x, float d, float r) {
  float q = __fmul_rn(x, r);
  const float t = fminf(fmaxf(q, -128.f), 128.f);
  const float k = __fadd_rn(__fadd_rn(t, 12582912.f), -12582912.f);
  const bool near = fabsf(__fadd_rn(fabsf(__fadd_rn(t, -k)), -0.5f)) < 0x1p-10f;
  if (__any_sync(__activemask(), near)) {
    if (near) q = __fdiv_rn(x, d);
  }
  return code(q);
}

// 16 consecutive values from element i as packed words (16 for f32, 8 for
// bf16, 4 for s8): 16-byte loads, or element loads of the first n (zero
// beyond) where the row is not a multiple of 16 channels
template <typename T>
struct Packed {
  static constexpr int kWords = 16 * (int)sizeof(T) / 4;
  unsigned w[kWords];
  __device__ __forceinline__ void load(const T* x, long long i) {
    const uint4* p = reinterpret_cast<const uint4*>(x + i);
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      const uint4 v = __ldg(p + k);
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
  }
  __device__ __forceinline__ void load_n(const T* x, long long i, int n) {
    constexpr int per = 4 / (int)sizeof(T), bits = 8 * (int)sizeof(T);
    const auto* e = reinterpret_cast<const std::conditional_t<
        sizeof(T) == 4, unsigned, std::conditional_t<sizeof(T) == 2, uint16_t, uint8_t>>*>(x + i);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      unsigned v = 0;
#pragma unroll
      for (int j = 0; j < per; ++j)
        if (k * per + j < n) v |= (unsigned)e[k * per + j] << (bits * j);
      w[k] = v;
    }
  }
};

// p / d for a pixel index, in 32 bits where the count allows
__device__ __forceinline__ long long pdiv(long long p, int d, long long n) {
  return n <= 0xffffffffLL ? (long long)((unsigned)p / (unsigned)d) : p / d;
}

// One pass: kVec when C == Cp, C % 16 == 0 and every pointer is 16-byte
// aligned (one vector per 16 channels, no tail). T float computes in f32,
// bf16 and s8 in bf16 (pairs of channels in bf16x2), bf16 with kF32 in f32.
// kU vectors per pass, all their loads issued before any arithmetic; three
// blocks on an SM (at most 85 registers) keep more of them in flight than
// two did. kMode: kPool (T s8, no other prologue operand, the raw output the
// pooled codes) or kUp (x2 at half resolution).
template <typename T, bool kVec, int kU, bool kF32 = false, int kMode = kPlain>
__global__ void __launch_bounds__(kThreads, 3) int8_quant_kernel(QuantArgs a) {
  constexpr bool kBf16 = !std::is_same<T, float>::value && !kF32;
  // Per-channel vectors, laid out so that a warp's reads are conflict-free
  // (its lanes hold consecutive 16-channel vectors v; a [C] layout puts them
  // 64 bytes apart, 4- to 16-way conflicts): for channel c = 16 v + k, dr at
  // k * nv + v holds (div, RN(1 / div)) and, in f32, mc (m, cc); in bf16 the
  // bf16x2 pairs of s1, s2, add vector, m and cc sit at (j * 8 + k / 2) * nv + v.
  extern __shared__ float2 sp[];
  const int nv = (a.C + 15) >> 4, n = 16 * nv;
  float2* dr = sp;
  float2* mc = sp + n;                                   // f32
  unsigned* pr = reinterpret_cast<unsigned*>(sp + n);    // bf16: 5 x 8 x nv
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int k = c & 15, v = c >> 4;
    const bool in = c < a.C;
    const float* dv = a.vec[kDiv];
    if (dv != nullptr) {
      float d = in ? dv[c] : 1.f;
      if (kBf16) d = __bfloat162float(__float2bfloat16_rn(d));
      dr[k * nv + v] = make_float2(d, __frcp_rn(d));
    }
    if (!kBf16) {
      if (a.vec[kM] != nullptr)
        mc[k * nv + v] = make_float2(in ? a.vec[kM][c] : 0.f, in ? a.vec[kCc][c] : 0.f);
    } else if ((k & 1) == 0) {
      const int js[5] = {kS1, kS2, kAddV, kM, kCc};
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float* u = a.vec[js[j]];
        if (u != nullptr)
          pr[(j * 8 + (k >> 1)) * nv + v] =
              pack_rn(in ? u[c] : 0.f, c + 1 < a.C ? u[c + 1] : 0.f);
      }
    }
  }
  __syncthreads();
  const bool has_s1 = a.vec[kS1] != nullptr, has_x2 = a.x2 != nullptr;
  const bool has_add = a.add != nullptr, has_addv = a.vec[kAddV] != nullptr;
  const bool has_raw = a.out_raw != nullptr, has_norm = a.out_norm != nullptr;
  const unsigned nvec = (unsigned)(a.Cp + 15) >> 4;
  const long long total = a.P * nvec;
  const T* x = reinterpret_cast<const T*>(a.x);

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t0 = blockIdx.x * (long long)kThreads + threadIdx.x; t0 < total;
       t0 += kU * stride) {
    long long pix[kU];
    int vi[kU];
    Packed<T> xw[kU];
    Packed<int8_t> w2[kU];
    Packed<__nv_bfloat16> uw[kU];
    Packed<int8_t> win[kPool == kMode ? kU : 1][3];  // pool: the window's other three
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const long long t = t0 + q * stride;
      if (t >= total) break;
      // pixel and vector (32-bit where the count allows)
      const long long p = total <= 0xffffffffLL ? (long long)((unsigned)t / nvec) : t / nvec;
      vi[q] = (int)(t - p * nvec);
      pix[q] = p;
      const long long i0 = p * a.C + 16 * vi[q];  // input offset of the vector
      const int m = a.C - 16 * vi[q];  // channels of this vector in the input
      if constexpr (kMode == kPool) {
        static_assert(std::is_same<T, int8_t>::value, "the pool reads s8 codes");
        // the window's first input pixel: row n H + 2 h = 2 r + n (H & 1) of
        // the output row r = n (H / 2) + h, column 2 w
        const int wo = a.W >> 1;
        const long long r = pdiv(p, wo, a.P);
        const long long row = 2 * r + ((a.H & 1) ? pdiv(r, a.H >> 1, a.P) : 0);
        const long long j0 = (row * a.W + 2 * (p - r * wo)) * a.C + 16 * vi[q];
        const long long o[3] = {j0 + a.C, j0 + (long long)a.W * a.C,
                                j0 + (long long)a.W * a.C + a.C};
        if (kVec) {
          xw[q].load(x, j0);
#pragma unroll
          for (int i = 0; i < 3; ++i) win[q][i].load(x, o[i]);
        } else {
          xw[q].load_n(x, j0, m);
#pragma unroll
          for (int i = 0; i < 3; ++i) win[q][i].load_n(x, o[i], m);
        }
      } else {
        long long i2 = i0;  // x2's offset: junction, its pixel (n, h / 2, w / 2)
        if constexpr (kMode == kUp) {
          const long long r = pdiv(p, a.W, a.P);  // n H + h, H even
          i2 = ((r >> 1) * (a.W >> 1) + ((p - r * a.W) >> 1)) * a.C + 16 * vi[q];
        }
        if (kVec) {
          xw[q].load(x, i0);
          if (has_x2) w2[q].load(a.x2, i2);
          if (has_add) uw[q].load(a.add, i0);
        } else {
          xw[q].load_n(x, i0, m);
          if (has_x2) w2[q].load_n(a.x2, i2, m);
          if (has_add) uw[q].load_n(a.add, i0, m);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (t0 + q * stride >= total) break;
      const int v = vi[q];
      if constexpr (kMode == kPool) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xw[q].w[k] = __vmaxs4(__vmaxs4(xw[q].w[k], win[q][0].w[k]),
                                __vmaxs4(win[q][1].w[k], win[q][2].w[k]));
      }
      unsigned rw[4], nw[4];  // the codes, packed as they are made
#pragma unroll
      for (int wq = 0; wq < 4; ++wq) {  // channels 4 wq .. 4 wq + 3 of the vector
        unsigned rc[4], nc[4];  // codes in the low bytes
        if constexpr (kBf16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jj = 2 * wq + h, at = jj * nv + v;  // channels 2 jj, 2 jj + 1
            unsigned xp;
            if constexpr (std::is_same<T, int8_t>::value)
              xp = s8pair(xw[q].w[wq], 2 * h);
            else
              xp = xw[q].w[jj];
            if (has_s1) {
              xp = bmul2(xp, pr[at]);
              if (has_x2) xp = badd2(xp, bmul2(s8pair(w2[q].w[wq], 2 * h), pr[8 * nv + at]));
            }
            if (has_add) xp = badd2(xp, uw[q].w[jj]);
            if (has_addv) xp = badd2(xp, pr[16 * nv + at]);
            if (kMode != kPool && has_raw) {
              const float2 d0 = dr[(2 * jj) * nv + v], d1 = dr[(2 * jj + 1) * nv + v];
              const unsigned qp = pack_rn(quot_bf16(lo_f(xp), d0.y), quot_bf16(hi_f(xp), d1.y));
              rc[2 * h] = code(lo_f(qp));
              rc[2 * h + 1] = code(hi_f(qp));
            }
            if (has_norm) {
              const unsigned yp = badd2(bmul2(xp, pr[24 * nv + at]), pr[32 * nv + at]);
              nc[2 * h] = code(fmaxf(lo_f(yp), 0.f));
              nc[2 * h + 1] = code(fmaxf(hi_f(yp), 0.f));
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * wq + i;
            float xv;
            if constexpr (std::is_same<T, float>::value)
              xv = __uint_as_float(xw[q].w[k]);
            else  // a bf16 widened to f32
              xv = (k & 1) ? hi_f(xw[q].w[k >> 1]) : lo_f(xw[q].w[k >> 1]);
            if (has_raw) {
              const float2 d = dr[k * nv + v];
              rc[i] = code_div(xv, d.x, d.y);
            }
            if (has_norm) {
              const float2 f = mc[k * nv + v];
              nc[i] = code(fmaxf(__fadd_rn(__fmul_rn(xv, f.x), f.y), 0.f));
            }
          }
        }
        // (codes of an output not written stay unset: that output is skipped)
        unsigned keep = 0xffffffffu;  // zero codes beyond C
        if (!kVec) {
          const int left = a.C - 16 * v - 4 * wq;
          keep = left >= 4 ? 0xffffffffu : left <= 0 ? 0u : (1u << (8 * left)) - 1u;
        }
        if (kMode == kPool)  // the raw output: the pooled codes themselves
          rw[wq] = xw[q].w[wq] & keep;
        else if (has_raw)
          rw[wq] = pack4(rc[0], rc[1], rc[2], rc[3]) & keep;
        if (has_norm) nw[wq] = pack4(nc[0], nc[1], nc[2], nc[3]) & keep;
      }
      const long long o = pix[q] * a.Cp + 16 * v;
      const bool wide = kVec || a.wide;
      int8_t* outs[2] = {a.out_raw, a.out_norm};
      const unsigned* words[2] = {rw, nw};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (outs[j] == nullptr) continue;
        const unsigned* pw = words[j];
        if (wide) {
          *reinterpret_cast<uint4*>(outs[j] + o) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
        } else {
          for (int k = 0; k < 16 && 16 * v + k < a.Cp; ++k)
            outs[j][o + k] = (int8_t)((pw[k >> 2] >> (8 * (k & 3))) & 0xff);
        }
      }
    }
  }
}

template <typename T, bool kVec, int kU, bool kF32, int kMode>
void launch_u(const QuantArgs& a, cudaStream_t s) {
  const long long total = a.P * ((a.Cp + 15) / 16);
  long long blocks = (total + kThreads * kU - 1) / (kThreads * kU);
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  const size_t smem = 288 * (size_t)((a.C + 15) / 16);  // dr + (mc or the bf16 pairs)
  int8_quant_kernel<T, kVec, kU, kF32, kMode><<<(unsigned)blocks, kThreads, smem, s>>>(a);
}

template <typename T, bool kF32 = false, int kMode = kPlain>
int launch(const QuantArgs& a, bool vec, cudaStream_t s) {
  if (a.P * ((a.Cp + 15) / 16) <= 0) return 0;
  if (vec)
    launch_u<T, true, 2, kF32, kMode>(a, s);
  else
    launch_u<T, false, 1, kF32, kMode>(a, s);
  return 0;
}

}  // namespace

// x: P output pixels x C channels, xdtype 0 = f32, 1 = bf16, 2 = s8 codes.
// The prologue: s1 [C] (dequantize x, which must then be s8), x2 [P, C] s8
// with s2 [C], add [P, C] bf16, addv [C]; each may be null. div [C] (raw
// output) and m, cc [C] (normalised output) are f32 arrays; out_raw /
// out_norm ([P, Cp] s8) may be null to skip that output. f32_ops: a bf16
// input computes in f32 (no prologue then). mode 1 (pool): x holds s8 codes
// [N, H, W, C] with P = N (H / 2) (W / 2), no other prologue operand and no
// div; out_raw takes the pooled codes. mode 2 (junction): x2 holds [N, H / 2,
// W / 2, C] codes for P = N H W output pixels, H and W even. vec: one
// 16-byte vector per 16 channels (`int8_kernels.plan_quant` decides it; it
// needs C == Cp, C % 16 == 0 and every tensor 16-byte aligned). Returns
// cudaErrorInvalidValue for C > 1024, Cp < C, a prologue with f32_ops, a
// mode's operands out of place, or vec where its conditions fail; else
// cudaGetLastError() after the launch.
extern "C" int suo_int8_quant(const void* x, int xdtype, const void* s1, const void* x2,
                              const void* s2, const void* add, const void* addv, long long P,
                              int C, int Cp, const void* div, const void* m, const void* cc,
                              void* out_raw, void* out_norm, int f32_ops, int mode, int H,
                              int W, int vec, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (C <= 0 || C > kMaxC || Cp < C) return bad;
  if (f32_ops && (xdtype == 2 || s1 || x2 || s2 || add || addv || mode != kPlain)) return bad;
  if (mode == kPool) {
    const long long px = (long long)(H / 2) * (W / 2);
    if (xdtype != 2 || s1 || x2 || s2 || add || addv || div || !out_raw || px <= 0 || P % px)
      return bad;
  } else if (mode == kUp) {
    if (xdtype != 2 || !s1 || !x2 || !s2 || H <= 0 || W <= 0 || (H | W) & 1 ||
        P % ((long long)H * W))
      return bad;
  } else if (mode != kPlain) {
    return bad;
  }
  QuantArgs a{x, (const int8_t*)x2, (const __nv_bfloat16*)add,
              {(const float*)s1, (const float*)s2, (const float*)addv, (const float*)div,
               (const float*)m, (const float*)cc},
              (int8_t*)out_raw, (int8_t*)out_norm, P, C, Cp, 0, H, W};
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  a.wide = (Cp & 15) == 0 && al(out_raw) && al(out_norm);
  if (vec && !(C == Cp && (C & 15) == 0 && al(x) && al(x2) && al(add) && al(out_raw) &&
               al(out_norm)))
    return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kPool) launch<int8_t, false, kPool>(a, vec, s);
  else if (mode == kUp) launch<int8_t, false, kUp>(a, vec, s);
  else if (xdtype == 0) launch<float>(a, vec, s);
  else if (xdtype == 1 && f32_ops) launch<__nv_bfloat16, true>(a, vec, s);
  else if (xdtype == 1) launch<__nv_bfloat16>(a, vec, s);
  else launch<int8_t>(a, vec, s);
  return (int)cudaGetLastError();
}
