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
//   d_low[n, i, j, c] = (dy[n, 2i, 2j, c] + dy[n, 2i, 2j + 1, c])
//                       + (dy[n, 2i + 1, 2j, c] + dy[n, 2i + 1, 2j + 1, c])
// summed in f32 and rounded once to the storage dtype. up1's cotangent is dy
// itself (the wrapper returns it; no kernel). Bound: bytes, dy read once and
// d_low written (a quarter of dy): at the largest junction of the train step
// (32 x 64 x 64 x 256 bf16) 67 + 17 MB, 25 us at 3.35 TB/s. Design: a thread
// per 16-byte vector of d_low channels (8 bf16 or 4 f32; the vector route,
// where C and both pointers allow) or per value (the scalar route), 4 of
// them a thread, all 16 loads issued before the first sum. A 2-D grid:
// blockIdx.y walks low rows r = n * H/2 + i, whose two dy rows are rows 2r
// and 2r + 1 of the [N * H, W, C] view, and x walks the row's (j, channel
// vector) pairs, so a warp reads two contiguous runs of dy, one a row. A
// thread's offsets within a row are the same for every row: they are taken
// once, with one 32-bit division, and then stepped by counters; index
// arithmetic is 32-bit and widened only at a row's base pointer (the wrapper
// refuses rows of 2^31 elements or more). The planner `plan_upsample_bwd`
// (`models/hourglass.py`) picks the route; the entry refuses a vector route
// that C or the pointers do not allow. Loads are streaming (`__ldcs`,
// evict-first): faster than plain loads alone and in the train step, where
// up1's branch reads dy again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

// K18 -------------------------------------------------------------------------
constexpr int kBwdUnroll = 4;  // vectors a thread

// V values of T as one load: 16 bytes on the vector route, one value on the
// scalar route; `get` widens them to f32 (exact), `put` rounds them once.
template <typename T, int V> struct Pack;
template <> struct Pack<float, 4> {
  using L = uint4;
  static __device__ __forceinline__ void get(const L& a, float* f) {
    f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
    f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
  }
  static __device__ __forceinline__ L put(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Pack<float, 1> {
  using L = float;
  static __device__ __forceinline__ void get(const L& a, float* f) { f[0] = a; }
  static __device__ __forceinline__ L put(const float* f) { return f[0]; }
};
template <> struct Pack<__nv_bfloat16, 8> {
  using L = uint4;
  static __device__ __forceinline__ void get(const L& a, float* f) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ L put(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // .x low
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Pack<__nv_bfloat16, 1> {
  using L = unsigned short;
  static __device__ __forceinline__ void get(const L& a, float* f) {
    f[0] = __uint_as_float((uint32_t)a << 16);
  }
  static __device__ __forceinline__ L put(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
};

// One block: blockDim.x threads (a multiple of 32, at most kThreads) over
// kBwdUnroll * blockDim.x loads of a low row, rows by blockIdx.y (strided by
// gridDim.y). cv = C / V loads a pixel; wv = W * cv loads a dy row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
upsample_add_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dlow, int rows, int W, int cv) {
  using P = Pack<T, V>;
  using L = typename P::L;
  const int wv = W * cv, lv = wv / 2;  // loads a dy row, stores a low row
  const int q0 = blockIdx.x * (kBwdUnroll * (int)blockDim.x) + (int)threadIdx.x;
  // (j, c) of the first load by one division, then stepped by blockDim.x
  int j = q0 / cv, c = q0 - j * cv;
  const int dj = (int)blockDim.x / cv, dc = (int)blockDim.x - dj * cv;
  int off[kBwdUnroll];  // dy offset (top-left load) in the top row
  bool ok[kBwdUnroll];
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    ok[u] = q0 + u * (int)blockDim.x < lv;
    off[u] = 2 * j * cv + c;
    j += dj;
    c += dc;
    if (c >= cv) { c -= cv; ++j; }
  }
  const L* src = reinterpret_cast<const L*>(dy);
  L* dst = reinterpret_cast<L*>(dlow);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const L* top = src + (size_t)r * (2 * (size_t)wv);
    L* out = dst + (size_t)r * lv;
    L a[kBwdUnroll], b[kBwdUnroll], d[kBwdUnroll], e[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (ok[u]) {
        a[u] = __ldcs(top + off[u]);
        b[u] = __ldcs(top + off[u] + cv);
        d[u] = __ldcs(top + off[u] + wv);
        e[u] = __ldcs(top + off[u] + wv + cv);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (ok[u]) {
        float fa[V], fb[V], fd[V], fe[V], s[V];
        P::get(a[u], fa);
        P::get(b[u], fb);
        P::get(d[u], fd);
        P::get(e[u], fe);
#pragma unroll
        for (int k = 0; k < V; ++k) s[k] = (fa[k] + fb[k]) + (fd[k] + fe[k]);
        out[q0 + u * (int)blockDim.x] = P::put(s);
      }
    }
  }
}

template <typename T, int V>
int launch_bwd(const void* dy, void* dlow, int N, int H, int W, int C, cudaStream_t s) {
  const int cv = C / V, rows = N * (H / 2), lv = (W / 2) * cv;
  int threads = (lv + kBwdUnroll - 1) / kBwdUnroll;
  threads = threads >= kThreads ? kThreads : (threads + 31) / 32 * 32;
  const int per_block = kBwdUnroll * threads;
  const dim3 grid((lv + per_block - 1) / per_block, rows < 65535 ? rows : 65535);
  upsample_add_bwd_kernel<T, V><<<grid, threads, 0, s>>>((const T*)dy, (T*)dlow, rows, W, cv);
  return (int)cudaGetLastError();
}

}  // namespace

// K18. dy [N, H, W, C], d_low [N, H/2, W/2, C] (NHWC). dtype: 0 = f32, 1 =
// bf16. vec: 1 = the vector route (16-byte loads; needs C a multiple of 16 /
// sizeof(T) and both pointers 16-byte aligned), 0 = the scalar route.
// Refuses odd H or W and rows of 2^31 elements or more
// (cudaErrorInvalidValue), as `plan_upsample_bwd` does.
extern "C" int suo_upsample_add_bwd(const void* dy, void* dlow, int N, int H, int W, int C,
                                    int dtype, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int esize = dtype == 0 ? 4 : 2;
  const bool aligned = ((uintptr_t)dy % 16 == 0) && ((uintptr_t)dlow % 16 == 0);
  if (N < 0 || H < 0 || W < 0 || C < 0 || H % 2 || W % 2 || (dtype != 0 && dtype != 1) ||
      2LL * W * C >= (1LL << 31) || (long long)N * (H / 2) >= (1LL << 31) ||
      (vec && (C % (16 / esize) || !aligned)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W * C == 0) return 0;
  if (dtype == 0)
    return vec ? launch_bwd<float, 4>(dy, dlow, N, H, W, C, s)
               : launch_bwd<float, 1>(dy, dlow, N, H, W, C, s);
  return vec ? launch_bwd<__nv_bfloat16, 8>(dy, dlow, N, H, W, C, s)
             : launch_bwd<__nv_bfloat16, 1>(dy, dlow, N, H, W, C, s);
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
