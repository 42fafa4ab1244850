// K11 — the int8 engine's convolution: s8 x s8 -> exact s32 sums, rounded once
// to bf16, then the engine's folded epilogue in bf16; or, for the quantized
// PkpNet's convolutions, the same sums through an f32 epilogue.
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
// bf16 operation, so each step here rounds too (route 0: `__fmul_rn`,
// `__fadd_rn`, `--fmad=false`; route 1: bf16x2 products and sums, the same
// roundings, see `bmul2`); the s32 -> bf16 conversion rounds once, to
// nearest even (`acc_f32`). s32 sums are exact in any order, so the result
// is bit-equal to the plain version whatever the tiling.
//
// The f32 epilogue (modes 2 and 3) replaces the int8 branch of
// `suo_slam_tpu/models/quant.py` `Conv` (`:82-96`), after its quantize (K12):
//   z = f32(y) * e1[co] + e2[co]   (e1 = s_x * s_w, e2 = the bias)
// each step rounded in f32 (`__int2float_rn`, `__fmul_rn`, `__fadd_rn`: XLA
// on the CPU rounds the product and the sum on their own), then one cast to
// the output: f32 (mode 2) or bf16 (mode 3). The modes, `mode` below: 0 the
// engine's bf16 epilogue written as bf16 (`conv_raw`), 1 written as s8 codes
// (`conv_nrq`), 2 and 3 the f32 epilogue.
//
// Layout: activations NHWC [N, H, W, Cin_p] s8 with Cin_p % 16 == 0 (K12
// writes the prior's and the heads' 41 channels 48 wide); weights [Cout, KH,
// KW, Cin_p] s8 (arranged once by `quantize_weights`); output NHWC [N, Ho,
// Wo, Cout].
//
// Bound on this card: int8 tensor-core operations at 1,979 TOP/s for the 3x3
// convolutions, bytes at 3.35 TB/s for most 1x1 ones (at 8 x 64 x 64: 3x3
// 128->128 is 9.66 G operations, 4.9 us; 1x1 256->128 moves 8.4 + 8.4 MB).
//
// Route 1, every stride-1 convolution ("SAME", Cout <= 512): an implicit
// GEMM, M = output pixels, N = Cout, K = KH x KW x Cin_p, on Hopper's
// `wgmma.mma_async` m64n64k32 s8 x s8 -> s32 with both operands K-major in
// shared memory. A tile is Nt x Ht x Wt <= 128 pixels (the host planner,
// `int8_kernels.plan_conv`, picks it so that every hourglass level fits:
// 1 x 1 x 128 at 128x128, 1 x 2 x 64 at 64x64, ..., 8 x 4 x 4 at 4x4, small
// levels spanning several images) by an N tile of 64 or 128 columns (a Cout
// of 256 takes two N tiles, neighbours in the tile order, so the second
// reads the activations from L2). Blocks are persistent, two on each SM,
// each taking every gridDim-th tile. One producer warp feeds a ring of 2-6
// stages (as deep as the shared memory of two blocks allows; a 128-byte
// channel box wherever Cin allows, which beat deeper rings of 64-byte ones)
// through TMA:
// per (tap r, s, channel chunk) one box of the 4-D tensor map over [N, H, W,
// Cin_p] at (c0, w0 - pad + s, h0 - pad + r, n0) — TMA's out-of-bounds zero
// fill is the SAME padding and also fills the channel tail (Cin_p 48 in a
// 64-byte box) — and one box of the weights' 3-D map over [Cout, KH*KW,
// Cin_p] (rows beyond Cout read as zero); it runs on into the next tile
// while the consumers finish this one, so loads overlap the epilogue. Two
// consumer warpgroups, 64 pixel rows each, run the products; `mbarrier`s
// hand each stage over both ways. The epilogue (bf16x2 arithmetic, no
// conversion unit: see `epilogue2`) reads e1 / e2 (staged once per block)
// from shared memory, writes the tile into its own output buffer
// and stores its rows with coalesced 16-byte stores (element stores where a
// row is not a multiple of 16 bytes: the heads' Cout = 41 bf16 makes 82
// bytes).
//
// Route 0, the concat stem's 7x7 stride-2 prior convolution (not on the
// post_stem path): the earlier `mma.sync.m16n8k32` implicit GEMM (128 pixels
// x 64 channels per block) with a `cp.async` double buffer.
//
// Traps, each handled below:
// - The shared-memory descriptor's swizzle must match the tensor map's: a
//   64-byte box row uses the 64 B swizzle (descriptor layout 2, 512-byte
//   8-row atoms), a 128-byte one the 128 B swizzle (layout 1, 1024-byte
//   atoms); stage buffers sit on 1024-byte boundaries.
// - `cuTensorMapEncodeTiled` is a driver API: it is fetched with
//   `cudaGetDriverEntryPoint`, so the build stays a plain `nvcc` line.
// - Global strides must be multiples of 16 bytes: Cin_p % 16 == 0.
// - Above 48 KB of dynamic shared memory the entry point calls
//   `cudaFuncSetAttribute` once per kernel instance.
// - ptxas serializes every `wgmma` of a kernel where one sits on a path it
//   cannot prove warp-uniform (warning C7518): the warp's role comes from a
//   `__shfl_sync`, the K steps are a template constant and no consumer
//   skips the products of a partial tile (its rows are discarded).
// - Tensor maps are cached per (pointer, shape, box), so the host cost per
//   call does not grow with the calls.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An f32 whose bf16 rounding is the single rounding bf16(v) of an s32 sum
// v: below 2^22 in magnitude v itself, exactly, as 1.5 * 2^23 + v (an
// integer add to the bits, no conversion unit) less 1.5 * 2^23; else its
// truncation with a sticky bit (an s32 above 2^24 would otherwise round
// twice)
__device__ __forceinline__ float acc_f32(int v) {
  if ((unsigned)(v + (1 << 22)) < (1u << 23))
    return __fadd_rn(__int_as_float(0x4B400000 + v), -12582912.f);
  float rz = __int2float_rz(v);
  if ((int)rz != v) rz = __uint_as_float(__float_as_uint(rz) | 1u);
  return rz;
}

// the f32 epilogue of one accumulator (modes 2, 3): f32(acc) * e1 + e2
__device__ __forceinline__ float epilogue_f32(int acc, float e1, float e2) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), e1), e2);
}

// the folded epilogue of one accumulator (route 0): bf16 bits or an s8 code
// (modes 0, 1), or the f32 epilogue's value (modes 2, 3)
__device__ __forceinline__ float epilogue(int acc, float e1, float e2, int mode) {
  if (mode >= 2) return epilogue_f32(acc, e1, e2);
  const float y = bf16r(acc_f32(acc));
  float z = bf16r(__fmul_rn(y, e1));
  z = bf16r(__fadd_rn(z, e2));
  if (mode == 1) z = fminf(rintf(fmaxf(z, 0.f)), 127.f);
  return z;
}

// Route 1's epilogue computes on bf16x2 pairs of columns and keeps off the
// SM's conversion unit (16 results per clock against 128 for f32
// arithmetic), which bound the element-wise epilogue above. bf16x2
// products and sums round each half once to nearest even (sm_90); on bf16
// operands that equals the f32 operation rounded to bf16, as the plain
// version computes it: f32 carries p' = 24 >= 2p + 2 bits for bf16's p = 8,
// so the double rounding is innocuous (Figueroa).
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

// clip(rint(max(z, 0)), 0, 127) in the low byte: clipped first (rint keeps
// [0, 127]), then rounded to nearest even by the addition of 1.5 * 2^23,
// after which the low mantissa bits hold the integer
__device__ __forceinline__ unsigned code_relu(float z) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(z, 0.f), 127.f), 12582912.f));
}

// the folded epilogue of columns c, c + 1 as a bf16x2: y = bf16(acc),
// z = bf16(bf16(y * e1) + e2), e1 / e2 the columns' bf16x2 pairs
__device__ __forceinline__ unsigned epilogue2(int a0, int a1, unsigned e1, unsigned e2) {
  return badd2(bmul2(pack_rn(acc_f32(a0), acc_f32(a1)), e1), e2);
}

// ------------------------------------------------------------------ route 1 --
constexpr int kRows = 128;                  // pixel rows per tile (2 x 64)
constexpr int kConsumers = 256;             // 2 warpgroups
constexpr int kThreads1 = kConsumers + 32;  // + 1 producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxCout = 512;               // e1 / e2 staged whole in shared memory
constexpr int kSmemBudget = 115712;         // dynamic shared memory of one of 2 blocks per SM

struct WgArgs {
  const float* e1;
  const float* e2;
  void* out;
  int N, H, W, Cout, KH, KW, pad, mode;
  int Nt, Ht, Wt, n_chunks, stages;
  int tiles_w, tiles_h, n_cols, n_tiles;  // pixel tiles along W and H; N tiles; all tiles
};

// bytes of an output value of a mode, and of its row of the output tile in
// shared memory (s8 rows take the bf16 size)
__host__ __device__ inline int out_bytes(int mode) { return mode == 1 ? 1 : mode == 2 ? 4 : 2; }
__host__ __device__ inline int tile_bytes(int mode) { return mode == 2 ? 4 : 2; }
// bytes of e1 / e2 per column: a bf16 each (pairs), or an f32 each (f32 epilogue)
__host__ __device__ inline int e_bytes(int mode) { return mode >= 2 ? 8 : 4; }

// dynamic shared memory of the wgmma route (the planner's formula:
// `int8_kernels.wg_smem`): 1 KB of alignment, the ring, the output tile,
// the barriers, e1 / e2 and the rows' output offsets
inline size_t wg_smem(int stages, int bn, int cbox, int n_cols, int mode) {
  return 1024 + (size_t)stages * (kRows + bn) * cbox +
         (size_t)kRows * (tile_bytes(mode) * bn + 16) + 16 * (size_t)stages +
         (size_t)e_bytes(mode) * n_cols * bn + 8 * kRows;
}

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// K-major operand in shared memory, rows of `row_bytes` (64 or 128) swizzled
// to match the tensor map: layout 1 = 128 B swizzle, 2 = 64 B swizzle; the
// stride between 8-row groups (SBO) is 8 rows; LBO is unused for swizzled
// K-major layouts.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)((8 * row_bytes) >> 4) << 32;
  d |= layout << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 64] += A[64 x 32] * B[64 x 32]^T, s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8_64x64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"  // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// NT: 64-column N chunks of the N tile (bn = 64 NT); KS: 32-byte K steps
// of a stage (cbox = 32 KS bytes of input channels); kF32E: the f32
// epilogue (modes 2, 3; its own instances, so the engine's bf16 ones keep
// their registers). Persistent: block b
// takes the tiles b, b + gridDim.x, ... (the N tiles of one pixel tile are
// neighbours, so they read its activations from L2), the producer running
// ahead across tiles, so that the next tile's loads overlap this one's
// epilogue, and the other block on the SM computes while this one stores.
template <int NT, int KS, bool kF32E>
__global__ void __launch_bounds__(kThreads1, 2)
int8_conv_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, WgArgs a) {
  constexpr int bn = 64 * NT, cbox = 32 * KS;
  constexpr int a_bytes = kRows * cbox, b_bytes = bn * cbox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = a.stages;
  constexpr bool f32e = kF32E;                        // the f32 epilogue
  const int osz = out_bytes(a.mode);
  const int pitch = bn * osz + 16;                    // output tile row, padded
  uint8_t* As = smem;                                 // S x [128][cbox]
  uint8_t* Bs = As + S * a_bytes;                     // S x [bn][cbox]
  uint8_t* ot = Bs + S * b_bytes;                     // [128][pitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(ot + kRows * (tile_bytes(a.mode) * bn + 16));
  uint64_t* empty = full + S;
  // e1 / e2: [n_cols * bn / 2] bf16x2 pairs each, or [n_cols * bn] f32 each
  const int e_words = a.n_cols * bn * e_bytes(a.mode) / 8;
  unsigned* e1p = reinterpret_cast<unsigned*>(empty + S);
  unsigned* e2p = e1p + e_words;
  const float* e1f = reinterpret_cast<const float*>(e1p);
  const float* e2f = reinterpret_cast<const float*>(e2p);
  long long* row_off = reinterpret_cast<long long*>(e2p + e_words);  // -1: no pixel

  const int tid = threadIdx.x;
  const int rows = a.Nt * a.Ht * a.Wt;
  const int n_iter = a.KH * a.KW * a.n_chunks;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < e_words; i += kThreads1) {
    if (f32e) {  // column i
      e1p[i] = __float_as_uint(i < a.Cout ? a.e1[i] : 0.f);
      e2p[i] = __float_as_uint(i < a.Cout ? a.e2[i] : 0.f);
    } else {  // columns 2 i, 2 i + 1
      const int c = 2 * i;
      e1p[i] = pack_rn(c < a.Cout ? a.e1[c] : 0.f, c + 1 < a.Cout ? a.e1[c + 1] : 0.f);
      e2p[i] = pack_rn(c < a.Cout ? a.e2[c] : 0.f, c + 1 < a.Cout ? a.e2[c + 1] : 0.f);
    }
  }
  __syncthreads();
  // the warp's role, warp-uniform by construction: 0 / 1 consumer
  // warpgroups, 2 the producer (wgmma outside a provably uniform path is
  // serialized by ptxas)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == 2) {  // producer warp: one lane issues every TMA load
    if (tid == kConsumers) {
      const uint32_t tx = (uint32_t)(rows * cbox + b_bytes);
      int git = 0;
      for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
        const int pt = t / a.n_cols, co0 = (t - pt * a.n_cols) * bn;
        const int w0 = (pt % a.tiles_w) * a.Wt;
        const int h0 = ((pt / a.tiles_w) % a.tiles_h) * a.Ht;
        const int n0 = (pt / (a.tiles_w * a.tiles_h)) * a.Nt;
        for (int it = 0; it < n_iter; ++it, ++git) {
          const int s = git % S;
          if (git >= S) mbar_wait(&empty[s], ((git / S) - 1) & 1);
          const int tap = it / a.n_chunks, cc = it - tap * a.n_chunks;
          const int r = tap / a.KW, q = tap - r * a.KW;
          mbar_expect_tx(&full[s], tx);
          tma_load_4d(As + s * a_bytes, &xmap, &full[s], cc * cbox, w0 - a.pad + q,
                      h0 - a.pad + r, n0);
          tma_load_3d(Bs + s * b_bytes, &wmap, &full[s], cc * cbox, tap, co0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns pixel rows 64 g .. 64 g + 63 of each tile
  const int g = role, wi = (tid >> 5) & 3, lane = tid & 31;
  int git = 0;
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    int acc[NT][32];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0;
    for (int it = 0; it < n_iter; ++it, ++git) {
      const int s = git % S;
      mbar_wait(&full[s], (git / S) & 1);
      const uint32_t a0 = smem_u32(As + s * a_bytes + g * 64 * cbox);
      const uint32_t b0 = smem_u32(Bs + s * b_bytes);
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wgmma_s8_64x64(acc[j], smem_desc(a0 + kk * 32, cbox),
                         smem_desc(b0 + j * 64 * cbox + kk * 32, cbox));
      wgmma_commit();
      // keep this stage's products in flight; the previous stage's are done
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_acc(acc[j]);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(git - 1) % S]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_acc(acc[j]);
    if (lane == 0) mbar_arrive(&empty[(git - 1) % S]);

    // epilogue: the accumulators, through the folded epilogue, into the
    // output tile in shared memory, then coalesced stores of its rows
    const int pt = t / a.n_cols, co0 = (t - pt * a.n_cols) * bn;
    const int w0 = (pt % a.tiles_w) * a.Wt;
    const int h0 = ((pt / a.tiles_w) % a.tiles_h) * a.Ht;
    const int n0 = (pt / (a.tiles_w * a.tiles_h)) * a.Nt;
    consumer_sync();  // the previous tile's stores have read ot and row_off
    if (tid < kRows) {  // each tile row's output pixel
      const int r = tid;
      const int n = n0 + r / (a.Wt * a.Ht), h = h0 + (r / a.Wt) % a.Ht, w = w0 + r % a.Wt;
      row_off[r] = (r < rows && n < a.N && h < a.H && w < a.W)
                       ? ((((long long)n * a.H + h) * a.W + w) * a.Cout + co0) * osz
                       : -1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {  // columns col, col + 1 of one row
        const int col = 64 * j + 8 * (i >> 2) + 2 * (lane & 3);
        const int row = 64 * g + 16 * wi + (lane >> 2) + 8 * ((i >> 1) & 1);
        if constexpr (f32e) {
          const int c = co0 + col;
          const float z0 = epilogue_f32(acc[j][i], e1f[c], e2f[c]);
          const float z1 = epilogue_f32(acc[j][i + 1], e1f[c + 1], e2f[c + 1]);
          if (a.mode == 2)
            *reinterpret_cast<float2*>(ot + row * pitch + 4 * col) = make_float2(z0, z1);
          else
            *reinterpret_cast<unsigned*>(ot + row * pitch + 2 * col) = pack_rn(z0, z1);
          continue;
        }
        const int pc = (co0 + col) >> 1;
        const unsigned z = epilogue2(acc[j][i], acc[j][i + 1], e1p[pc], e2p[pc]);
        if (a.mode == 1)
          *reinterpret_cast<uint16_t*>(ot + row * pitch + col) = (uint16_t)__byte_perm(
              code_relu(lo_f(z)), code_relu(hi_f(z)), 0x0040);
        else
          *reinterpret_cast<unsigned*>(ot + row * pitch + 2 * col) = z;
      }
    }
    consumer_sync();
    // a tile row is one output pixel: its bytes are contiguous in the output
    const int ncol = min(bn, a.Cout - co0);
    const int rb = ncol * osz;  // bytes of a row this tile writes
    const bool vec = (rb % 16) == 0 && ((a.Cout * osz) % 16) == 0;  // (co0 * osz % 16 == 0)
    const int unit = vec ? 16 : osz;
    const int per_row = rb / unit;
    uint8_t* out = reinterpret_cast<uint8_t*>(a.out);
    for (int e = tid; e < rows * per_row; e += kConsumers) {
      const int row = e / per_row, k = e - row * per_row;
      const long long o = row_off[row];
      if (o < 0) continue;
      const uint8_t* src = ot + row * pitch + k * unit;
      if (vec)
        *reinterpret_cast<uint4*>(out + o + k * 16) = *reinterpret_cast<const uint4*>(src);
      else if (osz == 4)
        *reinterpret_cast<uint32_t*>(out + o + k * 4) = *reinterpret_cast<const uint32_t*>(src);
      else if (osz == 2)
        *reinterpret_cast<uint16_t*>(out + o + k * 2) = *reinterpret_cast<const uint16_t*>(src);
      else
        out[o + k] = *src;
    }
  }
}

// host: the driver's tensor-map encoder, fetched once through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

struct MapKey {
  uint64_t v[11];
  bool operator==(const MapKey& o) const { return memcmp(v, o.v, sizeof(v)) == 0; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t x : k.v) h = (h ^ x) * 1099511628211ull;
    return (size_t)h;
  }
};

std::mutex g_map_mu;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;

// A tiled map of s8 data (cached): rank dims (innermost first), byte strides
// of dims 1.., box; swizzle by the box's inner bytes (64 or 128). Copied out,
// since the cache may be cleared by the next call. False on failure.
bool tensor_map(CUtensorMap* out, const void* ptr, int rank, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box) {
  MapKey k{};
  k.v[0] = (uint64_t)ptr;
  k.v[1] = (uint64_t)rank;
  for (int i = 0; i < rank; ++i) {
    k.v[2 + i] = dims[i];
    k.v[6 + i] = (uint64_t)box[i] << 32 | (i + 1 < rank ? strides[i] & 0xffffffffull : 0);
  }
  std::lock_guard<std::mutex> lock(g_map_mu);
  auto f = g_maps.find(k);
  if (f != g_maps.end()) {
    *out = f->second;
    return true;
  }
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return false;
  if (g_maps.size() > 4096) g_maps.clear();  // pointers recycle: bounded
  CUtensorMap m;
  cuuint32_t es[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      box[0] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUresult r = enc(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank, const_cast<void*>(ptr),
                   dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  g_maps[k] = m;
  *out = m;
  return true;
}

template <int NT, int KS, bool kF32E>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const WgArgs& a, int blocks,
                 size_t smem, cudaStream_t st) {
  static bool set = false;  // the attribute is raised once per instance
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_kernel_wgmma<NT, KS, kF32E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBudget);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  int8_conv_kernel_wgmma<NT, KS, kF32E><<<blocks, kThreads1, smem, st>>>(xm, wm, a);
  return 0;
}

template <bool kF32E>
int launch_wgmma_tile(const CUtensorMap& xm, const CUtensorMap& wm, const WgArgs& a, int bn,
                      int cbox, int blocks, size_t smem, cudaStream_t st) {
  if (bn == 64)
    return cbox == 64 ? launch_wgmma<1, 2, kF32E>(xm, wm, a, blocks, smem, st)
                      : launch_wgmma<1, 4, kF32E>(xm, wm, a, blocks, smem, st);
  return cbox == 64 ? launch_wgmma<2, 2, kF32E>(xm, wm, a, blocks, smem, st)
                    : launch_wgmma<2, 4, kF32E>(xm, wm, a, blocks, smem, st);
}

// SMs of the current device (cached per device)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// ------------------------------------------------------------------ route 0 --
constexpr int kBM = 128;           // output pixels per block
constexpr int kBN = 64;            // output channels per block
constexpr int kBK = 64;            // bytes of K (input channels) per stage
constexpr int kThreads0 = 256;     // 8 warps: 4 along M x 2 along N
constexpr int kLds = kBK / 4 + 4;  // 32-bit words per shared row

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* e1;
  const float* e2;
  void* out;
  int N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, mode;
};

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kThreads0) int8_conv_kernel_mma(ConvArgs a) {
  __shared__ __align__(16) unsigned As[2][kBM][kLds];
  __shared__ __align__(16) unsigned Bs[2][kBN][kLds];
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
    const int idx = tid + i * kThreads0;
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

  const int n_chunks = (a.Cin + kBK - 1) / kBK;
  const int n_steps = a.KH * a.KW * n_chunks;
  auto issue = [&](int step, int buf) {
    const int tap = step / n_chunks, kc = step % n_chunks;
    const int r = tap / a.KW, s = tap % a.KW, c0 = kc * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hi = a_hi[i] + r, wi = a_wi[i] + s;
      const int c = c0 + a_vec[i] * 16;
      const bool ok = a_ok[i] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W && c < a.Cin;
      const int8_t* src =
          ok ? a.x + ((a_n[i] * a.H + hi) * a.W + wi) * (long long)a.Cin + c : a.x;
      cp_async16(&As[buf][a_row[i]][a_vec[i] * 4], src, ok);
    }
    const int c = c0 + b_vec * 16;
    const bool ok = b_ok && c < a.Cin;
    const int8_t* src = ok ? a.w + (((long long)b_co * a.KH + r) * a.KW + s) * a.Cin + c : a.w;
    cp_async16(&Bs[buf][b_row][b_vec * 4], src, ok);
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0;

  issue(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) issue(step + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // (empty at the end)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const int k0 = kk * 8;  // first word of this 32-byte step
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + g;
        af[mi][0] = As[buf][row][k0 + t];
        af[mi][1] = As[buf][row + 8][k0 + t];
        af[mi][2] = As[buf][row][k0 + 4 + t];
        af[mi][3] = As[buf][row + 8][k0 + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + g;
        bf[ni][0] = Bs[buf][col][k0 + t];
        bf[ni][1] = Bs[buf][col][k0 + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
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
        const float z = epilogue(acc[mi][ni][k], a.e1[co], a.e2[co], a.mode);
        const long long o = m * a.Cout + co;
        if (a.mode == 1)
          reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)(int)z;
        else if (a.mode == 2)
          reinterpret_cast<float*>(a.out)[o] = z;
        else
          reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(z);
      }
    }
  }
}

}  // namespace

// x [N, H, W, Cin] s8 (Cin % 16 == 0, 16-byte aligned), w [Cout, KH, KW, Cin]
// s8, e1 / e2 [Cout] f32 (holding bf16 values in modes 0 and 1), out [N, Ho,
// Wo, Cout]: bf16 (mode 0, the engine's epilogue; mode 3, the f32 epilogue
// cast), s8 (mode 1) or f32 (mode 2, the f32 epilogue). The plan comes from `int8_kernels.plan_conv`: route 1
// (wgmma; stride 1, Ho = H, Wo = W, Cout <= 512) with the pixel tile
// Nt x Ht x Wt, the channel box cbox (64 or 128 bytes), the N tile bn (64 or
// 128) and the ring's stages (2-8); route 0 (mma.sync) ignores them. Returns a
// cudaError_t: cudaErrorInvalidValue for a plan the kernels do not take,
// cudaErrorNotSupported when the tensor maps cannot be made, else
// cudaGetLastError() after the launch.
extern "C" int suo_int8_conv(const void* x, const void* w, const void* e1, const void* e2,
                             void* out, int N, int H, int W, int Cin, int Cout, int KH,
                             int KW, int stride, int pad, int Ho, int Wo, int mode, int route,
                             int Nt, int Ht, int Wt, int cbox, int bn, int stages,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long M = (long long)N * Ho * Wo;
  if (M <= 0 || Cout <= 0) return (int)cudaGetLastError();
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    ConvArgs a{(const int8_t*)x, (const int8_t*)w, (const float*)e1, (const float*)e2, out,
               N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo, mode};
    dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Cout + kBN - 1) / kBN));
    int8_conv_kernel_mma<<<grid, kThreads0, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const int n_cols = (Cout + bn - 1) / bn;
  if (stride != 1 || Ho != H || Wo != W || Cin % 16 || (cbox != 64 && cbox != 128) ||
      (bn != 64 && bn != 128) || Cout > kMaxCout || Nt * Ht * Wt > kRows || Nt < 1 ||
      Ht < 1 || Wt < 1 || Wt > 256 || Ht > 256 || Nt > 256 || stages < 2 ||
      stages > kMaxStages)  // (one stage would deadlock: a stage is released
                            // only once the next one has arrived)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem(stages, bn, cbox, n_cols, mode);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  const uint64_t xd[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint64_t xs[3] = {(uint64_t)Cin, (uint64_t)W * Cin, (uint64_t)H * W * Cin};
  const uint32_t xb[4] = {(uint32_t)cbox, (uint32_t)Wt, (uint32_t)Ht, (uint32_t)Nt};
  const uint64_t wd[3] = {(uint64_t)Cin, (uint64_t)(KH * KW), (uint64_t)Cout};
  const uint64_t ws[2] = {(uint64_t)Cin, (uint64_t)KH * KW * Cin};
  const uint32_t wb[3] = {(uint32_t)cbox, 1u, (uint32_t)bn};
  CUtensorMap xm, wm;
  if (!tensor_map(&xm, x, 4, xd, xs, xb) || !tensor_map(&wm, w, 3, wd, ws, wb))
    return (int)cudaErrorNotSupported;
  const int tiles_w = (W + Wt - 1) / Wt, tiles_h = (H + Ht - 1) / Ht;
  const long long tiles = (long long)((N + Nt - 1) / Nt) * tiles_h * tiles_w * n_cols;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  WgArgs a{(const float*)e1, (const float*)e2, out, N, H, W, Cout, KH, KW, pad, mode,
           Nt, Ht, Wt, (Cin + cbox - 1) / cbox, stages, tiles_w, tiles_h, n_cols, (int)tiles};
  // persistent: two blocks on each SM (the planner keeps the shared memory
  // and the registers within that), none beyond the tiles
  const int blocks = (int)std::min<long long>(tiles, 2LL * sm_count());
  const int e = mode >= 2 ? launch_wgmma_tile<true>(xm, wm, a, bn, cbox, blocks, smem, st)
                          : launch_wgmma_tile<false>(xm, wm, a, bn, cbox, blocks, smem, st);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
