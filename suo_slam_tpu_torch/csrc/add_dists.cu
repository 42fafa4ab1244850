// K10 — ADD and ADD-S distances of predicted against ground-truth poses over
// padded object point clouds.
//
// Replaces `suo_slam_tpu/eval/meter.py` `_add_dists_kernel` (`:82-106`), which
// XLA runs over the full [B, P, P] squared-distance tensor (67 MB per object
// at P = 4096). Here that tensor never exists.
//
// Bound on this card: operations. At P = 4096 one pose needs n^2 = 16.8 M
// pairs x 9 f32 instructions (3 sub, 3 mul, 2 add, 1 min; --fmad=false keeps
// each separate) = 151 M instructions. The card issues ~33.5 T f32
// instructions a second (its 67 TFLOP/s counts an FMA as two), so ~4.5 us;
// the bytes (49 KB of points) are negligible.
//
// Design (`add_dists_kernel`, one launch per call): B = every scored
// (object, pose) pair of a scene. The points are the meter's resident
// [n_obj, P, 3] table, read through an object index per pose (no gather).
// The grid is (row tiles x column chunks, B): a 256-thread block owns 128
// ground-truth rows, each lane kRowsPerThread of them transformed into
// registers (every warp the same rows), and one chunk of predicted columns,
// transformed into shared memory as float4 (x, y, z, pad), of which each
// warp takes an eighth: one 16-byte broadcast load feeds kRowsPerThread x 9
// instructions. Chunks are sized on the host (`meter.plan_add_dists`) so
// that B = 1 still fills every SM and a larger B spreads over several waves
// of blocks. Each block takes the minimum over its warps in shared memory and
// merges it into a [B, P] scratch with one atomicMin a row, on the bits of
// the non-negative f32 d^2 (exact in any order); the chunk-0 blocks write
// the ADD term sqrt(d2(i, i)). The last block of a row tile (a per-tile
// arrival counter: a block barrier, then one release-acquire fence and atomic
// add by one thread, CUTLASS's idiom) takes its rows' square roots,
// zeroes the padded rows and sums both per-point distances over the tile in
// f64 in a fixed order (shuffle trees, then the warps in order); the last
// tile of a pose (a per-pose counter) sums the tiles' partials in tile
// order. So the means do not depend on B or on scheduling, and no block
// walks all P rows alone. Each finisher resets its rows' scratch to +inf and
// its counter to 0, so the next call on the stream finds them ready (the
// wrapper keeps them per device and stream, `meter._workspace`). The means
// divide by max(n, 1) in f32.
//
// Per-point arithmetic follows the plain version (`eval/meter.py`
// `add_dists_plain`) and JAX: transform (R x + t, products summed left to
// right), squared distance (dx^2 + dy^2) + dz^2, minimum, square root.
// Compiled with --fmad=false, the per-point distances equal the plain
// version's; only the means' order of summation differs.
//
// The earlier design (`suo_add_dists_two_pass`: a pairs pass of one
// 128-thread block per (128 rows, 512 columns, pose) writing per-chunk
// minima to a [B, chunks, P] scratch, then a reduce pass of one block per
// pose; a gathered [B, P, 3] cloud, one thread per row) stays below for
// chip_smoke's and the card tests' comparisons; the port does not call it.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kRows = 128;   // ground-truth points per block
constexpr int kCols = 512;   // predicted points per chunk
constexpr int kRed = 256;    // threads of the reduction

__device__ __forceinline__ void transform(const float* __restrict__ T, const float* x,
                                          float* p) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = T[k * 4 + 0] * x[0] + T[k * 4 + 1] * x[1] + T[k * 4 + 2] * x[2] + T[k * 4 + 3];
}

__global__ void __launch_bounds__(kRows)
add_dists_pairs_kernel(const float* __restrict__ points, const int* __restrict__ n_pts,
                       const float* __restrict__ T_pred, const float* __restrict__ T_gt,
                       int P, float* __restrict__ part, float* __restrict__ d_add) {
  __shared__ float sx[kCols], sy[kCols], sz[kCols];
  const int b = blockIdx.z, chunk = blockIdx.y, chunks = gridDim.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int n = n_pts[b];
  const float* pts = points + (long long)b * P * 3;
  const float* Tp = T_pred + b * 16;
  const float* Tg = T_gt + b * 16;
  const int c0 = chunk * kCols;
  const int c1 = min(c0 + kCols, n);  // valid columns of this chunk: [c0, c1)
  for (int j = c0 + threadIdx.x; j < c1; j += kRows) {
    float p[3];
    transform(Tp, pts + (long long)j * 3, p);
    sx[j - c0] = p[0];
    sy[j - c0] = p[1];
    sz[j - c0] = p[2];
  }
  __syncthreads();
  if (i >= P) return;
  float g[3];
  transform(Tg, pts + (long long)i * 3, g);
  float m = INFINITY;
  for (int j = 0; j < c1 - c0; ++j) {
    const float dx = g[0] - sx[j];
    const float dy = g[1] - sy[j];
    const float dz = g[2] - sz[j];
    const float d2 = dx * dx + dy * dy + dz * dz;
    m = fminf(m, d2);
  }
  part[((long long)b * chunks + chunk) * P + i] = m;
  if (chunk == 0) {
    float q[3];
    transform(Tp, pts + (long long)i * 3, q);
    const float dx = g[0] - q[0];
    const float dy = g[1] - q[1];
    const float dz = g[2] - q[2];
    d_add[(long long)b * P + i] = sqrtf(dx * dx + dy * dy + dz * dz);
  }
}

__global__ void __launch_bounds__(kRed)
add_dists_reduce_kernel(const int* __restrict__ n_pts, int P, int chunks,
                        const float* __restrict__ part, float* __restrict__ d_add,
                        float* __restrict__ d_adds, float* __restrict__ add,
                        float* __restrict__ adds) {
  __shared__ double s_add[kRed], s_adds[kRed];
  const int b = blockIdx.x;
  const int n = n_pts[b];
  double sa = 0.0, ss = 0.0;
  for (int i = threadIdx.x; i < P; i += kRed) {
    float m = INFINITY;
    for (int c = 0; c < chunks; ++c) m = fminf(m, part[((long long)b * chunks + c) * P + i]);
    const bool valid = i < n;
    const float da = valid ? d_add[(long long)b * P + i] : 0.f;
    const float ds = valid ? sqrtf(m) : 0.f;
    d_add[(long long)b * P + i] = da;
    d_adds[(long long)b * P + i] = ds;
    sa += (double)da;
    ss += (double)ds;
  }
  s_add[threadIdx.x] = sa;
  s_adds[threadIdx.x] = ss;
  __syncthreads();
  for (int off = kRed / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      s_add[threadIdx.x] += s_add[threadIdx.x + off];
      s_adds[threadIdx.x] += s_adds[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom = fmaxf((float)n, 1.f);
    add[b] = (float)s_add[0] / denom;
    adds[b] = (float)s_adds[0] / denom;
  }
}

// ---- the current design -------------------------------------------------------
constexpr int kThreads = 256;       // threads of add_dists_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;   // ground-truth rows a lane keeps in registers
constexpr int kRowsPerBlock = 32 * kRowsPerThread;  // every warp holds the same rows
constexpr int kMaxCols = 1024;      // predicted columns of a chunk (float4 in shared memory)
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: the scratch's resting value

// The block's arrival at a counter, as CUTLASS's generic barrier does it:
// after a block barrier (every thread's writes and atomics before it), thread
// 0 alone takes a release-acquire fence at device scope and adds one. True
// in the last of `total` arrivals; the block's threads read what the others
// wrote after the barrier that broadcasts the answer.
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned total, bool* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("fence.acq_rel.gpu;\n"
                 "atom.relaxed.gpu.global.add.u32 %0, [%1], 1;\n"
                 "fence.acq_rel.gpu;\n"
                 : "=r"(old) : "l"(counter) : "memory");
    *s_flag = old == total - 1;
  }
  __syncthreads();
  return *s_flag;
}

// sum of v over the block's first 128 threads in a fixed order (shuffle tree
// per warp, then the four warps in order), for every thread of the block
__device__ __forceinline__ double tile_sum(double v, double* s_part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0 && warp < 4) s_part[warp] = v;
  __syncthreads();
  return ((s_part[0] + s_part[1]) + s_part[2]) + s_part[3];
}

__global__ void __launch_bounds__(kThreads)
add_dists_kernel(const float* __restrict__ points, const int* __restrict__ counts,
                 const int* __restrict__ obj, const float* __restrict__ T_pred,
                 const float* __restrict__ T_gt, int P, int cols, int chunks, int row_tiles,
                 unsigned* __restrict__ minbits, unsigned* __restrict__ arrive,
                 double* __restrict__ part, float* __restrict__ d_add,
                 float* __restrict__ d_adds, float* __restrict__ add,
                 float* __restrict__ adds) {
  __shared__ float4 sp[kMaxCols];
  __shared__ float smin[kWarps][kRowsPerBlock];
  __shared__ double s_part[2][4];
  __shared__ bool s_last;
  const int b = blockIdx.y;
  const int tile = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = obj ? obj[b] : b;  // no table: pose b's own cloud
  const int n = counts[o];
  const float* pts = points + (long long)o * P * 3;
  const float* Tp = T_pred + b * 16;
  const float* Tg = T_gt + b * 16;
  unsigned* mb = minbits + (long long)b * P;
  float* da_row = d_add + (long long)b * P;
  const int r0 = tile * kRowsPerBlock;
  const int c0 = chunk * cols;
  const int c1 = min(c0 + cols, n);  // valid columns of this chunk: [c0, c1)

  if (r0 < n && c0 < c1) {
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
      float p[3];
      transform(Tp, pts + (long long)j * 3, p);
      sp[j - c0] = make_float4(p[0], p[1], p[2], 0.f);
    }
    // lane l holds rows r0 + r * 32 + l; warp w takes the w-th eighth of the columns
    float g[kRowsPerThread][3], m[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = r0 + r * 32 + lane;
      if (i < n) {
        transform(Tg, pts + (long long)i * 3, g[r]);
      } else {
        g[r][0] = g[r][1] = g[r][2] = 0.f;  // computed, never stored
      }
      m[r] = INFINITY;
    }
    __syncthreads();
    const int nc = c1 - c0;
    const int j0 = nc * warp / kWarps, j1 = nc * (warp + 1) / kWarps;
#pragma unroll 2
    for (int j = j0; j < j1; ++j) {
      const float4 q = sp[j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float dx = g[r][0] - q.x;
        const float dy = g[r][1] - q.y;
        const float dz = g[r][2] - q.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        m[r] = fminf(m[r], d2);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) smin[warp][r * 32 + lane] = m[r];
    __syncthreads();
    // one atomic per row of the block: the minimum over its warps
    const int t = threadIdx.x, i = r0 + t;
    if (t < kRowsPerBlock && i < n) {
      float mm = smin[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fminf(mm, smin[w][t]);
      // d2 >= 0 (or +inf): its bits order as the floats do
      atomicMin(mb + i, __float_as_uint(mm));
      if (chunk == 0) {
        float gi[3], q[3];
        transform(Tg, pts + (long long)i * 3, gi);
        transform(Tp, pts + (long long)i * 3, q);
        const float dx = gi[0] - q[0];
        const float dy = gi[1] - q[1];
        const float dz = gi[2] - q[2];
        da_row[i] = sqrtf(dx * dx + dy * dy + dz * dz);
      }
    }
  }

  // arrive at the row tile; its last chunk finishes the tile's rows
  unsigned* arrive_tile = arrive + (long long)b * row_tiles + tile;
  if (!arrive_last(arrive_tile, (unsigned)chunks, &s_last)) return;
  double sa = 0.0, ss = 0.0;
  if (threadIdx.x < kRowsPerBlock) {
    const int i = r0 + threadIdx.x;
    if (i < P) {
      const bool valid = i < n;
      const float da = valid ? __ldcg(da_row + i) : 0.f;
      const float ds = valid ? sqrtf(__uint_as_float(__ldcg(mb + i))) : 0.f;
      da_row[i] = da;
      d_adds[(long long)b * P + i] = ds;
      mb[i] = kInfBits;
      sa = (double)da;
      ss = (double)ds;
    }
  }
  // the tile's sums, in a fixed order, to the pose's [row_tiles, 2] partials
  sa = tile_sum(sa, s_part[0]);
  ss = tile_sum(ss, s_part[1]);
  double* pp = part + ((long long)b * row_tiles + tile) * 2;
  if (threadIdx.x == 0) {
    pp[0] = sa;
    pp[1] = ss;
    *arrive_tile = 0u;
  }
  // arrive at the pose; the last tile sums the partials in tile order
  unsigned* arrive_pose = arrive + (long long)gridDim.y * row_tiles + b;
  if (!arrive_last(arrive_pose, (unsigned)row_tiles, &s_last) || threadIdx.x >= 32) return;
  const double* pb = part + (long long)b * row_tiles * 2;
  double ta = 0.0, ts = 0.0;  // lane l: tiles l, l + 32, ... in order
  for (int q = threadIdx.x; q < row_tiles; q += 32) {
    ta += __ldcg(pb + 2 * q);
    ts += __ldcg(pb + 2 * q + 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ta += __shfl_down_sync(0xffffffffu, ta, o);
    ts += __shfl_down_sync(0xffffffffu, ts, o);
  }
  if (threadIdx.x == 0) {
    const float denom = fmaxf((float)n, 1.f);
    add[b] = (float)ta / denom;
    adds[b] = (float)ts / denom;
    *arrive_pose = 0u;
  }
}

}  // namespace

// The current design. points [n_obj, P, 3] f32, counts [n_obj] int32, obj [B]
// int32 (rows of the table; null: points [B, P, 3], pose b on row b), T_pred / T_gt [B, 4, 4] f32; the grid's geometry
// (cols, chunks, row_tiles) from `meter.plan_add_dists`. minbits [B * P] must
// hold +inf bits and arrive [B * row_tiles + B] zeros, and the kernel leaves
// them so; part is a [B * row_tiles * 2] f64 scratch.
extern "C" int suo_add_dists(const void* points, const void* counts, const void* obj,
                             const void* T_pred, const void* T_gt, int B, int P, int cols,
                             int chunks, int row_tiles, void* minbits, void* arrive, void* part,
                             void* d_add, void* d_adds, void* add, void* adds, void* stream) {
  if (B > 0) {
    if (cols < 1 || cols > kMaxCols || chunks < 1 || row_tiles * kRowsPerBlock < P ||
        (long long)(chunks - 1) * cols >= P)
      return (int)cudaErrorInvalidValue;
    dim3 grid(row_tiles * chunks, B);
    add_dists_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const int*)counts, (const int*)obj, (const float*)T_pred,
        (const float*)T_gt, P, cols, chunks, row_tiles, (unsigned*)minbits, (unsigned*)arrive,
        (double*)part, (float*)d_add, (float*)d_adds, (float*)add, (float*)adds);
  }
  return (int)cudaGetLastError();
}

// The earlier design: points [B, P, 3] (gathered), n_pts [B]; part a
// [B, chunks, P] scratch.
extern "C" int suo_add_dists_two_pass(const void* points, const void* n_pts, const void* T_pred,
                                      const void* T_gt, int B, int P, void* part, void* d_add,
                                      void* d_adds, void* add, void* adds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = P > 0 ? (P + kCols - 1) / kCols : 1;
  if (B > 0 && P > 0) {
    dim3 grid((P + kRows - 1) / kRows, chunks, B);
    add_dists_pairs_kernel<<<grid, kRows, 0, s>>>(
        (const float*)points, (const int*)n_pts, (const float*)T_pred, (const float*)T_gt, P,
        (float*)part, (float*)d_add);
  }
  if (B > 0) {
    add_dists_reduce_kernel<<<B, kRed, 0, s>>>((const int*)n_pts, P, chunks,
                                               (const float*)part, (float*)d_add,
                                               (float*)d_adds, (float*)add, (float*)adds);
  }
  return (int)cudaGetLastError();
}
