// K10 — ADD and ADD-S distances of predicted against ground-truth poses over
// padded object point clouds.
//
// Replaces `suo_slam_tpu/eval/meter.py` `_add_dists_kernel` (`:82-106`), which
// XLA runs over the full [B, P, P] squared-distance tensor (67 MB per object
// at P = 4096). Here that tensor never exists:
//   pass 1 (`add_dists_pairs_kernel`): one 128-thread block per (tile of 128
//     ground-truth points, chunk of 512 predicted points, pose). The block
//     transforms its chunk of predicted points into shared memory; each
//     thread transforms its ground-truth point and keeps a running minimum of
//     d2 = dx*dx + dy*dy + dz*dz over the chunk's valid columns, written to a
//     [B, chunks, P] scratch (+inf where the chunk has no valid column). The
//     chunk-0 blocks also write the point's ADD term sqrt(d2(i, i)).
//   pass 2 (`add_dists_reduce_kernel`): one 256-thread block per pose takes
//     the minimum over chunks (exact in any order), its square root, zeroes
//     padded rows, and sums both per-point distances in f64 in a fixed order
//     (thread-strided partial sums, then a shared-memory tree): the result is
//     the same on every run, no atomics. The means divide by max(n, 1) in f32.
// Per-point arithmetic follows the plain version (`eval/meter.py`
// `add_dists_plain`) and JAX: transform (R x + t, products summed left to
// right), squared distance, minimum, square root. Compiled with --fmad=false,
// the per-point distances equal the plain version's; only the means' order of
// summation differs.
//
// Bound on this card: operations. At P = 4096 one pose needs P^2 = 16.8 M
// pairs x ~9 f32 operations (3 sub, 3 mul, 2 add, 1 min) = 151 MFLOP, 2.2 us
// at 67 TFLOP/s; the bytes (49 KB of points) are negligible. The inner loop
// reads shared memory by broadcast (every thread the same column).

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

}  // namespace

extern "C" int suo_add_dists(const void* points, const void* n_pts, const void* T_pred,
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
