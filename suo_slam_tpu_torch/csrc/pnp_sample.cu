// K22 — PnP hypothesis indices: for every (object, hypothesis) row, the 4
// valid points of largest uniform draw u, in order of decreasing u.
//
// Replaces `suo_slam_tpu/solvers/pnp.py` `_sample_hypothesis_indices`
// (`:171-195`): Gumbel scores -log(-log(u)) masked to -inf on invalid
// points, then 4 iterated argmaxes, each knocking out its pick (the JAX
// package's TPU shape of a top-4, written so to avoid the sort custom-call).
// The Gumbel transform is strictly increasing, so ranking u itself picks the
// same ordered sets; no transcendental is left, and this kernel equals its
// plain version (`pnp.hypothesis_indices_plain`) bit for bit. The draws stay
// outside: the wrapper hands over the `torch.rand` tensor u.
//
// Contract (the JAX docstring's): while at least 4 points of a row's object
// are valid, its 4 indices are distinct valid points; once the valid points
// are exhausted every score is -inf and the argmax ties to index 0, so the
// remaining picks are 0. Ties go to the lowest index, as `torch.argmax` and
// `jnp.argmax` break them.
//
// Shapes: u f32 [O, H, N] (contiguous), mask u8 [O, N], out int64 [O, H, 4];
// N <= 2048 (K15's limit). The main path's calls: the front end's [8, 64, 41] (twice a
// SLAM frame) and the backup camera pose's [1, 128, <= 8 x 41].
//
// Bound on this card: latency. At [8, 64, 41] a launch reads 84 KB of u and
// writes 16 KB: ~0.03 us of bytes, far below one launch. Design: one warp per
// row, its N values in registers (lane l holds points l, l + 32, ...; the
// loads are coalesced across the warp), 4 rounds of a per-lane scan and a
// 5-step xor-shuffle max with lowest-index ties (every lane ends with the
// pick), then the owning lane knocks its value out. No shared memory, no
// atomics, no local memory (register arrays are indexed by unrolled loops).

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int KPL>  // values per lane: N <= 32 * KPL
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pnp_sample_kernel(const float* __restrict__ u, const uint8_t* __restrict__ mask, int O, int H,
                  int N, long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)O * H) return;  // whole warps exit together
  const int o = (int)(row / H);
  const float* ur = u + row * N;
  const uint8_t* mr = mask + (long long)o * N;
  float v[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int j = lane + 32 * k;
    v[k] = (j < N && mr[j]) ? ur[j] : -INFINITY;
  }
  long long pick[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // this lane's best: the first (lowest index) of its largest values;
    // a point past N never beats one inside, whose index is lower
    float best = v[0];
    int bk = 0;
#pragma unroll
    for (int k = 1; k < KPL; ++k) {
      if (v[k] > best) {
        best = v[k];
        bk = k;
      }
    }
    int bi = lane + 32 * bk;
    if (bi >= N) bi = INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    pick[r] = bi;  // < N: index 0 is inside and ties every -inf
#pragma unroll
    for (int k = 0; k < KPL; ++k)
      if (lane + 32 * k == bi) v[k] = -INFINITY;
  }
  if (lane == 0) {
    longlong2* dst = reinterpret_cast<longlong2*>(out + row * 4);
    dst[0] = make_longlong2(pick[0], pick[1]);
    dst[1] = make_longlong2(pick[2], pick[3]);
  }
}

template <int KPL>
void launch(const float* u, const uint8_t* mask, int O, int H, int N, long long* out,
            cudaStream_t stream) {
  const long long rows = (long long)O * H;
  const int blocks = (int)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  pnp_sample_kernel<KPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(u, mask, O, H, N, out);
}

}  // namespace

// u, mask, out: device pointers (out 16-byte aligned). Returns
// cudaGetLastError() after the launch; N outside [1, 2048] returns
// cudaErrorInvalidValue without a launch (the wrapper raises first).
extern "C" int suo_pnp_sample(const void* u, const void* mask, int O, int H, int N, void* out,
                              void* stream) {
  if (N < 1 || N > 2048) return (int)cudaErrorInvalidValue;
  if ((long long)O * H == 0) return (int)cudaGetLastError();
  const float* uf = (const float*)u;
  const uint8_t* m = (const uint8_t*)mask;
  long long* o = (long long*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 64) launch<2>(uf, m, O, H, N, o, s);
  else if (N <= 128) launch<4>(uf, m, O, H, N, o, s);
  else if (N <= 256) launch<8>(uf, m, O, H, N, o, s);
  else if (N <= 512) launch<16>(uf, m, O, H, N, o, s);
  else if (N <= 1024) launch<32>(uf, m, O, H, N, o, s);
  else launch<64>(uf, m, O, H, N, o, s);
  return (int)cudaGetLastError();
}
