// K3 — PnP RANSAC hypotheses: LambdaTwist P3P on 4 sampled points,
// disambiguated by the 4th, then the inlier count of every hypothesis.
//
// Replaces `suo_slam_tpu/solvers/p3p.py` `p3p` / `p4p` (vmapped over the
// hypotheses) and the `count_inliers` stage of `solvers/pnp.py`
// `pnp_ransac`. On the TPU these are [O, n_hyp]-wide `where`-masked vector
// programs; here one thread owns one (object, hypothesis) and runs the
// solver as scalar code in registers, mirroring `solvers/p3p.py` operation
// by operation (same Newton trip counts, same guards, same failure contract:
// identity pose and ok = 0). The solver and the count are the two halves of
// a hypothesis in `pnp_common.cuh` (`solve_pose`, `count_inliers`), which
// K15 (`pnp_ransac.cu`, the whole of `pnp_ransac_batch` in one launch)
// shares; since K15 took the main path, K3 stays as the `pnp_hypotheses`
// entry point beside its plain version.
//
// Bound on this card: latency. At the main path's shapes (O = 8 objects,
// n_hyp = 64, N = 41 points) the whole input is 8 x 41 x 24 B = 8 KB and the
// work ~8 x 64 x (~3k flops of P3P + 41 x ~15 flops of counting) ~ 2 MFLOP,
// i.e. well under a microsecond of either bytes or flops; one launch per
// view, so it costs its launch and one wave of 8 blocks. Design: one block
// per object stages that object's points in shared memory; each thread
// solves its hypothesis and counts against the staged points.

#include "pnp_common.cuh"

namespace {

__global__ void pnp_hypotheses_kernel(const float* __restrict__ xp,
                                      const float* __restrict__ yn,
                                      const uint8_t* __restrict__ mask,
                                      const int* __restrict__ idx, int N,
                                      int H, float thr_sq,
                                      float* __restrict__ T_out,
                                      uint8_t* __restrict__ ok_out,
                                      int* __restrict__ count_out) {
  extern __shared__ float sm[];
  float* sx = sm;             // [N, 3]
  float* sy = sm + 3 * N;     // [N, 2]
  float* smk = sm + 5 * N;    // [N]
  const int o = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = xp[((long long)o * N + n) * 3 + k];
    for (int k = 0; k < 2; ++k) sy[n * 2 + k] = yn[((long long)o * N + n) * 2 + k];
    smk[n] = mask[(long long)o * N + n] ? 1.f : 0.f;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int* ip = idx + ((long long)o * H + h) * 4;
    const int id[4] = {ip[0], ip[1], ip[2], ip[3]};
    float R[9], t[3];
    const bool ok = suo_pnp::solve_pose(sx, sy, N, id, R, t);
    const int cnt = ok ? suo_pnp::count_inliers(sx, sy, smk, N, R, t, thr_sq) : -1;
    float* To = T_out + ((long long)o * H + h) * 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) To[i * 4 + j] = R[i * 3 + j];
      To[i * 4 + 3] = t[i];
    }
    To[12] = 0.f; To[13] = 0.f; To[14] = 0.f; To[15] = 1.f;
    ok_out[(long long)o * H + h] = ok ? 1 : 0;
    count_out[(long long)o * H + h] = cnt;
  }
}

}  // namespace

extern "C" int suo_pnp_hypotheses(const void* xp, const void* yn,
                                  const void* mask, const void* idx, int O,
                                  int N, int H, float thr_sq, void* T_out,
                                  void* ok_out, void* count_out, void* stream) {
  if (O > 0 && H > 0) {
    const int threads = H >= 128 ? 128 : ((H + 31) / 32) * 32;
    const size_t shmem = (size_t)6 * N * sizeof(float);
    pnp_hypotheses_kernel<<<O, threads, shmem, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)yn, (const uint8_t*)mask,
        (const int*)idx, N, H, thr_sq, (float*)T_out, (uint8_t*)ok_out,
        (int*)count_out);
  }
  return (int)cudaGetLastError();
}
