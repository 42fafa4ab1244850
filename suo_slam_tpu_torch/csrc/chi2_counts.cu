// K6 — masked chi2 inlier counts: project every model keypoint under a batch
// of object-to-camera poses, test its covariance-weighted chi2 against the
// threshold, and count the passing edges.
//
// Replaces `suo_slam_tpu/slam/kernels.py` `_chi2_counts` (`:116-134`) as
// `camera_pose_ransac` (`:138-174`) calls it — H = O camera hypotheses scored
// against one frame's [O, K] detections, then the argmax and its gates — and
// `reinit_counts` (`:178-212`), the per-object counts over the last N views.
// On the TPU these are [H, O, K] / [N, O, K] fused elementwise programs
// ending in a reduction. Three entry points:
//   - `suo_chi2_counts` (`chi2_counts_kernel`, the first design, kept for
//     comparison: chip_smoke and the card tests): one block per count,
//       per_object = 0: count[s]    = sum over (o, k) of set s       (RANSAC)
//       per_object = 1: count[g, o] = sum over (m, k) of sets g*M+m   (re-init)
//     set s reading its measurements from row s % M;
//   - `suo_camera_ransac` (`camera_ransac_kernel`, the main path's camera
//     RANSAC and the JAX-shaped `camera_pose_ransac`): everything from the
//     group's compact front-end rows to (T_GtoC, best count, ok, best
//     slot) in one block. Every input is staged in shared memory at once
//     (the launch's one wait on memory). The rows are read through the
//     group's map slots (a slot's row found among `slots`, which are
//     distinct apart from the pad O, dropped), so no [O] row is ever
//     scattered. The O hypotheses T_pnp[row j] inv(obj_T[j]) and, round by
//     round (hr hypotheses a round, as many as fit), their compositions
//     with every obj_T[o] live in shared memory; a thread per edge tests it under
//     every candidate hypothesis (mask: the row's keep and the object's
//     candidacy; `inliers & any(inliers)` is `inliers`), counted by integer
//     warp reductions;
//     warp 0 takes the first maximum in slot order, the min-inliers gate
//     and the identity on failure;
//   - `suo_reinit_votes` (`reinit_votes_kernel`, the main path's re-init
//     vote): a block per (pose set, object) over the views cs [n] of the
//     engine's device mirrors, 32 views at a time: their poses cam_T[m] T[o]
//     composed and their rows staged in shared memory, views whose
//     cam_valid is false skipped: no gather, product or mask is
//     materialised in global memory.
//
// Exactness: the counts must be equal to the plain versions', since one edge
// that flips at the threshold can change the chosen camera. Everything runs
// in the plain versions' operation order (compiled with --fmad=false, so
// each product and sum rounds as PyTorch's separate elementwise kernels
// round them; the twins `chi2_counts_plain`, `camera_ransac_plain` and
// `reinit_votes_plain` in `slam/kernels.py` write the same sums):
//   inv(T) = [R^T, t'; 0 0 0 1], t'_i = -((R_0i t_0 + R_1i t_1) + R_2i t_2),
//   (A B)_ij = ((A_i0 B_0j + A_i1 B_1j) + A_i2 B_2j) + A_i3 B_3j,
// and per edge
//   p = R x + t (three products and three sums per row, left to right),
//   iz = 1 / (|z| < 1e-12 ? 1e-12 : z),
//   r = uv - (f p iz + c),  chi2 = ru (i00 ru + i01 rv) + rv (i10 ru + i11 rv),
//   good = chi2 <= thresh && z > 0 && mask   (a NaN chi2 never counts).
//
// Bound on this card: latency. At the SLAM path's shapes (O = 8, K = 41:
// 8 x 8 x 41 = 2,624 camera-RANSAC edges, or 2 x 16 views x 8 x 41 re-init
// edges) one launch reads < 0.2 MB and does ~10k edges x ~45 f32 operations
// = 0.5 MFLOP: well under a microsecond of either; what costs is the launch
// and its dependent steps, so each mode is one launch with no atomics and no
// host value.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;     // a block per count (`slam/kernels.py` K6_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kCamThreads = 512;  // the camera-RANSAC block (K6_CAM_THREADS)
constexpr int kCamWarps = kCamThreads / 32;
constexpr int kCamHyps = 16;      // camera hypotheses a round at most (K6_CAM_HYPS)
constexpr int kReinitThreads = 256;  // a re-init block (K6_REINIT_THREADS)
constexpr int kReinitChunk = 32;  // re-init views staged at a time (K6_REINIT_CHUNK)
constexpr int kReinitBatch = 8;   // a thread's valid bytes loaded together

// Thread 0's SM clock cycles per phase of a fused mode, added into out[phase]
// (`slam/kernels.py` K6_CAM_PHASES, K6_REINIT_PHASES); off with a null out.
struct PhaseClock {
  long long* out;
  long long last;
  __device__ explicit PhaseClock(long long* p) : out(threadIdx.x == 0 ? p : nullptr), last(0) {
    if (out) last = clock64();
  }
  __device__ void mark(int phase) {
    if (out) {
      const long long now = clock64();
      out[phase] += now - last;
      last = now;
    }
  }
};

__device__ __forceinline__ int warp_sum(int c) {
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  return c;
}

// One edge under the object-to-camera pose T (rows 0-2 of a row-major 4x4):
// model point x [3], measurement uv [2], information W [2x2], intrinsics
// ck (fx, fy, cx, cy). 1 if it passes the chi2 test in front of the camera.
__device__ __forceinline__ int edge_chi2(const float* T, const float* x, const float* uv,
                                         const float* W, const float* ck, float thresh) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = x[0] * T[i * 4 + 0] + x[1] * T[i * 4 + 1] + x[2] * T[i * 4 + 2] + T[i * 4 + 3];
  const float z = p[2];
  const float iz = 1.f / (fabsf(z) < 1e-12f ? 1e-12f : z);
  const float u = ck[0] * p[0] * iz + ck[2];
  const float v = ck[1] * p[1] * iz + ck[3];
  const float ru = uv[0] - u;
  const float rv = uv[1] - v;
  const float chi2 = ru * (W[0] * ru + W[1] * rv) + rv * (W[2] * ru + W[3] * rv);
  return (chi2 <= thresh && z > 0.f) ? 1 : 0;
}

// the first `rows` rows of A B, row-major 4x4s, in the written order (`compose_plain`)
__device__ __forceinline__ void mul44(const float* A, const float* B, float* C, int rows) {
  for (int i = 0; i < rows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[i * 4 + j] = A[i * 4 + 0] * B[0 * 4 + j] + A[i * 4 + 1] * B[1 * 4 + j] +
                     A[i * 4 + 2] * B[2 * 4 + j] + A[i * 4 + 3] * B[3 * 4 + j];
}

__device__ __forceinline__ int edge_good(const float* __restrict__ T,
                                         const float* __restrict__ model_kp,
                                         const float* __restrict__ uv,
                                         const float* __restrict__ info,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ cam_k4,
                                         int s, int o, int k, int O, int K, int M,
                                         float thresh) {
  const long long e = ((long long)(s % M) * O + o) * K + k;
  if (!mask[e]) return 0;
  return edge_chi2(T + ((long long)s * O + o) * 16, model_kp + ((long long)o * K + k) * 3,
                   uv + e * 2, info + e * 4, cam_k4 + ((long long)(s % M) * O + o) * 4, thresh);
}

__global__ void __launch_bounds__(kThreads)
chi2_counts_kernel(const float* __restrict__ T, const float* __restrict__ model_kp,
                   const float* __restrict__ uv, const float* __restrict__ info,
                   const uint8_t* __restrict__ mask, const float* __restrict__ cam_k4,
                   int S, int O, int K, int M, int per_object, float thresh,
                   int* __restrict__ counts) {
  __shared__ int red[kWarps];
  int c = 0;
  if (!per_object) {
    const int s = blockIdx.x;
    for (int e = threadIdx.x; e < O * K; e += blockDim.x)
      c += edge_good(T, model_kp, uv, info, mask, cam_k4, s, e / K, e % K, O, K, M, thresh);
  } else {
    const int g = blockIdx.x / O, o = blockIdx.x % O;
    for (int e = threadIdx.x; e < M * K; e += blockDim.x)
      c += edge_good(T, model_kp, uv, info, mask, cam_k4, g * M + e / K, o, e % K, O, K,
                     M, thresh);
  }
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    counts[blockIdx.x] = total;
  }
}

// Asynchronous copies global -> shared (cp.async; `bytes` 4, 8 or 16, both
// addresses aligned to it): a thread's copies are all in flight until
// `cp_async_wait`, so a stage costs one wait on memory, not one per load.
template <int bytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The group row of slot j among the slots (distinct apart from the pad),
// -1 where it has none.
__device__ __forceinline__ int slot_row(const int* s_slot, int ob, int j) {
  int r = -1;
  for (int i = 0; i < ob; ++i)
    if (s_slot[i] == j) r = i;
  return r;
}

// Camera RANSAC of one group in one block (see the head of this file).
// Dynamic shared memory (`camera_ransac_smem`): floats s_objT [O][16],
// s_kp [O][K][3], s_Tp [ob][16], s_uv [ob][K][2], s_info [ob][K][4],
// s_k4 [ob][4], s_hyp [O][16], s_toc [hr][O][12] (hr <= min(O,
// kCamHyps): `camera_ransac_hyps`, the most that fit a block); ints s_row,
// s_cand, s_cnt, s_act [O], s_slot, s_ok [ob],
// s_part [kCamWarps][kCamHyps]; bytes s_keep [ob][K].
//   stage: every input into shared memory, the floats by cp.async, all in
//     flight together;
//   hypotheses: the O hypotheses T_row[j] inv(obj_T[j]), an entry a thread
//     (in the written order below), slot j's row found among
//     the slots and its candidacy;
//   compose + count, by rounds of hr hypotheses: the round's poses
//     T_hyp[j] obj_T[o] (rows 0-2), an entry a thread, then a thread per
//     edge (o, k) holds the
//     edge's data in registers and tests it under each of the round's
//     hypotheses (a bit each, four tests interleaved); a warp counts each
//     hypothesis's bits by a ballot (lane h keeps hypothesis h's), and a
//     hypothesis's count is a warp reduction of the warps' (integer sums:
//     exact in any order);
//   select: warp 0 takes the first maximum in slot order by shuffles, the
//     gate, and writes the pose.
__global__ void __launch_bounds__(kCamThreads)
camera_ransac_kernel(const float* __restrict__ T_pnp, const uint8_t* __restrict__ pnp_ok,
                     const float* __restrict__ uv, const float* __restrict__ info,
                     const uint8_t* __restrict__ keep, const float* __restrict__ cam_k4,
                     const long long* __restrict__ slots, int ob,
                     const float* __restrict__ obj_T, const uint8_t* __restrict__ obj_active,
                     const float* __restrict__ model_kp, int O, int K, float thresh,
                     int min_inl, int hr, float* __restrict__ T_out,
                     int* __restrict__ count_out,
                     uint8_t* __restrict__ ok_out, long long* __restrict__ best_out,
                     long long* __restrict__ cycles) {
  extern __shared__ __align__(16) float sm[];
  float* s_objT = sm;
  float* s_kp = s_objT + O * 16;
  float* s_Tp = s_kp + O * K * 3;
  float* s_uv = s_Tp + ob * 16;
  float* s_info = s_uv + ob * K * 2;
  float* s_k4 = s_info + ob * K * 4;
  float* s_hyp = s_k4 + ob * 4;          // hypothesis j: T_row[j] inv(obj_T[j])
  float* s_toc = s_hyp + O * 16;         // the round's (j, o): rows 0-2 of s_hyp[j] obj_T[o]
  int* s_row = reinterpret_cast<int*>(s_toc + hr * O * 12);  // the group row of slot o, -1
  int* s_cand = s_row + O;               // slot o's PnP ok and its object active
  int* s_cnt = s_cand + O;               // hypothesis j's count, -1 if no candidate
  int* s_act = s_cnt + O;
  int* s_slot = s_act + O;
  int* s_ok = s_slot + ob;
  int* s_part = s_ok + ob;               // [warp][hypothesis of the round] partial counts
  uint8_t* s_keep = reinterpret_cast<uint8_t*>(s_part + kCamWarps * kCamHyps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PhaseClock clk(cycles);  // stage, hypotheses, compose, count, select

  for (int i = tid; i < O * 16; i += kCamThreads) cp_async<4>(s_objT + i, obj_T + i);
  for (int i = tid; i < O * K * 3; i += kCamThreads) cp_async<4>(s_kp + i, model_kp + i);
  for (int i = tid; i < ob * 16; i += kCamThreads) cp_async<4>(s_Tp + i, T_pnp + i);
  for (int i = tid; i < ob * K * 2; i += kCamThreads) cp_async<4>(s_uv + i, uv + i);
  for (int i = tid; i < ob * K * 4; i += kCamThreads) cp_async<4>(s_info + i, info + i);
  for (int i = tid; i < ob * 4; i += kCamThreads) cp_async<4>(s_k4 + i, cam_k4 + i);
  for (int i = tid; i < max(ob * K, max(ob, O)); i += kCamThreads) {  // the rest, loads together
    if (i < ob * K) s_keep[i] = keep[i];
    if (i < ob) {
      s_slot[i] = (int)min((long long)O, max(-1ll, slots[i]));  // the pad (O) matches no slot
      s_ok[i] = pnp_ok[i];
    }
    if (i < O) s_act[i] = obj_active[i];
  }
  cp_async_wait();
  __syncthreads();
  clk.mark(0);

  // hypotheses an entry a thread: entry (i, c) of T_row[j] inv(obj_T[j]);
  // thread (j, 0) keeps slot j's row and candidacy
  for (int q = tid; q < O * 16; q += kCamThreads) {
    const int j = q >> 4, i = (q >> 2) & 3, c = q & 3, r = slot_row(s_slot, ob, j);
    const float* T = s_objT + j * 16;
    float a[4], b[4];  // row i of T_row[j], column c of inv(obj_T[j])
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = r >= 0 ? s_Tp[r * 16 + i * 4 + k] : (i == k ? 1.f : 0.f);
      b[k] = k == 3 ? (c == 3 ? 1.f : 0.f)
                    : c < 3 ? T[c * 4 + k] : -(T[0 * 4 + k] * T[3] + T[1 * 4 + k] * T[7] +
                                               T[2 * 4 + k] * T[11]);
    }
    s_hyp[q] = a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
    if ((q & 15) == 0) {
      s_row[j] = r;
      s_cand[j] = (r >= 0 && s_ok[r] && s_act[j]) ? 1 : 0;
    }
  }
  __syncthreads();
  clk.mark(1);

  const int E = O * K;
  for (int j0 = 0; j0 < O; j0 += hr) {  // the same trips in every thread
    // the round's poses an entry a thread: entry (i, c) of T_hyp[j] obj_T[o]
    for (int q = tid; q < hr * O * 12; q += kCamThreads) {
      const int p = q / 12, i = (q % 12) >> 2, c = q & 3, j = j0 + p / O;
      if (j < O) {
        const float* A = s_hyp + j * 16 + i * 4;
        const float* B = s_objT + (p % O) * 16;
        s_toc[q] = A[0] * B[c] + A[1] * B[4 + c] + A[2] * B[8 + c] + A[3] * B[12 + c];
      }
    }
    __syncthreads();
    clk.mark(2);
    int mine = 0;  // lane h < hr: this warp's count of hypothesis j0 + h
    for (int e0 = 0; e0 < E; e0 += kCamThreads) {  // the same trips in every lane (the ballots)
      const int e = e0 + tid;
      const int o = e < E ? e / K : 0, k = e - o * K, r = e < E ? s_row[o] : -1;
      const bool live = r >= 0 && s_cand[o] && s_keep[r * K + k];
      unsigned bits = 0u;  // bit h: the edge passes under hypothesis j0 + h
      if (live) {  // the edge's data once, for every hypothesis of the round
        float x[3], m[2], W[4], ck[4];
#pragma unroll
        for (int i = 0; i < 3; ++i) x[i] = s_kp[e * 3 + i];
#pragma unroll
        for (int i = 0; i < 2; ++i) m[i] = s_uv[(r * K + k) * 2 + i];
#pragma unroll
        for (int i = 0; i < 4; ++i) { W[i] = s_info[(r * K + k) * 4 + i]; ck[i] = s_k4[r * 4 + i]; }
#pragma unroll 4
        for (int h = 0; h < hr; ++h) {
          const int j = j0 + h;
          if (j < O && s_cand[j])
            bits |= (unsigned)edge_chi2(s_toc + (h * O + o) * 12, x, m, W, ck, thresh) << h;
        }
      }
#pragma unroll 1
      for (int h = 0; h < hr; ++h) {
        const int n = __popc(__ballot_sync(0xffffffffu, (bits >> h) & 1u));
        mine += lane == h ? n : 0;
      }
    }
    if (lane < hr) s_part[warp * kCamHyps + lane] = mine;
    __syncthreads();
    if (warp < hr && j0 + warp < O) {  // warp h: hypothesis j0 + h, its warps' rows summed
      const int v = lane < kCamWarps ? s_part[lane * kCamHyps + warp] : 0;
      const int total = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) s_cnt[j0 + warp] = s_cand[j0 + warp] ? total : -1;
    }
    __syncthreads();
    clk.mark(3);
  }
  if (warp == 0) {  // the first maximum in slot order, then the gate
    int bc = INT_MIN, best = INT_MAX;
    for (int j = lane; j < O; j += 32)
      if (s_cnt[j] > bc) { bc = s_cnt[j]; best = j; }
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best, off);
      if (oc > bc || (oc == bc && oj < best)) { bc = oc; best = oj; }
    }
    const bool ok = bc >= min_inl;
    if (lane < 16) T_out[lane] = ok ? s_hyp[best * 16 + lane] : (lane % 5 == 0 ? 1.f : 0.f);
    if (lane == 0) {
      *count_out = bc;
      *ok_out = ok ? 1 : 0;
      *best_out = best;
    }
    clk.mark(4);
  }
}

// The re-init vote: block b counts set b / O (0: this frame's PnP poses,
// 1: the map's) of object b % O over the views cs [n] of the mirrors
// (V rows), kReinitChunk views at a time:
//   poses: the chunk's rows (cs, cam_valid) and poses cam_T[m] T[o];
//   rows: the chunk's measurements, information and intrinsics copied into
//     shared memory by cp.async and its valid bytes loaded kReinitBatch at a
//     time, all in flight together;
//   count: a thread per edge, from shared memory;
//   reduce: the block's integer sum.
// Dynamic shared memory (`reinit_smem`), 16-byte units first: floats
// s_info [kReinitChunk][K][4], s_k4 [kReinitChunk][4], s_uv
// [kReinitChunk][K][2], s_T [kReinitChunk][12], s_kp [K][3]; ints s_v
// [kReinitChunk]; bytes s_ok [kReinitChunk][K].
__global__ void __launch_bounds__(kReinitThreads)
reinit_votes_kernel(const float* __restrict__ T_pnp, const float* __restrict__ T_est,
                    const float* __restrict__ cam_T, const uint8_t* __restrict__ cam_valid,
                    const float* __restrict__ model_kp, const float* __restrict__ uv_m,
                    const float* __restrict__ info_m, const uint8_t* __restrict__ valid_m,
                    const float* __restrict__ cam_k4_m, const long long* __restrict__ cs,
                    int V, int O, int K, int n, float thresh, int* __restrict__ counts,
                    long long* __restrict__ cycles) {
  constexpr int C = kReinitChunk, B = kReinitBatch, NT = kReinitThreads;
  extern __shared__ __align__(16) float sm[];
  float* s_info = sm;
  float* s_k4 = s_info + C * K * 4;
  float* s_uv = s_k4 + C * 4;
  float* s_T = s_uv + C * K * 2;   // view m: rows 0-2 of cam_T[m] T[o]
  float* s_kp = s_T + C * 12;
  int* s_v = reinterpret_cast<int*>(s_kp + K * 3);  // the view's row, -1: none
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_v + C);
  __shared__ int red[NT / 32];
  const int set = blockIdx.x / O, o = blockIdx.x % O;
  // poses, rows, count, reduce: a row of cycles per block
  PhaseClock clk(cycles ? cycles + (long long)blockIdx.x * 4 : nullptr);
  const float* T = (set == 0 ? T_pnp : T_est) + (long long)o * 16;
  for (int i = threadIdx.x; i < K * 3; i += NT) cp_async<4>(s_kp + i, model_kp + (long long)o * K * 3 + i);
  int c = 0;
  for (int m0 = 0; m0 < n; m0 += C) {
    const int nc = min(C, n - m0);
    for (int m = threadIdx.x; m < nc; m += NT) {
      const long long v = cs[m0 + m];
      s_v[m] = (cam_valid[m0 + m] && v >= 0 && v < V) ? (int)v : -1;
      mul44(cam_T + (long long)(m0 + m) * 16, T, s_T + m * 12, 3);
    }
    __syncthreads();
    clk.mark(0);
    for (int e0 = threadIdx.x; e0 < nc * K; e0 += B * NT) {
      uint8_t ok[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int e = e0 + b * NT;
        ok[b] = 0;
        if (e < nc * K) {
          const int m = e / K, v = s_v[m];
          if (v >= 0) {
            const long long re = ((long long)v * O + o) * K + (e - m * K);
            ok[b] = valid_m[re];
            cp_async<8>(s_uv + e * 2, uv_m + re * 2);
            cp_async<16>(s_info + e * 4, info_m + re * 4);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
        if (e0 + b * NT < nc * K) s_ok[e0 + b * NT] = ok[b];
    }
    for (int m = threadIdx.x; m < nc; m += NT)
      if (s_v[m] >= 0) cp_async<16>(s_k4 + m * 4, cam_k4_m + ((long long)s_v[m] * O + o) * 4);
    cp_async_wait();
    __syncthreads();
    clk.mark(1);
    for (int e = threadIdx.x; e < nc * K; e += NT) {
      if (!s_ok[e]) continue;
      const int m = e / K, k = e - m * K;
      c += edge_chi2(s_T + m * 12, s_kp + k * 3, s_uv + e * 2, s_info + e * 4, s_k4 + m * 4,
                     thresh);
    }
    __syncthreads();  // the chunk's stage is read before the next overwrites it
    clk.mark(2);
  }
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < NT / 32; ++w) total += red[w];
    counts[blockIdx.x] = total;
    clk.mark(3);
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int suo_chi2_counts(const void* T, const void* model_kp, const void* uv,
                               const void* info, const void* mask, const void* cam_k4,
                               int S, int O, int K, int M, int per_object, float thresh,
                               void* counts, void* stream) {
  const int blocks = per_object ? (S / M) * O : S;
  if (blocks > 0) {
    chi2_counts_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)T, (const float*)model_kp, (const float*)uv, (const float*)info,
        (const uint8_t*)mask, (const float*)cam_k4, S, O, K, M, per_object, thresh,
        (int*)counts);
  }
  return (int)cudaGetLastError();
}

// hr: hypotheses a round, `slam/kernels.py` `camera_ransac_hyps(O, ob, K)`
// (1 <= hr <= min(O, kCamHyps)); smem: `camera_ransac_smem(O, ob, K, hr)`;
// O, ob, K >= 1 (the wrapper raises first); cycles: null, or int64 zeros
// [len(K6_CAM_PHASES)] that take thread 0's SM clock cycles per phase
extern "C" int suo_camera_ransac(const void* T_pnp, const void* pnp_ok, const void* uv,
                                 const void* info, const void* keep, const void* cam_k4,
                                 const void* slots, int ob, const void* obj_T,
                                 const void* obj_active, const void* model_kp, int O, int K,
                                 float thresh, int min_inl, int hr, int smem, void* T_out,
                                 void* count_out, void* ok_out, void* best_out, void* cycles,
                                 void* stream) {
  const cudaError_t e = allow_smem(camera_ransac_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  camera_ransac_kernel<<<1, kCamThreads, smem, (cudaStream_t)stream>>>(
      (const float*)T_pnp, (const uint8_t*)pnp_ok, (const float*)uv, (const float*)info,
      (const uint8_t*)keep, (const float*)cam_k4, (const long long*)slots, ob,
      (const float*)obj_T, (const uint8_t*)obj_active, (const float*)model_kp, O, K, thresh,
      min_inl, hr, (float*)T_out, (int*)count_out, (uint8_t*)ok_out, (long long*)best_out,
      (long long*)cycles);
  return (int)cudaGetLastError();
}

// smem: `slam/kernels.py` `reinit_smem(K)`; counts [2, O] int32; cycles:
// null, or int64 zeros [2 O, len(K6_REINIT_PHASES)], a row per block
extern "C" int suo_reinit_votes(const void* T_pnp, const void* T_est, const void* cam_T,
                                const void* cam_valid, const void* model_kp, const void* uv_m,
                                const void* info_m, const void* valid_m, const void* cam_k4_m,
                                const void* cs, int V, int O, int K, int n, float thresh,
                                int smem, void* counts, void* cycles, void* stream) {
  const cudaError_t e = allow_smem(reinit_votes_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  reinit_votes_kernel<<<2 * O, kReinitThreads, smem, (cudaStream_t)stream>>>(
      (const float*)T_pnp, (const float*)T_est, (const float*)cam_T,
      (const uint8_t*)cam_valid, (const float*)model_kp, (const float*)uv_m,
      (const float*)info_m, (const uint8_t*)valid_m, (const float*)cam_k4_m,
      (const long long*)cs, V, O, K, n, thresh, (int*)counts, (long long*)cycles);
  return (int)cudaGetLastError();
}
