// K14 — bundle adjustment's whole robust Levenberg-Marquardt schedule in one
// launch: the initial chi2 classification, the rounds (Huber on rounds
// 0..max(1, n // 2), each round skipped below 4 inlier edges), up to n_iters
// LM iterations per round with the early exit of the JAX `while_loop`
// (relative gain < 1e-6, or lambda >= 1e6), the per-round quaternion
// re-orthonormalization and chi2 reclassification, and the final
// classification with its inlier count and chi2 sum.
//
// Replaces `suo_slam_tpu/solvers/ba.py` `optimize` (`:513-597`) with
// `_make_lm_iteration` (`:371-453`) and `_lm_while` (`:456-478`), which the
// TPU runs as one `lax.while_loop` program per round, and the port's eager
// schedule of K4 (`ba_edges.cu`) + K7 (`ba_schur.cu`) launches and a few
// dozen small PyTorch operations per iteration (`solvers/ba.py`
// `_optimize_eager`), which always ran every iteration.
//
// Bound on this card: latency. At the SLAM path's shapes an iteration is
// ~10k edges (V = 32 views x O = 8 objects x K = 41 keypoints; tracking: V =
// 1) and a 48 x 48 reduced system: ~5 MFLOP and < 1 MB, microseconds of the
// card's rates, against ~200 launches and host round trips per iteration in
// the eager form. Two designs, each one launch per call with the whole
// schedule on chip, every reduction in a fixed order (a result repeats run
// to run), no allocation and no host read:
//
// The cluster design (`ba_lm_cluster_kernel`, `ba_lm_track_kernel`; the
// main path, `_ba_lm_cuda(design="cluster")`):
//   - the global BA on a thread-block cluster of up to 16 CTAs of 256: CTA
//     r owns cameras [r cpr, (r + 1) cpr) with their working set (pair sums,
//     6x6 factors and scales, Hco_s, X) in its shared memory (`cl_layout`);
//     each edge projected once an iteration for both row sets, inactive
//     pairs skipped; object sums, the reduced system's rows (reduce-scatter,
//     then all-gather) and the LM costs pushed into the readers' shared
//     memory (distributed shared memory; the scratch for a buffer that does
//     not fit) and summed in rank order behind four cluster barriers an
//     iteration; every CTA factors the same 6O x 6O system in 6 x 6 tiles
//     (`chol_tiles`) and takes the same decisions;
//   - the tracking BA on one CTA of 512 with its state in shared memory: a
//     camera's edges over a group of warps, each warp of the group solving
//     the camera's 6x6 system (`warp_camera_step`: a warp, not a thread)
//     and its trial pose, two barriers an iteration;
//   - after a refused step the state is unchanged, so the next iteration
//     reuses its sums (its edge pass would repeat them bit for bit), and an
//     accepted step's trial cost is the next iteration's cost;
//   - poses kept in f64 beside their f32 rounding (Jacobians and the chi2
//     classification read the f32 one); residuals, gradients and LM costs
//     from the f64 poses (`edge_residual64`): rounding a pose to f32 moves
//     the cost near the optimum by as much as the last steps gain, and the
//     f32 residuals' rounding outweighs the true gradient there, so an f32
//     state stops ~2e-5 from the f64 BA along poorly constrained directions.
//     H, the Schur complement and every factor stay f32.
// The block design (`ba_lm_kernel`; `design="block"`, kept for comparison):
//   - one persistent 512-thread block per call, its phases separated by
//     block barriers, its buffers in an L2-resident scratch;
//   - edge pass: a half-warp per (v, o) pair (41 edges in 3 steps of 16
//     lanes), a lane per keypoint edge (projection, chi2, Huber IRLS
//     weight, 2x12 Jacobian from `ba_common.cuh`), each lane summing its
//     edges' terms of the pair's H and g blocks in registers, then a
//     butterfly reduce-scatter across the half-warp (15 shuffles per 16
//     sums) leaves one sum of each 16 on each lane; the camera rows (Hcc,
//     gc, Hco: 63 sums) and the object rows (Hoo, go: 27) in two passes,
//     so the sums stay in registers;
//   - per camera and per object: damping, freeze masks, Jacobi scaling and
//     the 6x6 factor (K7's `cams` stage, one thread each); then a warp per
//     camera, a lane per column of [Hco_s | gc_s], for the two triangular
//     solves;
//   - the objects' reduced 6O x 6O system S: one thread per entry, summed
//     over the cameras in order (a warp per row, a lane per entry); a
//     left-looking Cholesky of sym(S) (a thread per row: one warp up to 64
//     rows, the block above) and one warp's triangular solves, in shared
//     memory when the system fits (6O <= 234),
//     else in the L2-resident scratch; a pivot that is not > 0 gives the
//     NaN factor of `_cholesky`, so the step is refused;
//   - se3_exp and the left composition, one thread per pose; the trial
//     chi2 in the edge pass's layout; accept / reject and lambda by every
//     thread alike from the block's sums. The two LM costs (and the final
//     chi2) sum their f32 edge terms in f64: the accept test and the 1e-6
//     relative-gain exit compare costs that differ by less than an f32
//     sum's rounding near convergence, where f32 sums accept steps that do
//     not lower the cost and walk the state ~1e-5 away from the f64 BA.
// With `cycles`, thread 0 (of rank 0) adds each phase's SM clock cycles
// there (`Phase`, `NPhase`). Tracking (every object frozen) keeps K7's
// camera-only form: each camera solves its own 6x6 system and no object
// moves. The wrapper (`solvers/ba.py` `_ba_lm_cuda`) plans the launch and
// the scratch (`plan_lm`, whose formulas `lm_layout` and `cl_layout` below
// mirror) and allocates every buffer: the kernels allocate nothing.
// Compiled with --fmad=false: f32 CUDA-core arithmetic, no tensor cores,
// as the global system at lambda = 1e-5 is ill-conditioned even in f32.

#include <cooperative_groups.h>

#include "ba_common.cuh"

namespace {

using namespace suo_ba;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 32;
constexpr int kPair = 96;        // H / g sums per (v, o) pair in the scratch
constexpr int kObjPart = 64;     // where a pair's object rows start
constexpr int kCamSums = 27;     // Hcc (21 upper) + gc (6) of one camera
constexpr int kObjSums = 27;     // Hoo (21 upper) + go (6) of one object
constexpr int kWarpFactorRows = 64;  // one warp factors the reduced system up to this order

struct Args {
  const float* cam_T;
  const float* obj_T;
  const float* uv;
  const float* info;
  const float* model_kp;
  const float* cam_k;
  const uint8_t* valid;
  const uint8_t* cam_active;
  const uint8_t* obj_active;
  const uint8_t* cam_frozen;  // null: no camera frozen
  const uint8_t* obj_frozen;  // null: no object frozen
  int V, O, K, n_rounds;
  int rounds[kMaxRounds];
  int fix_first_cam, init_with_outliers, s_in_smem;
  int G;               // the cluster design: CTAs of the global path's cluster
  float huber_d, huber_2d, huber_d2, chi2_thresh;
  float* cam_out;      // [V, 16] the state, written from the first phase on
  float* obj_out;      // [O, 16]
  uint8_t* inl;        // [V, O, K] the working classification, then the final one
  long long* ints;     // [1 + n_rounds] num_inliers, iterations per round
  float* total_chi2;   // [1]
  float* scratch;
  long long* cycles;   // [kPhases] SM clock cycles per phase, or null
};

// The phases whose SM clock cycles `cycles` sums (thread 0's view).
enum Phase { kEdges, kBlocks, kColumns, kReduce, kFactor, kBack, kTrial, kRound, kPhases };

struct PhaseClock {
  long long* out;
  long long last;
  __device__ explicit PhaseClock(long long* p) : out(p), last(0) {
    if (out && threadIdx.x == 0) {
      for (int i = 0; i < kPhases; ++i) out[i] = 0;
      last = clock64();
    }
  }
  __device__ void mark(Phase ph) {
    if (out && threadIdx.x == 0) {
      const long long now = clock64();
      out[ph] += now - last;
      last = now;
    }
  }
};

// Scratch layout in floats (the wrapper's `plan_lm` mirrors it).
struct Layout {
  long long camN, objN, hg, csum, osum, Lc, ic, gcs, io, hoos, gos, hcos, X, sys, dcam, dobj, mc,
      mo, total;
};

// The objects' reduced system, in shared memory when it fits (the
// wrapper's `smem_bytes`), else in the scratch: S [n, n + 1] (an odd row
// stride, so a warp's rows fall in distinct banks), its right-hand side b,
// the forward solve z, the step x and the factor's diagonal, n each.
__host__ __device__ inline long long lm_sys_floats(long long n) { return n * (n + 1) + 4 * n; }

__host__ __device__ inline Layout lm_layout(long long V, long long O) {
  const long long n = 6 * O, C = n + 1, P = V * O;
  Layout L;
  long long off = 0;
  auto take = [&off](long long size) { const long long at = off; off += size; return at; };
  L.camN = take(V * 16);
  L.objN = take(O * 16);
  L.hg = take(P * kPair);
  L.csum = take(V * kCamSums);
  L.osum = take(O * kObjSums);
  L.Lc = take(V * 36);
  L.ic = take(V * 6);
  L.gcs = take(V * 6);
  L.io = take(O * 6);
  L.hoos = take(O * 36);
  L.gos = take(O * 6);
  L.hcos = take(P * 36);
  L.X = take(V * 6 * C);
  L.sys = take(lm_sys_floats(n));
  L.dcam = take(V * 6);
  L.dobj = take(O * 6);
  L.mc = take(V);
  L.mo = take(O);
  L.total = off;
  return L;
}

// index of (i, j), i <= j, in the row-major upper triangle of a 6x6 block
__host__ __device__ constexpr int u6(int i, int j) { return i * (11 - i) / 2 + j; }

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// The block's sum of every thread's x, the same value in every thread:
// each warp's lane 0 total, then the warps' totals in order.
__device__ double block_sum_double(double x, double* red) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) x += __shfl_down_sync(0xffffffffu, x, s);
  if (lane_id() == 0) red[warp_id()] = x;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ long long block_sum_int(int x, int* red) {
  x = warp_sum_int(x);
  if (lane_id() == 0) red[warp_id()] = x;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ int block_min_int(int x, int* red) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, s));
  if (lane_id() == 0) red[warp_id()] = x;
  __syncthreads();
  int t = red[0];
  for (int w = 1; w < kWarps; ++w) t = min(t, red[w]);
  __syncthreads();
  return t;
}

// Butterfly reduce-scatter of 2S per-lane values over groups of 2S lanes
// (lane bits S, S/2, ..., 1): afterwards v[0] of lane l holds its group's
// sum of value l mod 2S. S halves the live values each step.
template <int S>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  const bool up = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) reduce_scatter<S / 2>(v, lane);
}

// One edge's terms of its pair's H / g sums. kPart 0: the camera rows (Hcc
// upper at u6, gc at 21, and with kHco Hco[i][a] at 27 + 6 i + a); kPart 1:
// the object rows (Hoo upper, go at 21).
template <int kPart, bool kHco, int NA>
__device__ __forceinline__ void accumulate(float (&acc)[NA], const float* r0, const float* r1,
                                           float ru, float rv, float v00, float v01, float v11) {
  constexpr int c = kPart == 0 ? 0 : 6;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = r0[c + i] * v00 + r1[c + i] * v01;
    const float w1 = r0[c + i] * v01 + r1[c + i] * v11;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[u6(i, j)] += w0 * r0[c + j] + w1 * r1[c + j];
    acc[21 + i] += w0 * ru + w1 * rv;
    if constexpr (kPart == 0 && kHco) {
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[27 + i * 6 + a] += w0 * r0[6 + a] + w1 * r1[6 + a];
    }
  }
}

// The g2o Huber-composed chi2 of one edge (the LM cost's term).
__device__ __forceinline__ float robust(float s, bool use_huber, const Args& a) {
  if (!use_huber || s <= a.huber_d2) return s;
  return a.huber_2d * sqrtf(clampmin(s, 1e-30f)) - a.huber_d2;
}

// The edge pass over every (v, o) pair: the pair's H / g sums into
// hg[p * kPair + part offset] and, in the camera pass, the lane's share of
// the robust cost of the inlier edges.
template <int kPart, bool kHco>
__device__ void edge_pass(const Args& a, const float* camT, const float* objT, bool use_huber,
                          float* hg, double& cost) {
  constexpr int NA = (kPart == 0 && kHco) ? 64 : 32;
  const int lane = lane_id(), hl = lane & 15;
  const int O = a.O, K = a.K, P = a.V * a.O;
  for (int p0 = 2 * warp_id(); p0 < P; p0 += 2 * kWarps) {
    const int p = p0 + (lane >> 4);  // a half-warp per pair
    const bool live = p < P;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    if (live) {
      const int v = p / O, o = p - v * O;
      const float* Tc = camT + (long long)v * 16;
      const float* To = objT + (long long)o * 16;
      const float* ck = a.cam_k + (long long)p * 4;
      for (int k = hl; k < K; k += 16) {
        const long long e = (long long)p * K + k;
        const float* w = a.info + e * 4;
        const Edge ed = project_edge(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck,
                                     a.uv + e * 2, w);
        const bool in = a.inl[e] != 0;
        if (kPart == 0 && in) cost += robust(ed.chi2, use_huber, a);
        const float wt = (in ? 1.f : 0.f) *
                         (use_huber ? huber_weight(ed.chi2, a.huber_d, a.huber_d2) : 1.f);
        float r0[12], r1[12];
        edge_jacobian(Tc, ck, ed, r0, r1);
        accumulate<kPart, kHco>(acc, r0, r1, ed.ru, ed.rv, w[0] * wt, w[1] * wt, w[3] * wt);
      }
    }
    // each 32 sums as two sets of 16 across the half-warp's lanes
#pragma unroll
    for (int g = 0; g < NA / 16; ++g) reduce_scatter<8>(acc + 16 * g, lane);
    if (live) {
      float* out = hg + (long long)p * kPair + (kPart == 0 ? 0 : kObjPart);
#pragma unroll
      for (int g = 0; g < NA / 16; ++g) out[16 * g + hl] = acc[16 * g];
    }
  }
}

// The robust cost share of this thread's inlier edges at the poses (camT,
// objT), in the edge pass's layout and order (the LM trial cost): at equal
// poses the two costs are equal.
__device__ double cost_pass(const Args& a, const float* camT, const float* objT,
                            bool use_huber) {
  const int hl = lane_id() & 15;
  const int O = a.O, K = a.K, P = a.V * a.O;
  double cost = 0.0;
  for (int p0 = 2 * warp_id(); p0 < P; p0 += 2 * kWarps) {
    const int p = p0 + (lane_id() >> 4);
    if (p >= P) continue;
    const int v = p / O, o = p - v * O;
    const float* Tc = camT + (long long)v * 16;
    const float* To = objT + (long long)o * 16;
    const float* ck = a.cam_k + (long long)p * 4;
    for (int k = hl; k < K; k += 16) {
      const long long e = (long long)p * K + k;
      if (!a.inl[e]) continue;
      const Edge ed = project_edge(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck,
                                   a.uv + e * 2, a.info + e * 4);
      cost += robust(ed.chi2, use_huber, a);
    }
  }
  return cost;
}

// inl = valid & active & (chi2 <= thresh | all_in) at (camT, objT); the
// thread's share of the inlier count and of the inliers' chi2.
__device__ void classify(const Args& a, const float* camT, const float* objT, bool all_in,
                         int& count, double& chi2_sum) {
  const int lane = lane_id();
  const int O = a.O, K = a.K, P = a.V * a.O;
  count = 0;
  chi2_sum = 0.0;
  for (int p = warp_id(); p < P; p += kWarps) {
    const int v = p / O, o = p - v * O;
    const bool act = a.cam_active[v] && a.obj_active[o];
    const float* Tc = camT + (long long)v * 16;
    const float* To = objT + (long long)o * 16;
    const float* ck = a.cam_k + (long long)p * 4;
    for (int k = lane; k < K; k += 32) {
      const long long e = (long long)p * K + k;
      const Edge ed = project_edge(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck,
                                   a.uv + e * 2, a.info + e * 4);
      const bool in = act && a.valid[e] && (ed.chi2 <= a.chi2_thresh || all_in);
      a.inl[e] = in ? 1 : 0;
      if (in) {
        ++count;
        chi2_sum += ed.chi2;
      }
    }
  }
}

// The rotation block of a row-major 4x4 pose projected back onto SO(3)
// through the quaternion (`core/lie.py` `R_to_quat`, its candidate order
// and first-maximum choice, then `quat_to_R`), in place.
__device__ void reorthonormalize(float* T) {
  const float m00 = T[0], m01 = T[1], m02 = T[2];
  const float m10 = T[4], m11 = T[5], m12 = T[6];
  const float m20 = T[8], m21 = T[9], m22 = T[10];
  const float tr = m00 + m11 + m22;
  const float cand[4] = {1.f + tr, 1.f + m00 - m11 - m22, 1.f - m00 + m11 - m22,
                         1.f - m00 - m11 + m22};
  int idx = 0;
  for (int i = 1; i < 4; ++i)
    if (cand[i] > cand[idx] || (isnan(cand[i]) && !isnan(cand[idx]))) idx = i;
  const float s = sqrtf(clampmin(cand[idx], 1e-12f)) * 2.f;
  float q[4];
  if (idx == 0) {
    q[0] = 0.25f * s; q[1] = (m21 - m12) / s; q[2] = (m02 - m20) / s; q[3] = (m10 - m01) / s;
  } else if (idx == 1) {
    q[0] = (m21 - m12) / s; q[1] = 0.25f * s; q[2] = (m01 + m10) / s; q[3] = (m02 + m20) / s;
  } else if (idx == 2) {
    q[0] = (m02 - m20) / s; q[1] = (m01 + m10) / s; q[2] = 0.25f * s; q[3] = (m12 + m21) / s;
  } else {
    q[0] = (m10 - m01) / s; q[1] = (m02 + m20) / s; q[2] = (m12 + m21) / s; q[3] = 0.25f * s;
  }
  for (int pass = 0; pass < 2; ++pass) {  // R_to_quat's normalization, then quat_to_R's
    const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    for (int i = 0; i < 4; ++i) q[i] = q[i] / nq;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  T[0] = 1.f - 2.f * (y * y + z * z); T[1] = 2.f * (x * y - w * z); T[2] = 2.f * (x * z + w * y);
  T[4] = 2.f * (x * y + w * z); T[5] = 1.f - 2.f * (x * x + z * z); T[6] = 2.f * (y * z - w * x);
  T[8] = 2.f * (x * z - w * y); T[9] = 2.f * (y * z + w * x); T[10] = 1.f - 2.f * (x * x + y * y);
}

// One camera's damped, masked, Jacobi-scaled 6x6 block and its factor (K7's
// `cams` stage); with `solve` (tracking) also its step -gc_s through the
// factor, scaled back: d_cam[v] = x * ic * mc.
__device__ void camera_block(int v, const float* csum, float mc, float lam, float* Lc, float* ic,
                             float* gcs, bool solve, float* dcam) {
  float H[36], Hs[36], L[36], s[6], gs[6];
  const float* cs = csum + (long long)v * kCamSums;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) H[i * 6 + j] = H[j * 6 + i] = cs[u6(i, j)];
  for (int i = 0; i < 6; ++i) s[i] = 1.f / sqrtf(clampmin(damp_mask(H, i, i, lam, mc), 1e-12f));
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      Hs[i * 6 + j] = damp_mask(H, i, j, lam, mc) * s[i] * s[j] + (i == j ? 1e-9f : 0.f);
  chol6(Hs, L);
  for (int i = 0; i < 6; ++i) gs[i] = cs[21 + i] * mc * s[i];
  if (solve) {
    float b[6], x[6];
    for (int i = 0; i < 6; ++i) b[i] = -gs[i];
    cho_solve6(L, b, x);
    for (int i = 0; i < 6; ++i) dcam[(long long)v * 6 + i] = x[i] * s[i] * mc;
    return;
  }
  for (int i = 0; i < 36; ++i) Lc[(long long)v * 36 + i] = L[i];
  for (int i = 0; i < 6; ++i) {
    ic[(long long)v * 6 + i] = s[i];
    gcs[(long long)v * 6 + i] = gs[i];
  }
}

// One object's damped, masked, Jacobi-scaled block: io, Hoo_s, go_s.
__device__ void object_block(int o, const float* osum, float mo, float lam, float* io,
                             float* hoos, float* gos) {
  float H[36], s[6];
  const float* os = osum + (long long)o * kObjSums;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) H[i * 6 + j] = H[j * 6 + i] = os[u6(i, j)];
  for (int i = 0; i < 6; ++i) s[i] = 1.f / sqrtf(clampmin(damp_mask(H, i, i, lam, mo), 1e-12f));
  for (int i = 0; i < 6; ++i) {
    io[(long long)o * 6 + i] = s[i];
    gos[(long long)o * 6 + i] = os[21 + i] * mo * s[i];
    for (int j = 0; j < 6; ++j)
      hoos[(long long)o * 36 + i * 6 + j] = damp_mask(H, i, j, lam, mo) * s[i] * s[j];
  }
}

// Left-looking Cholesky of sym(S) (n x n, row stride ld), a thread per row
// (thread t of the nt taking part owns rows t, t + nt, ...; `sync` joins
// them): for column j each row i >= j forms a_i = A_ij - sum_{k<j} L_ik
// L_jk in order, then L_jj = sqrt(a_j) goes to dg[j] and L_ij = a_i / L_jj
// below it; a thread's rows go two at a time through one k loop. False
// when a pivot is not > 0 (the NaN factor of `_cholesky`: the step is
// refused). Out of line, as is the solve below, which halves the kernel's
// register spills.
template <typename Sync>
__device__ __noinline__ bool cholesky(float* S, int n, int ld, float* dg, int t, int nt,
                                      Sync sync) {
  for (int i = t; i < n; i += nt)
    for (int k = 0; k < i; ++k)
      S[(long long)i * ld + k] = 0.5f * (S[(long long)i * ld + k] + S[(long long)k * ld + i]);
  sync();
  for (int j = 0; j < n; ++j) {
    const float* Lj = S + (long long)j * ld;
    for (int i = j + t; i < n; i += 2 * nt) {  // two rows at once: two chains in flight
      const bool two = i + nt < n;
      const float* Li = S + (long long)i * ld;
      const float* Lh = S + (long long)(two ? i + nt : i) * ld;
      float a = Li[j], h = Lh[j];
#pragma unroll 4
      for (int k = 0; k < j; ++k) {
        const float l = Lj[k];
        a -= Li[k] * l;
        h -= Lh[k] * l;
      }
      S[(long long)i * ld + j] = a;
      if (two) S[(long long)(i + nt) * ld + j] = h;
    }
    sync();
    const float d = S[(long long)j * ld + j];
    if (!(d > 0.f)) return false;
    const float ljj = sqrtf(d);
    if (t == 0) dg[j] = ljj;
    for (int i = j + 1 + t; i < n; i += nt)
      S[(long long)i * ld + j] = S[(long long)i * ld + j] / ljj;
    sync();
  }
  return true;
}

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};

// x = L^-T L^-1 b by one warp from the factor (L below S's diagonal, its
// diagonal dg), column by column; b is consumed, z holds L^-1 b. Up to 64
// rows the vector stays in registers (lane l holds rows l and l + 32) and
// each step's value moves by a shuffle.
__device__ __noinline__ void cho_solve_warp(const float* S, int n, int ld, const float* dg,
                                            float* b, float* z, float* x) {
  const int lane = lane_id();
  if (n <= 64) {
    const int i0 = lane, i1 = lane + 32;
    float r0 = i0 < n ? b[i0] : 0.f, r1 = i1 < n ? b[i1] : 0.f;
    for (int j = 0; j < n; ++j) {  // forward: r <- L^-1 b
      const float zj = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j & 31) / dg[j];
      if (i0 == j) r0 = zj;
      if (i1 == j) r1 = zj;
      if (i0 > j && i0 < n) r0 -= S[(long long)i0 * ld + j] * zj;
      if (i1 > j && i1 < n) r1 -= S[(long long)i1 * ld + j] * zj;
    }
    for (int j = n - 1; j >= 0; --j) {  // backward: r <- L^-T r
      const float xj = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j & 31) / dg[j];
      if (i0 == j) r0 = xj;
      if (i1 == j) r1 = xj;
      if (i0 < j) r0 -= S[(long long)j * ld + i0] * xj;
      if (i1 < j) r1 -= S[(long long)j * ld + i1] * xj;
    }
    if (i0 < n) x[i0] = r0;
    if (i1 < n) x[i1] = r1;
    __syncwarp();
    return;
  }
  for (int j = 0; j < n; ++j) {
    const float zj = b[j] / dg[j];
    if (lane == 0) z[j] = zj;
    for (int i = j + 1 + lane; i < n; i += 32) b[i] -= S[(long long)i * ld + j] * zj;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = z[j] / dg[j];
    if (lane == 0) x[j] = xj;
    for (int i = lane; i < j; i += 32) z[i] -= S[(long long)j * ld + i] * xj;
    __syncwarp();
  }
}

template <bool kTrack>
__global__ void __launch_bounds__(kThreads, 1) ba_lm_kernel(const __grid_constant__ Args a) {
  extern __shared__ float dyn[];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x;
  const int V = a.V, O = a.O, n = 6 * O, C = n + 1, P = V * O;
  const Layout L = lm_layout(V, O);
  float* sc = a.scratch;
  float* camT = a.cam_out;
  float* objT = a.obj_out;
  float* camN = sc + L.camN;
  float* objN = kTrack ? objT : sc + L.objN;  // tracking moves no object
  float* hg = sc + L.hg;
  float* sys = a.s_in_smem ? dyn : sc + L.sys;  // S, then b, z, x, dg
  const int ld = n + 1;
  float* S = sys;
  float* bv = sys + (long long)n * ld;
  float* zv = bv + n;
  float* dobjs = zv + n;  // the objects' scaled step x
  float* dg = dobjs + n;
  float* mc = sc + L.mc;
  float* mo = sc + L.mo;
  __shared__ double red_d[kWarps];
  PhaseClock clk(a.cycles);

  for (int i = tid; i < V * 16; i += kThreads) camT[i] = a.cam_T[i];
  for (int i = tid; i < O * 16; i += kThreads) objT[i] = a.obj_T[i];
  __syncthreads();
  int cnt;
  double chi2_sum;
  classify(a, camT, objT, a.init_with_outliers != 0, cnt, chi2_sum);
  __syncthreads();

  float lam = 1e-5f;
  const int half = max(1, a.n_rounds / 2);
  for (int rnd = 0; rnd < a.n_rounds; ++rnd) {
    const bool use_huber = rnd <= half;
    int mine = 0;
    for (long long e = tid; e < (long long)P * a.K; e += kThreads) mine += a.inl[e] != 0;
    const long long n_inl = block_sum_int(mine, red_i);
    int it = 0;
    if (n_inl >= 4) {
      // vertex masks of this round's classification
      int first = 0x7fffffff;
      for (int v = warp_id(); v < V; v += kWarps) {
        int c = 0;
        for (int q = lane_id(); q < O * a.K; q += 32) c += a.inl[(long long)v * O * a.K + q] != 0;
        c = warp_sum_int(c);
        const bool in_graph = c > 0 && a.cam_active[v];
        const bool is_free = kTrack ? in_graph && c >= 3
                                    : in_graph && !(a.cam_frozen && a.cam_frozen[v]);
        if (lane_id() == 0) mc[v] = is_free ? 1.f : 0.f;
        if (in_graph) first = min(first, v);
      }
      for (int o = warp_id(); o < O; o += kWarps) {
        int c = 0;
        for (int q = lane_id(); q < V * a.K; q += 32) {
          const int v = q / a.K, k = q - v * a.K;
          c += a.inl[((long long)v * O + o) * a.K + k] != 0;
        }
        c = warp_sum_int(c);
        const bool in_graph = c > 0 && a.obj_active[o];
        const bool is_free = !kTrack && in_graph && !(a.obj_frozen && a.obj_frozen[o]);
        if (lane_id() == 0) mo[o] = is_free ? 1.f : 0.f;
      }
      first = block_min_int(first, red_i);  // argmax of cam_in_graph: 0 when none is
      if (!kTrack && a.fix_first_cam && tid == 0) mc[first == 0x7fffffff ? 0 : first] = 0.f;
      __syncthreads();
      clk.mark(kRound);

      bool done = false;
      while (it < a.rounds[rnd] && !done) {
        // H / g of every pair and the current robust cost
        double cost = 0.0;
        edge_pass<0, !kTrack>(a, camT, objT, use_huber, hg, cost);
        if (!kTrack) edge_pass<1, false>(a, camT, objT, use_huber, hg, cost);
        const double cost_old = block_sum_double(cost, red_d);  // its barrier publishes hg
        clk.mark(kEdges);
        float* csum = sc + L.csum;
        float* osum = sc + L.osum;
        for (int t = tid; t < V * kCamSums; t += kThreads) {
          const int v = t / kCamSums, q = t - v * kCamSums;
          float s = 0.f;
#pragma unroll 4
          for (int o = 0; o < O; ++o) s += hg[((long long)v * O + o) * kPair + q];
          csum[t] = s;
        }
        if (!kTrack)
          for (int t = tid; t < O * kObjSums; t += kThreads) {
            const int o = t / kObjSums, q = t - o * kObjSums;
            float s = 0.f;
#pragma unroll 4
            for (int v = 0; v < V; ++v) s += hg[((long long)v * O + o) * kPair + kObjPart + q];
            osum[t] = s;
          }
        __syncthreads();

        float* Lc = sc + L.Lc;
        float* ic = sc + L.ic;
        float* gcs = sc + L.gcs;
        float* io = sc + L.io;
        float* dcam = sc + L.dcam;
        float* dobj = sc + L.dobj;
        bool bad = false;
        for (int t = tid; t < V + (kTrack ? 0 : O); t += kThreads) {
          if (t < V) {
            camera_block(t, csum, mc[t], lam, Lc, ic, gcs, kTrack, dcam);
            if (kTrack)
              for (int i = 0; i < 6; ++i) bad |= !isfinite(dcam[(long long)t * 6 + i]);
          } else {
            object_block(t - V, osum, mo[t - V], lam, io, sc + L.hoos, sc + L.gos);
          }
        }
        bool ok;
        if (kTrack) {
          ok = !__syncthreads_or(bad);
          clk.mark(kBlocks);
        } else {
          __syncthreads();
          clk.mark(kBlocks);
          // X[v] = Hcc_s[v]^-1 [Hco_s[v] | gc_s[v]]: a warp per camera, a lane per column
          float* hcos = sc + L.hcos;
          float* X = sc + L.X;
          for (int v = warp_id(); v < V; v += kWarps) {
            for (int c = lane_id(); c < C; c += 32) {
              float b[6], x[6];
              if (c < n) {
                const int o = c / 6, aa = c % 6;
                const float m = mo[o];
                const float* h = hg + ((long long)v * O + o) * kPair + 27;
                float* hs = hcos + ((long long)v * O + o) * 36;
                for (int i = 0; i < 6; ++i) {
                  b[i] = h[i * 6 + aa] * mc[v] * m * ic[(long long)v * 6 + i] *
                         io[(long long)o * 6 + aa];
                  hs[i * 6 + aa] = b[i];
                }
              } else {
                for (int i = 0; i < 6; ++i) b[i] = gcs[(long long)v * 6 + i];
              }
              cho_solve6(Lc + (long long)v * 36, b, x);
              for (int i = 0; i < 6; ++i) X[((long long)v * 6 + i) * C + c] = x[i];
            }
          }
          __syncthreads();
          clk.mark(kColumns);
          // S = blockdiag(Hoo_s) - sum_v Hco_s[v]^T X[v] + 1e-9 I and
          // b = -go_s + sum_v Hco_s[v]^T y_c[v]: a warp per object, a lane per
          // column q summing the object's 6 rows (q = n: b's entries)
          const float* hoos = sc + L.hoos;
          const float* gos = sc + L.gos;
          for (int o = warp_id(); o < O; o += kWarps) {
            for (int q = lane_id(); q <= n; q += 32) {
              float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
              for (int v = 0; v < V; ++v) {
                const float* hs = hcos + ((long long)v * O + o) * 36;
                const float* Xv = X + (long long)v * 6 * C + q;
                float xq[6];
#pragma unroll
                for (int i = 0; i < 6; ++i) xq[i] = Xv[(long long)i * C];
#pragma unroll
                for (int i = 0; i < 6; ++i)
#pragma unroll
                  for (int aa = 0; aa < 6; ++aa) acc[aa] += hs[i * 6 + aa] * xq[i];
              }
#pragma unroll
              for (int aa = 0; aa < 6; ++aa) {
                const int r = o * 6 + aa;
                if (q == n) {
                  bv[r] = -gos[r] + acc[aa];
                } else {
                  float s = -acc[aa];
                  if (q / 6 == o) s += hoos[(long long)o * 36 + aa * 6 + q % 6];
                  if (r == q) s += 1e-9f;
                  S[(long long)r * ld + q] = s;
                }
              }
            }
          }
          __syncthreads();
          clk.mark(kReduce);
          // one warp (two rows a lane) up to 64 rows: no block barrier per column
          bool fact_ok = false;
          if (n <= kWarpFactorRows) {
            if (warp_id() == 0) fact_ok = cholesky(S, n, ld, dg, lane_id(), 32, WarpSync());
            fact_ok = __syncthreads_or(warp_id() == 0 && fact_ok);
          } else {
            fact_ok = cholesky(S, n, ld, dg, tid, kThreads, BlockSync());
            __syncthreads();
          }
          if (fact_ok) {
            if (warp_id() == 0) cho_solve_warp(S, n, ld, dg, bv, zv, dobjs);
            __syncthreads();
            clk.mark(kFactor);
            // back-substitution: rhs = -gc_s - Hco_s d_obj_s, a thread per
            // (camera, row); then d_cam = Hcc_s^-1 rhs * ic * mc per camera
            for (int t = tid; t < V * 6; t += kThreads) {
              const int v = t / 6, i = t % 6;
              float acc = 0.f;
              for (int o = 0; o < O; ++o) {
                const float* hs = hcos + ((long long)v * O + o) * 36 + i * 6;
#pragma unroll
                for (int c = 0; c < 6; ++c) acc += hs[c] * dobjs[o * 6 + c];
              }
              dcam[t] = -gcs[t] - acc;
            }
            __syncthreads();
            for (int t = tid; t < V + n; t += kThreads) {
              if (t < V) {
                float x[6];
                cho_solve6(Lc + (long long)t * 36, dcam + (long long)t * 6, x);
                for (int i = 0; i < 6; ++i) {
                  dcam[(long long)t * 6 + i] = x[i] * ic[(long long)t * 6 + i] * mc[t];
                  bad |= !isfinite(dcam[(long long)t * 6 + i]);
                }
              } else {
                const int r = t - V;
                dobj[r] = dobjs[r] * io[r] * mo[r / 6];
                bad |= !isfinite(dobj[r]);
              }
            }
          }
          ok = fact_ok && !__syncthreads_or(bad);
          clk.mark(fact_ok ? kBack : kFactor);
        }

        // the trial poses exp(d) T (a zero step where the solve failed)
        bool nonfinite = false;
        const float zero[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int t = tid; t < V + O; t += kThreads) {
          if (t < V) {
            exp_compose(ok ? dcam + (long long)t * 6 : zero, camT + (long long)t * 16,
                        camN + (long long)t * 16);
            for (int i = 0; i < 16; ++i) nonfinite |= !isfinite(camN[(long long)t * 16 + i]);
          } else {
            const int o = t - V;
            if (!kTrack)
              exp_compose(ok ? dobj + (long long)o * 6 : zero, objT + (long long)o * 16,
                          objN + (long long)o * 16);
            for (int i = 0; i < 16; ++i) nonfinite |= !isfinite(objN[(long long)o * 16 + i]);
          }
        }
        nonfinite = __syncthreads_or(nonfinite);
        bool accept = false;
        double cost_new = 0.0;
        if (ok && !nonfinite) {
          cost_new = block_sum_double(cost_pass(a, camN, objN, use_huber), red_d);
          accept = cost_new < cost_old;
        }
        if (accept) {
          for (int i = tid; i < V * 16; i += kThreads) camT[i] = camN[i];
          if (!kTrack)
            for (int i = tid; i < O * 16; i += kThreads) objT[i] = objN[i];
        }
        __syncthreads();
        const float lam_new = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-10f), 1e6f);
        const double rel_gain = accept ? (cost_old - cost_new) / fmax(cost_old, 1e-30) : INFINITY;
        lam = lam_new;
        ++it;
        done = (rel_gain < 1e-6 && isfinite(rel_gain)) || lam_new >= 1e6f;
        clk.mark(kTrial);
      }
      for (int t = tid; t < V + O; t += kThreads)
        reorthonormalize(t < V ? camT + (long long)t * 16 : objT + (long long)(t - V) * 16);
      __syncthreads();
      classify(a, camT, objT, false, cnt, chi2_sum);
      __syncthreads();
      clk.mark(kRound);
    }
    if (tid == 0) a.ints[1 + rnd] = it;
  }
  classify(a, camT, objT, false, cnt, chi2_sum);
  const long long n_final = block_sum_int(cnt, red_i);
  const double total = block_sum_double(chi2_sum, red_d);
  clk.mark(kRound);
  if (tid == 0) {
    a.ints[0] = n_final;
    a.total_chi2[0] = (float)total;
  }
}

// ==== the cluster design ====================================================
// The global path (objects free) on a thread-block cluster: CTA `rank` owns
// the cameras [rank * cpr, rank * cpr + nc) and keeps their working set in
// its shared memory; objects' state is kept by every CTA alike. What crosses
// CTAs is pushed into the reader's shared memory (distributed shared
// memory; the scratch for a buffer that does not fit) and summed there in
// rank order behind a cluster barrier, so every CTA takes the same decisions
// from the same sums and a result repeats bit for bit. The tracking path
// (every object frozen) runs on one CTA with its state in shared memory.
// Loops stay rolled where a phase runs once an iteration: on this card,
// code a warp runs once costs its instruction fetch.

constexpr int kCThreads = 256;  // a CTA of the global path's cluster
constexpr int kCWarps = kCThreads / 32;
constexpr int kTThreads = 512;  // the tracking path's one CTA
constexpr int kTWarps = kTThreads / 32;
constexpr int kMaxCluster = 16;  // CTAs a cluster (above 8: a non-portable size)
constexpr int kSmemFloats = 56832;  // dynamic shared memory a CTA claims at most (227 KB less 5 KB)
constexpr int kTCam = 128;          // floats per camera on the tracking path

// The phases whose SM clock cycles `cycles` sums (thread 0 of rank 0):
// the edge pass; the camera and object blocks with the object sums'
// exchange; the columns X; the reduced system's partials, sums and
// all-gather; its factor and solve; the back-substitution and trial poses;
// the trial cost and the decision; the rounds' bookkeeping; the cluster
// barriers' waits. The tracking path uses edges, blocks (the sums, the
// camera's factor, solve and trial pose), trial and round.
enum NPhase { nEdges, nBlocks, nColumns, nReduce, nFactor, nBack, nTrial, nRound, nSync, nPhases };

struct NClock {
  long long* out;
  long long last;
  bool on;
  __device__ NClock(long long* p, bool lead) : out(p), last(0), on(p != nullptr && lead) {
    if (on) {
      for (int i = 0; i < nPhases; ++i) out[i] = 0;
      last = clock64();
    }
  }
  __device__ void mark(int ph) {
    if (on) {
      const long long now = clock64();
      out[ph] += now - last;
      last = now;
    }
  }
};

// The global path's buffers of one CTA in floats, in the order of their
// claim on shared memory (`plan_lm` mirrors it): each lives in shared
// memory while the budget lasts, else in the CTA's slice of the scratch.
enum CBuf { bXk, bXr, bPose, bOpose, bPoseD, bOposeD, bCam, bObj, bPairs, bXf, bHg, bHcos, bX,
            bXo, bXs, kCBufs };

struct CLayout {
  long long off[kCBufs];
  bool smem[kCBufs];
  long long smem_floats, global_floats;
};

__host__ __device__ inline CLayout cl_layout(long long V, long long O, long long G) {
  const long long n = 6 * O, C = n + 1, cpr = (V + G - 1) / G, rpr = (n + G - 1) / G;
  CLayout L;
  long long s = 0, g = 0;
  int b = 0;
  auto take = [&](long long size) {
    size = (size + 3) / 4 * 4;  // 16-byte aligned
    L.smem[b] = s + size <= kSmemFloats;
    L.off[b] = L.smem[b] ? s : g;
    (L.smem[b] ? s : g) += size;
    ++b;
  };
  take(8 * G);                    // xk: each rank's LM costs and step flag (doubles)
  take(2 * G * (4 + O + O % 2));  // xr: each rank's classification counts, two sets
  take(2 * cpr * 16);             // the CTA's camera poses, current and trial (f32)
  take(2 * O * 16);               // the object poses, current and trial (f32)
  take(4 * cpr * 16);             // the same in f64
  take(4 * O * 16);               // (f64: two floats an entry)
  take(cpr * 83);                 // per camera: csum, Lc, ic, gcs, dcam, mc, count
  take(O * 83 + 9 * n + 6);       // per object: osum .. count, 83 floats; x, rdg, z; the tile column P
  take(2 * cpr * O);              // the active pairs' list and their inlier counts
  take(n * C);                    // xf: the reduced system [S | b], factored in place
  take(cpr * O * kPair);          // the pairs' H / g sums
  take(cpr * O * 36);             // the scaled Hco blocks
  take(cpr * 6 * C);              // X = Hcc_s^-1 [Hco_s | gc_s] of the CTA's cameras
  take(G * O * kObjSums);         // xo: each rank's object sums
  take(G * rpr * C);              // xs: each rank's partial of the rows this CTA sums
  L.smem_floats = s;
  L.global_floats = g;
  return L;
}

// The tracking path's shared floats before the per-camera block: the
// objects' poses in f32 and f64, and a warp's f64 copy of its camera pose.
__host__ __device__ inline long long tr_fixed_floats(long long O) { return 48 * O + 64 * kTWarps; }

// The tracking path keeps the objects' poses in shared memory, and the
// per-camera block (poses current and trial, sums, mask, count) there too
// when it fits, else in the scratch.
__host__ __device__ inline bool tr_cams_in_smem(long long V, long long O) {
  return tr_fixed_floats(O) + V * kTCam <= kSmemFloats;
}

struct CView {
  int rank, G, cpr, c0, nc, n, C, rpr;
  long long gstride;  // floats of one CTA's slice of the scratch
  bool gx;            // an exchange buffer lives in the scratch
  float* base[kCBufs];
  bool smem[kCBufs];
};

// Exchange buffer b of rank q (a push target): its shared memory mapped
// into the cluster, or its slice of the scratch.
__device__ __forceinline__ float* at_rank(const CView& c, int b, int q) {
  if (c.smem[b]) return cg::this_cluster().map_shared_rank(c.base[b], q);
  return c.base[b] + (long long)(q - c.rank) * c.gstride;
}

// A read of what other CTAs pushed into this CTA's buffer b (behind a
// cluster barrier): from shared memory, or from L2 past a stale L1 line.
template <typename T>
__device__ __forceinline__ T xget(const CView& c, int b, const T* p) {
  return c.smem[b] ? *p : __ldcg(p);
}

__device__ __forceinline__ void cluster_arrive(const CView& c) {
  if (c.gx) __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync(const CView& c) {
  cluster_arrive(c);
  cluster_wait();
}

// Lane l < 27 of a warp: entry (i, j), j <= i, of the 7 x 6 lower
// triangle [L; z^T] of a camera system (l = i (i + 1) / 2 + j; row 6 is
// the right-hand side).
__device__ __forceinline__ int tri_lane(int i, int j) { return i * (i + 1) / 2 + j; }

// The same total in every lane (each level adds a pair in either order,
// which rounds alike).
__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// The CTA's sum of every thread's x in every thread: each warp's total,
// then the warps' totals in order.
template <int W>
__device__ double cta_sum_d(double x, double* red) {
  x = warp_sum_d(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < W; ++w) t += red[w];
  __syncthreads();
  return t;
}

// One edge's residual and chi2 in f64: its projection from the f32 state
// and measurements in f64 (`project_edge`'s expressions), 1 / z as the f32
// edge's iz refined by one Newton step. An f32 residual uv - pi(.) of
// ~1e-3 NDC keeps ~6e-8 of absolute rounding (6e-5 of itself): summed
// into g, that rounding outweighs the true gradient along a pose's poorly
// constrained directions within ~2e-5 of the optimum (a tracking camera's
// coupled rotation and translation), so f32 steps there point nowhere and
// the accept test cannot tell (the f32 chi2 terms carry ~1e-4 of their
// own rounding, ~3e-6 of a global BA's cost, above the 1e-6 exit). With
// the residual in f64, g and the LM costs follow the cost itself; the
// Jacobian stays f32.
struct Res64 {
  double ru, rv, chi2;
};

__device__ __forceinline__ Res64 edge_residual64(const double* Tc, const double* To,
                                                 const float* m, const float* ck,
                                                 const float* uv, const float* w, float iz32) {
  double pG[3], pC[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pG[i] = To[i * 4 + 0] * m[0] + To[i * 4 + 1] * m[1] + To[i * 4 + 2] * m[2] + To[i * 4 + 3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pC[i] = Tc[i * 4 + 0] * pG[0] + Tc[i * 4 + 1] * pG[1] + Tc[i * 4 + 2] * pG[2] + Tc[i * 4 + 3];
  const double z = fabs(pC[2]) < 1e-12 ? 1e-12 : pC[2];
  const double iz = (double)iz32 * (2.0 - z * (double)iz32);
  Res64 r;
  r.ru = uv[0] - ((double)ck[0] * pC[0] * iz + ck[2]);
  r.rv = uv[1] - ((double)ck[1] * pC[1] * iz + ck[3]);
  r.chi2 = w[0] * r.ru * r.ru + 2.0 * w[1] * r.ru * r.rv + w[3] * r.rv * r.rv;
  return r;
}

// The g2o Huber-composed chi2 of one edge in f64 (the LM cost's term).
__device__ __forceinline__ double robust64(double s, bool use_huber, const Args& a) {
  if (!use_huber || s <= (double)a.huber_d2) return s;
  return (double)a.huber_2d * sqrt(fmax(s, 1e-30)) - a.huber_d2;
}

// One edge's robust LM cost term at the f64 poses (Tc, To), its 1 / z
// seeded in f32.
__device__ __forceinline__ double edge_cost64(const double* Tc, const double* To,
                                              const float* m, const float* ck, const float* uv,
                                              const float* w, bool use_huber, const Args& a) {
  double z = To[8] * m[0] + To[9] * m[1] + To[10] * m[2] + To[11];
  const double gx = To[0] * m[0] + To[1] * m[1] + To[2] * m[2] + To[3];
  const double gy = To[4] * m[0] + To[5] * m[1] + To[6] * m[2] + To[7];
  z = Tc[8] * gx + Tc[9] * gy + Tc[10] * z + Tc[11];
  const float iz32 = clamp_iz((float)z);
  return robust64(edge_residual64(Tc, To, m, ck, uv, w, iz32).chi2, use_huber, a);
}

// The state's poses are kept in f64, each with its f32 rounding beside it
// (the Jacobians and the classification read that): rounding a pose to f32
// moves a BA's cost by ~1e-5 near its optimum, as much as the last steps
// along its poorly constrained directions gain, so with f32 poses the
// accept test sees the rounding and the state stops ~2e-5 from the f64 BA.
// Entry (r, c) of se3_exp(d) T in f64 (`exp_compose`'s expressions for that
// entry): each lane of a warp forms one of the 16.
__device__ double exp_compose_entry(const float* df, const double* T, int r, int c) {
  const double w0 = df[0], w1 = df[1], w2 = df[2];
  const double d[6] = {w0, w1, w2, df[3], df[4], df[5]};
  const double theta2 = w2 * w2 + (w0 * w0 + w1 * w1);
  const double theta = sqrt(fmax(theta2, 0.0));
  double A, B, C;
  if (theta2 < 1e-8) {  // the series' terms by constant products (no f64 division)
    A = 1.0 - theta2 * (1.0 / 6.0);
    B = 0.5 - theta2 * (1.0 / 24.0);
    C = (1.0 / 6.0) - theta2 * (1.0 / 120.0);
  } else {
    double st, ct;
    sincos(theta, &st, &ct);
    A = st / theta;
    B = (1.0 - ct) / theta2;
    C = (theta - st) / (theta2 * theta);
  }
  if (r == 3) return T[12 + c];  // se3_exp's last row is (0, 0, 0, 1)
  const double W[9] = {0.0, -w2, w1, w2, 0.0, -w0, -w1, w0, 0.0};
  double E[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double ww = W[r * 3 + 2] * W[2 * 3 + k] +
                      (W[r * 3 + 0] * W[0 * 3 + k] + W[r * 3 + 1] * W[1 * 3 + k]);
    E[k] = B * ww + (A * W[r * 3 + k] + (r == k ? 1.0 : 0.0));
  }
  double Vr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double ww = W[r * 3 + 2] * W[2 * 3 + k] +
                      (W[r * 3 + 0] * W[0 * 3 + k] + W[r * 3 + 1] * W[1 * 3 + k]);
    Vr[k] = C * ww + (B * W[r * 3 + k] + (r == k ? 1.0 : 0.0));
  }
  E[3] = Vr[2] * d[5] + (Vr[0] * d[3] + Vr[1] * d[4]);
  return E[3] * T[12 + c] + (E[2] * T[8 + c] + (E[0] * T[c] + E[1] * T[4 + c]));
}

// `reorthonormalize` in f64.
__device__ void reorthonormalize64(double* T) {
  const double m00 = T[0], m01 = T[1], m02 = T[2];
  const double m10 = T[4], m11 = T[5], m12 = T[6];
  const double m20 = T[8], m21 = T[9], m22 = T[10];
  const double tr = m00 + m11 + m22;
  const double cand[4] = {1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22};
  int idx = 0;
  for (int i = 1; i < 4; ++i)
    if (cand[i] > cand[idx] || (isnan(cand[i]) && !isnan(cand[idx]))) idx = i;
  const double s = sqrt(isnan(cand[idx]) ? cand[idx] : fmax(cand[idx], 1e-12)) * 2.0;
  double q[4];
  if (idx == 0) {
    q[0] = 0.25 * s; q[1] = (m21 - m12) / s; q[2] = (m02 - m20) / s; q[3] = (m10 - m01) / s;
  } else if (idx == 1) {
    q[0] = (m21 - m12) / s; q[1] = 0.25 * s; q[2] = (m01 + m10) / s; q[3] = (m02 + m20) / s;
  } else if (idx == 2) {
    q[0] = (m02 - m20) / s; q[1] = (m01 + m10) / s; q[2] = 0.25 * s; q[3] = (m12 + m21) / s;
  } else {
    q[0] = (m10 - m01) / s; q[1] = (m02 + m20) / s; q[2] = (m12 + m21) / s; q[3] = 0.25 * s;
  }
  for (int pass = 0; pass < 2; ++pass) {
    const double nq = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    for (int i = 0; i < 4; ++i) q[i] = q[i] / nq;
  }
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  T[0] = 1.0 - 2.0 * (y * y + z * z); T[1] = 2.0 * (x * y - w * z); T[2] = 2.0 * (x * z + w * y);
  T[4] = 2.0 * (x * y + w * z); T[5] = 1.0 - 2.0 * (x * x + z * z); T[6] = 2.0 * (y * z - w * x);
  T[8] = 2.0 * (x * z - w * y); T[9] = 2.0 * (y * z + w * x); T[10] = 1.0 - 2.0 * (x * x + y * y);
}

// A pose's f32 rounding from its f64 value, and whether it is finite.
__device__ __forceinline__ bool round_pose(const double* D, float* F) {
  bool ok = true;
  for (int i = 0; i < 16; ++i) {
    F[i] = (float)D[i];
    ok &= isfinite(D[i]) != 0;
  }
  return ok;
}

// One edge's terms of both row sets of its pair's sums, each term as the
// earlier design's two passes form it: camera rows (Hcc upper at u6, gc at
// 21, Hco[i][a] at 27 + 6 i + a) and object rows at kObjPart (Hoo upper, go
// at 21).
__device__ __forceinline__ void accumulate_all(float (&acc)[kPair], const float* r0,
                                               const float* r1, float ru, float rv, float v00,
                                               float v01, float v11) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = r0[i] * v00 + r1[i] * v01;
    const float w1 = r0[i] * v01 + r1[i] * v11;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[u6(i, j)] += w0 * r0[j] + w1 * r1[j];
    acc[21 + i] += w0 * ru + w1 * rv;
#pragma unroll
    for (int b = 0; b < 6; ++b) acc[27 + i * 6 + b] += w0 * r0[6 + b] + w1 * r1[6 + b];
    const float x0 = r0[6 + i] * v00 + r1[6 + i] * v01;
    const float x1 = r0[6 + i] * v01 + r1[6 + i] * v11;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[kObjPart + u6(i, j)] += x0 * r0[6 + j] + x1 * r1[6 + j];
    acc[kObjPart + 21 + i] += x0 * ru + x1 * rv;
  }
}

// The global path's edge pass over the CTA's active pairs: a half-warp per
// pair, a lane per edge (16 at a time), every edge projected once for both
// row sets; a butterfly reduce-scatter across the half-warp leaves the
// pair's 96 sums 6 to a lane (with_cost: and the f64 robust cost of its
// inliers, needed at a round's first iteration only: an accepted step's
// trial cost, summed by `cl_cost_pass` in this pass's order, is the next
// iteration's cost bit for bit). A pair whose camera or object is inactive
// has no inlier edge (`cl_classify`), so each of its terms is a zero (+0
// or -0) and its sums are +0: its slot keeps the +0 written once, and a
// sum over pairs is unchanged by it (s + 0 = s, and no sum is -0).
// Returns the thread's share of the inliers' robust cost.
__device__ double cl_edge_pass(const Args& a, const CView& c, const int* plist, int np,
                               const float* camT, const float* objT, const double* camD,
                               const double* objD, bool use_huber, bool with_cost, float* hg) {
  const int lane = threadIdx.x & 31, hl = lane & 15, warp = threadIdx.x >> 5;
  const int O = a.O, K = a.K;
  double cost = 0.0;
  for (int i0 = 2 * warp; i0 < np; i0 += 2 * kCWarps) {
    const int i = i0 + (lane >> 4);
    const bool live = i < np;
    const int lp = live ? plist[i] : 0;
    float acc[kPair];
#pragma unroll
    for (int q = 0; q < kPair; ++q) acc[q] = 0.f;
    if (live) {
      const int vl = lp / O, o = lp - vl * O;
      const long long p = (long long)(c.c0 + vl) * O + o;
      const float* Tc = camT + vl * 16;
      const float* To = objT + o * 16;
      const float* ck = a.cam_k + p * 4;
      for (int k = hl; k < K; k += 16) {
        const long long e = p * K + k;
        const float* w = a.info + e * 4;
        const Edge ed = project_edge(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck,
                                     a.uv + e * 2, w);
        const bool in = a.inl[e] != 0;
        const Res64 r = edge_residual64(camD + vl * 16, objD + o * 16,
                                        a.model_kp + ((long long)o * K + k) * 3, ck, a.uv + e * 2,
                                        w, ed.iz);
        if (in && with_cost) cost += robust64(r.chi2, use_huber, a);
        const float chi2 = (float)r.chi2;
        const float wt = (in ? 1.f : 0.f) *
                         (use_huber ? huber_weight(chi2, a.huber_d, a.huber_d2) : 1.f);
        float r0[12], r1[12];
        edge_jacobian(Tc, ck, ed, r0, r1);
        accumulate_all(acc, r0, r1, (float)r.ru, (float)r.rv, w[0] * wt, w[1] * wt, w[3] * wt);
      }
    }
#pragma unroll
    for (int g = 0; g < kPair / 16; ++g) reduce_scatter<8>(acc + 16 * g, lane);
    if (live) {
      float* out = hg + (long long)lp * kPair;
#pragma unroll
      for (int g = 0; g < kPair / 16; ++g) out[16 * g + hl] = acc[16 * g];
    }
  }
  return cost;
}

// The robust cost share of this thread's inlier edges at the poses (camT,
// objT), in the edge pass's layout and order.
__device__ double cl_cost_pass(const Args& a, const CView& c, const int* plist, int np,
                               const double* camT, const double* objT, bool use_huber) {
  const int lane = threadIdx.x & 31, hl = lane & 15, warp = threadIdx.x >> 5;
  const int O = a.O, K = a.K;
  double cost = 0.0;
  for (int i0 = 2 * warp; i0 < np; i0 += 2 * kCWarps) {
    const int i = i0 + (lane >> 4);
    if (i >= np) continue;
    const int lp = plist[i], vl = lp / O, o = lp - vl * O;
    const long long p = (long long)(c.c0 + vl) * O + o;
    const double* Tc = camT + vl * 16;
    const double* To = objT + o * 16;
    const float* ck = a.cam_k + p * 4;
    for (int k = hl; k < K; k += 16) {
      const long long e = p * K + k;
      if (!a.inl[e]) continue;
      cost += edge_cost64(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck, a.uv + e * 2,
                          a.info + e * 4, use_huber, a);
    }
  }
  return cost;
}

// inl = valid & (chi2 <= thresh | all_in) over the CTA's active pairs at
// (camT, objT), a warp a pair, a lane per edge; each pair's inlier count
// into pcnt. Returns the thread's share of the inliers' chi2.
__device__ __noinline__ double cl_classify(const Args& a, const CView& c, const int* plist, int np,
                              const float* camT, const float* objT, bool all_in, int* pcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int O = a.O, K = a.K;
  double chi2 = 0.0;
  for (int i = warp; i < np; i += kCWarps) {
    const int lp = plist[i], vl = lp / O, o = lp - vl * O;
    const long long p = (long long)(c.c0 + vl) * O + o;
    const float* Tc = camT + vl * 16;
    const float* To = objT + o * 16;
    const float* ck = a.cam_k + p * 4;
    int cnt = 0;
    for (int k = lane; k < K; k += 32) {
      const long long e = p * K + k;
      const Edge ed = project_edge(Tc, To, a.model_kp + ((long long)o * K + k) * 3, ck,
                                   a.uv + e * 2, a.info + e * 4);
      const bool in = a.valid[e] && (ed.chi2 <= a.chi2_thresh || all_in);
      a.inl[e] = in ? 1 : 0;
      if (in) {
        ++cnt;
        chi2 += ed.chi2;
      }
    }
    cnt = warp_sum_int(cnt);
    if (lane == 0) pcnt[lp] = cnt;
  }
  return chi2;
}

// x = L^-T z by one warp (L below S's diagonal, the reciprocals of its
// diagonal in rdg), from the last row up; z is consumed. Up to 64 rows the
// vector stays in registers (lane l holds rows l and l + 32) and each
// step's value moves by a shuffle.
__device__ __forceinline__ void back_solve_warp(const float* __restrict__ S, int n, int ld,
                                                const float* __restrict__ rdg,
                                                float* __restrict__ z, float* __restrict__ x) {
  const int lane = threadIdx.x & 31;
  if (n <= 64) {
    const int i0 = lane, i1 = lane + 32;
    float r0 = i0 < n ? z[i0] : 0.f, r1 = i1 < n ? z[i1] : 0.f;
    for (int j = n - 1; j >= 0; --j) {
      const float xj = __shfl_sync(0xffffffffu, j < 32 ? r0 : r1, j & 31) * rdg[j];
      if (i0 == j) r0 = xj;
      if (i1 == j) r1 = xj;
      if (i0 < j) r0 -= S[(long long)j * ld + i0] * xj;
      if (i1 < j) r1 -= S[(long long)j * ld + i1] * xj;
    }
    if (i0 < n) x[i0] = r0;
    if (i1 < n) x[i1] = r1;
    __syncwarp();
    return;
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = z[j] * rdg[j];
    if (lane == 0) x[j] = xj;
    for (int i = lane; i < j; i += 32) z[i] -= S[(long long)j * ld + i] * xj;
    __syncwarp();
  }
}

// `damp_mask` of one entry (i, j) of a 6x6 block (hd: its row's diagonal
// H[i][i]), and the Jacobi scale 1 / sqrt(max(damped H[i][i], 1e-12)).
__device__ __forceinline__ float damp1(float h, float hd, bool diag, float lam, float m) {
  const float d = clampmin(hd, 1e-9f);
  const float x = h + lam * d * (diag ? 1.f : 0.f);
  return x * m + (1.f - m) * (diag ? 1.f : 0.f);
}
__device__ __forceinline__ float scale1(float hd, float lam, float m) {
  return 1.f / sqrtf(clampmin(damp1(hd, hd, true, lam, m), 1e-12f));
}

// One lane's part of a camera's damped, masked, Jacobi-scaled 6x6 system
// (K7's `cams` stage, then sym(A) as `chol6` takes it), from the camera's
// sums (lane q < 27 brings sum q: Hcc upper at u6, gc at 21): lane l < 21
// holds entry (i, j), j <= i, of the lower triangle (l = i (i + 1) / 2 +
// j), lanes 21-26 the right-hand side -gc_s as row i = 6; si is the scale
// of row i (of column j in row 6).
struct Lane6 {
  int i, j;
  float a, si;
};

__device__ Lane6 warp_system6(float sq, float mc, float lam) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  Lane6 w;
  w.i = 0;
  while (w.i < 6 && tri_lane(w.i + 1, 0) <= lane) ++w.i;
  w.j = min(lane - tri_lane(w.i, 0), 5);
  const bool rhs = w.i == 6;
  const int ii = rhs ? w.j : w.i, j = w.j;
  const float hij = __shfl_sync(full, sq, rhs ? 21 + j : u6(j, ii));
  const float hii = __shfl_sync(full, sq, u6(ii, ii));
  const float hjj = __shfl_sync(full, sq, u6(j, j));
  w.si = scale1(hii, lam, mc);
  const float sj = scale1(hjj, lam, mc);
  if (rhs) {
    w.a = -(hij * mc * sj);
  } else {
    const bool diag = ii == j;
    const float e = diag ? 1e-9f : 0.f;
    const float a1 = damp1(hij, hii, diag, lam, mc) * w.si * sj + e;
    const float a2 = damp1(hij, hjj, diag, lam, mc) * sj * w.si + e;
    w.a = 0.5f * (a1 + a2);
  }
  return w;
}

// Right-looking Cholesky of the lanes' system with the forward solve as
// its seventh row: column c divides its entries below the pivot by L_cc,
// then each entry (i, j), c < j <= i, subtracts L_ic L_jc (row 6: z_c L_jc)
// — `chol6`'s and `cho_solve6`'s forward operations in their order.
// Leaves L_ij (z_j in row 6) in a; false in every lane where a pivot is
// not > 0 (`chol6`'s NaN factor).
__device__ bool warp_factor6(Lane6& w) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool mine = lane < 27;
  for (int c = 0; c < 6; ++c) {
    const float dv = __shfl_sync(full, w.a, tri_lane(c, c));
    if (!(dv > 0.f)) return false;
    const float ljj = sqrtf(dv);
    if (mine && w.j == c && w.i > c) w.a = w.a / ljj;
    if (mine && w.i == c && w.j == c) w.a = ljj;
    const float li = __shfl_sync(full, w.a, tri_lane(min(w.i, 6), c));
    const float lk = __shfl_sync(full, w.a, tri_lane(w.j, c));
    if (mine && w.j > c && w.i >= w.j) w.a -= li * lk;
  }
  return true;
}

// Cholesky of sym(S) (already symmetrized; n = 6O, row stride ld, the
// right-hand side b in column n) in 6 x 6 tiles, a tile column a step and
// three barriers a step (an unblocked factor costs two a column):
//   1. warp 0 factors the diagonal tile with the forward solve of its part
//      of b as a seventh row (`warp_factor6`: lanes hold the entries, the
//      chain runs through shuffles), writing L_JJ, z_J and 1 / L_cc (rdg);
//   2. a thread per row below the tile forms its 6 entries of the tile
//      column, L_rc = (A_rc - sum_k<c L_rk L_ck) / L_cc, into S and into P
//      ([6][n + 1], so a warp's lanes read consecutive rows);
//   3. the trailing lower triangle and b take the tile column's product, a
//      warp per row and a lane per entry, S[i][k] -= sum_c L_ic L_kc and
//      b_i -= sum_c L_ic z_c.
// Loops stay rolled: code a warp runs once a step costs its instruction
// fetch. False when a pivot is not > 0 (the NaN factor of `_cholesky`).
__device__ __noinline__ bool chol_tiles(float* __restrict__ S, int n, int ld,
                                        float* __restrict__ P, float* __restrict__ rdg,
                                        float* __restrict__ zv) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int J = 0; J < n; J += 6) {
    bool failed = false;
    if (warp == 0) {
      Lane6 w;
      w.i = 0;
      while (w.i < 6 && tri_lane(w.i + 1, 0) <= lane) ++w.i;
      w.j = min(lane - tri_lane(w.i, 0), 5);
      const bool mine = lane < 27;
      w.a = !mine ? 0.f
            : w.i < 6 ? S[(long long)(J + w.i) * ld + J + w.j]
                      : S[(long long)(J + w.j) * ld + n];
      failed = !warp_factor6(w);
      if (!failed && mine) {
        if (w.i < 6) S[(long long)(J + w.i) * ld + J + w.j] = w.a;
        else zv[J + w.j] = w.a;
        if (w.i == w.j) rdg[J + w.i] = 1.f / w.a;
      }
    }
    if (__syncthreads_or(failed)) return false;
    const int r0 = J + 6;
    for (int r = r0 + t; r < n; r += kCThreads) {
      float* Sr = S + (long long)r * ld + J;
      float l[6];
      for (int c = 0; c < 6; ++c) {
        float x = Sr[c];
        for (int k = 0; k < c; ++k) x -= l[k] * S[(long long)(J + c) * ld + J + k];
        l[c] = x * rdg[J + c];
        Sr[c] = l[c];
        P[c * (n + 1) + r] = l[c];
      }
    }
    __syncthreads();
    for (int i = r0 + warp; i < n; i += kCThreads / 32) {
      float li[6];
      for (int c = 0; c < 6; ++c) li[c] = P[c * (n + 1) + i];
      float* Si = S + (long long)i * ld;
      for (int k = r0 + lane; k <= i; k += 32) {
        float x = Si[k];
        for (int c = 0; c < 6; ++c) x -= li[c] * P[c * (n + 1) + k];
        Si[k] = x;
      }
      if (lane == 0) {
        float x = Si[n];
        for (int c = 0; c < 6; ++c) x -= li[c] * zv[J + c];
        Si[n] = x;
      }
    }
    __syncthreads();
  }
  return true;
}

// One camera's step across a warp (the tracking path): its system and
// factor as above, then every lane runs `cho_solve6`'s backward half.
// d[0..5] (every lane) = x * s * mc, NaN where a pivot is not > 0.
__device__ void warp_camera_step(float sq, float mc, float lam, float d[6]) {
  const unsigned full = 0xffffffffu;
  Lane6 w = warp_system6(sq, mc, lam);
  const bool ok = warp_factor6(w);
  float s[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = __shfl_sync(full, w.si, tri_lane(k, k));
  float L[27];
#pragma unroll
  for (int l = 0; l < 27; ++l) L[l] = __shfl_sync(full, w.a, l);
  if (!ok) {
#pragma unroll
    for (int k = 0; k < 6; ++k) d[k] = nanf("");
    return;
  }
  float x[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float v = L[21 + r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) v -= L[tri_lane(k, r)] * x[k];
    x[r] = v / L[tri_lane(r, r)];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = x[k] * s[k] * mc;
}

// The per-round exchange: this CTA's inlier count, its first camera in the
// graph, its inliers' chi2 and its per-object counts, pushed to every rank
// (set `set` of xr) and summed there in rank order. Each thread gets the
// totals; ocnt (per object) is written by the first O threads.
struct RoundSums {
  long long count;
  int first;
  double chi2;
};

__device__ __noinline__ RoundSums round_exchange(const Args& a, const CView& c, const int* pcnt,
                                                 int* ccnt, int* ocnt, double chi2_mine, int set,
                                                 double* red, NClock& clk) {
  const int tid = threadIdx.x, O = a.O, G = c.G;
  const long long RS = 4 + O + O % 2;  // words a rank's row
  const double chi2_cta = cta_sum_d<kCWarps>(chi2_mine, red);  // its barriers publish pcnt
  for (int t = tid; t < c.nc + O; t += kCThreads) {
    if (t < c.nc) {
      int s = 0;
      for (int o = 0; o < O; ++o) s += pcnt[t * O + o];
      ccnt[t] = s;
    } else {
      const int o = t - c.nc;
      int s = 0;
      for (int vl = 0; vl < c.nc; ++vl) s += pcnt[vl * O + o];
      for (int q = 0; q < G; ++q)
        reinterpret_cast<int*>(at_rank(c, bXr, q))[(set * G + c.rank) * RS + 4 + o] = s;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0, first = 0x7fffffff;
    for (int vl = 0; vl < c.nc; ++vl) {
      s += ccnt[vl];
      if (first == 0x7fffffff && ccnt[vl] > 0 && a.cam_active[c.c0 + vl]) first = c.c0 + vl;
    }
    for (int q = 0; q < G; ++q) {
      int* row = reinterpret_cast<int*>(at_rank(c, bXr, q)) + (set * G + c.rank) * RS;
      row[0] = s;
      row[1] = first;
      *reinterpret_cast<double*>(row + 2) = chi2_cta;
    }
  }
  clk.mark(nRound);
  cluster_sync(c);
  clk.mark(nSync);
  const int* xr = reinterpret_cast<const int*>(c.base[bXr]) + set * G * RS;
  RoundSums r{0, 0x7fffffff, 0.0};
  for (int q = 0; q < G; ++q) {
    const int* row = xr + q * RS;
    r.count += xget(c, bXr, row);
    r.first = min(r.first, xget(c, bXr, row + 1));
    r.chi2 += xget(c, bXr, reinterpret_cast<const double*>(row + 2));
  }
  for (int o = tid; o < O; o += kCThreads) {
    int s = 0;
    for (int q = 0; q < G; ++q) s += xget(c, bXr, xr + q * RS + 4 + o);
    ocnt[o] = s;
  }
  __syncthreads();
  return r;
}

// kSmem: every buffer of the plan lives in shared memory (the main path's
// shapes), so each pointer below derives from `dyn` and compiles to
// shared-memory accesses that never alias the global inputs.
template <bool kSmem>
__global__ void __launch_bounds__(kCThreads, 1)
    ba_lm_cluster_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ double red[kCWarps];
  __shared__ double red2[kCWarps];
  __shared__ int n_pairs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, O = a.O, K = a.K;
  CView c;
  c.G = a.G;
  c.rank = (int)cg::this_cluster().block_rank();
  c.cpr = (V + c.G - 1) / c.G;
  c.c0 = c.rank * c.cpr;
  c.nc = max(0, min(c.cpr, V - c.c0));
  c.n = 6 * O;
  c.C = c.n + 1;
  c.rpr = (c.n + c.G - 1) / c.G;
  const CLayout L = cl_layout(V, O, c.G);
  c.gstride = L.global_floats;
  for (int b = 0; b < kCBufs; ++b) {
    c.smem[b] = L.smem[b];
    c.base[b] = L.smem[b] ? dyn + L.off[b] : a.scratch + c.rank * c.gstride + L.off[b];
  }
  c.gx = !(L.smem[bXk] && L.smem[bXr] && L.smem[bXf] && L.smem[bXo] && L.smem[bXs]);
  const int G = c.G, cpr = c.cpr, nc = c.nc, n = c.n, C = c.C, rpr = c.rpr, c0 = c.c0;
  NClock clk(a.cycles, c.rank == 0 && tid == 0);

  auto buf = [&](int b) { return kSmem ? dyn + L.off[b] : c.base[b]; };
  // exchange buffer b of rank q, and a read of what other CTAs pushed into ours
  auto to = [&](int b, int q) {
    return kSmem ? cg::this_cluster().map_shared_rank(buf(b), q) : at_rank(c, b, q);
  };
  auto xg = [&](int b, const auto* p) { return kSmem ? *p : xget(c, b, p); };
  float* pose = buf(bPose);   // [2][cpr][16]
  float* opose = buf(bOpose);  // [2][O][16]
  double* poseD = reinterpret_cast<double*>(buf(bPoseD));    // [2][cpr][16]
  double* oposeD = reinterpret_cast<double*>(buf(bOposeD));  // [2][O][16]
  float* cam = buf(bCam);
  float* csum = cam;
  float* Lc = cam + 27 * cpr;
  float* ic = cam + 63 * cpr;
  float* gcs = cam + 69 * cpr;
  float* dcam = cam + 75 * cpr;
  float* mc = cam + 81 * cpr;
  int* ccnt = reinterpret_cast<int*>(cam + 82 * cpr);
  float* ob = buf(bObj);
  float* osum = ob;
  float* io = ob + 27 * O;
  float* hoos = ob + 33 * O;
  float* gos = ob + 69 * O;
  float* dobj = ob + 75 * O;
  float* mo = ob + 81 * O;
  int* ocnt = reinterpret_cast<int*>(ob + 82 * O);
  float* xv = ob + 83 * O;  // the objects' scaled step x
  float* rdg = xv + n;  // 1 / the factor's diagonal
  float* zv = rdg + n;
  float* Pn = zv + n;  // the factor's tile column, [6][n + 1]
  int* plist = reinterpret_cast<int*>(buf(bPairs));
  int* pcnt = plist + cpr * O;
  float* S = buf(bXf);
  float* hg = buf(bHg);
  float* hcos = buf(bHcos);
  float* X = buf(bX);
  const float* xo = buf(bXo);
  const float* xsr = buf(bXs);
  const double* xk = reinterpret_cast<const double*>(buf(bXk));

  // the state, the active pairs, and +0 sums and inlier flags for the rest
  for (int i = tid; i < nc * 16; i += kCThreads) {
    pose[i] = a.cam_T[(long long)c0 * 16 + i];
    poseD[i] = pose[i];
  }
  for (int i = tid; i < O * 16; i += kCThreads) {
    opose[i] = a.obj_T[i];
    oposeD[i] = opose[i];
  }
  for (long long i = tid; i < (long long)cpr * O * kPair; i += kCThreads) hg[i] = 0.f;
  for (int i = tid; i < cpr * O; i += kCThreads) pcnt[i] = 0;
  for (long long i = tid; i < (long long)nc * O * K; i += kCThreads) {
    const long long lp = i / K;
    const int vl = (int)(lp / O), o = (int)(lp - (long long)vl * O);
    if (!(a.cam_active[c0 + vl] && a.obj_active[o])) a.inl[(long long)c0 * O * K + i] = 0;
  }
  if (tid == 0) {
    int np = 0;
    for (int lp = 0; lp < nc * O; ++lp)
      if (a.cam_active[c0 + lp / O] && a.obj_active[lp % O]) plist[np++] = lp;
    n_pairs = np;
  }
  cluster_sync(c);  // every CTA has started before any pushes into it
  const int np = n_pairs;
  int cur = 0;  // which half of pose / opose is the current state
  int set = 0;  // which set of xr the next exchange fills

  RoundSums rs = round_exchange(
      a, c, pcnt, ccnt, ocnt,
      cl_classify(a, c, plist, np, pose, opose, a.init_with_outliers != 0, pcnt), set, red, clk);
  set ^= 1;

  float lam = 1e-5f;
  const int half = max(1, a.n_rounds / 2);
  for (int rnd = 0; rnd < a.n_rounds; ++rnd) {
    const bool use_huber = rnd <= half;
    int it = 0;
    if (rs.count >= 4) {
      // vertex masks of this round's classification
      const int first = rs.first == 0x7fffffff ? 0 : rs.first;  // argmax of cam_in_graph
      for (int t = tid; t < nc + O; t += kCThreads) {
        if (t < nc) {
          const int v = c0 + t;
          const bool in_graph = ccnt[t] > 0 && a.cam_active[v];
          const bool is_free = in_graph && !(a.cam_frozen && a.cam_frozen[v]) &&
                               !(a.fix_first_cam && v == first);
          mc[t] = is_free ? 1.f : 0.f;
        } else {
          const int o = t - nc;
          const bool in_graph = ocnt[o] > 0 && a.obj_active[o];
          mo[o] = in_graph && !(a.obj_frozen && a.obj_frozen[o]) ? 1.f : 0.f;
        }
      }
      __syncthreads();
      clk.mark(nRound);

      // fresh: the sums of the current poses are at hand (after a refused
      // step the state is unchanged, so its edge pass would repeat them bit
      // for bit: only the damping's blocks are formed again)
      bool done = false, fresh = false;
      double cost_old = 0.0;
      while (it < a.rounds[rnd] && !done) {
        float* camT = pose + cur * cpr * 16;
        float* camN = pose + (1 - cur) * cpr * 16;
        float* objT = opose + cur * O * 16;
        float* objN = opose + (1 - cur) * O * 16;
        const double* camTD = poseD + cur * cpr * 16;
        double* camND = poseD + (1 - cur) * cpr * 16;
        const double* objTD = oposeD + cur * O * 16;
        double* objND = oposeD + (1 - cur) * O * 16;
        if (!fresh) {
          // H / g of the CTA's pairs and its share of the current robust cost
          const bool with_cost = it == 0;
          const double cost_mine =
              warp_sum_d(cl_edge_pass(a, c, plist, np, camT, objT, camTD, objTD, use_huber,
                                      with_cost, hg));
          if (lane == 0) red[warp] = cost_mine;
          __syncthreads();
          clk.mark(nEdges);
          // the cameras' sums; the object sums and the cost pushed to every rank
          for (int t = tid; t < nc * kCamSums + O * kObjSums; t += kCThreads) {
            if (t < nc * kCamSums) {
              const int vl = t / kCamSums, q = t - vl * kCamSums;
              float s = 0.f;
              for (int o = 0; o < O; ++o) s += hg[((long long)vl * O + o) * kPair + q];
              csum[t] = s;
            } else {
              const int u = t - nc * kCamSums, o = u / kObjSums, q = u - o * kObjSums;
              float s = 0.f;
              for (int vl = 0; vl < nc; ++vl)
                s += hg[((long long)vl * O + o) * kPair + kObjPart + q];
              for (int r = 0; r < G; ++r) to(bXo, r)[(long long)c.rank * O * kObjSums + u] = s;
            }
          }
          if (tid == 0 && with_cost) {
            double s = 0.0;
            for (int w = 0; w < kCWarps; ++w) s += red[w];
            for (int r = 0; r < G; ++r) reinterpret_cast<double*>(to(bXk, r))[c.rank] = s;
          }
          __syncthreads();
          cluster_arrive(c);
        }
        // the cameras' blocks (K7's `cams` stage, a warp per camera) need no
        // other CTA: formed while the sums travel
        for (int vl = warp; vl < nc; vl += kCWarps) {
          Lane6 w = warp_system6(lane < 27 ? csum[vl * kCamSums + lane] : 0.f, mc[vl], lam);
          if (lane >= 21 && lane < 27) gcs[vl * 6 + w.j] = -w.a;
          if (lane < 21 && w.i == w.j) ic[vl * 6 + w.i] = w.si;
          const bool ok = warp_factor6(w);
          if (lane < 21) Lc[vl * 36 + w.i * 6 + w.j] = ok ? w.a : nanf("");
        }
        clk.mark(nBlocks);
        if (!fresh) {
          cluster_wait();
          clk.mark(nSync);
          for (int t = tid; t < O * kObjSums; t += kCThreads) {
            float s = 0.f;
            for (int r = 0; r < G; ++r) s += xg(bXo, xo + (long long)r * O * kObjSums + t);
            osum[t] = s;
          }
          if (it == 0) {
            cost_old = 0.0;
            for (int r = 0; r < G; ++r) cost_old += xg(bXk, xk + r);
          }
        }
        __syncthreads();
        // the objects' blocks (`object_block`), a thread per entry: Hoo_s,
        // then io and go_s
        for (int t = tid; t < O * 42; t += kCThreads) {
          const int o = t / 42, e = t - o * 42;
          const float* os = osum + o * kObjSums;
          const float m = mo[o];
          if (e < 36) {
            const int i = e / 6, j = e % 6;
            const float hii = os[u6(i, i)];
            hoos[o * 36 + e] = damp1(os[u6(min(i, j), max(i, j))], hii, i == j, lam, m) *
                               scale1(hii, lam, m) * scale1(os[u6(j, j)], lam, m);
          } else {
            const int i = e - 36;
            const float si = scale1(os[u6(i, i)], lam, m);
            io[o * 6 + i] = si;
            gos[o * 6 + i] = os[21 + i] * m * si;
          }
        }
        __syncthreads();
        clk.mark(nBlocks);
        // X[v] = Hcc_s[v]^-1 [Hco_s[v] | gc_s[v]]: a thread per (camera, column)
        for (int t = tid; t < nc * C; t += kCThreads) {
          const int vl = t / C, col = t - vl * C;
          float b[6], x[6];
          if (col < n) {
            const int o = col / 6, aa = col % 6;
            const float m = mo[o];
            const float* h = hg + ((long long)vl * O + o) * kPair + 27;
            float* hs = hcos + ((long long)vl * O + o) * 36;
            for (int i = 0; i < 6; ++i) {
              b[i] = h[i * 6 + aa] * mc[vl] * m * ic[vl * 6 + i] * io[o * 6 + aa];
              hs[i * 6 + aa] = b[i];
            }
          } else {
            for (int i = 0; i < 6; ++i) b[i] = gcs[vl * 6 + i];
          }
          cho_solve6(Lc + vl * 36, b, x);
          for (int i = 0; i < 6; ++i) X[((long long)vl * 6 + i) * C + col] = x[i];
        }
        __syncthreads();
        clk.mark(nColumns);
        // this CTA's partial of sum_v Hco_s[v]^T X[v], each entry pushed to
        // the rank that sums its row: a thread per (object, column), 6 rows
        for (int t = tid; t < O * C; t += kCThreads) {
          const int o = t / C, q = t - o * C;
          float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int vl = 0; vl < nc; ++vl) {
            const float* hs = hcos + ((long long)vl * O + o) * 36;
            const float* Xv = X + (long long)vl * 6 * C + q;
            float xq[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) xq[i] = Xv[(long long)i * C];
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
              for (int aa = 0; aa < 6; ++aa) acc[aa] += hs[i * 6 + aa] * xq[i];
          }
#pragma unroll
          for (int aa = 0; aa < 6; ++aa) {
            const int r = o * 6 + aa, own = r / rpr;
            to(bXs, own)[((long long)c.rank * rpr + (r - own * rpr)) * C + q] = acc[aa];
          }
        }
        clk.mark(nReduce);
        cluster_sync(c);
        clk.mark(nSync);
        // this CTA's rows: the ranks' partials in rank order, then
        // S = blockdiag(Hoo_s) - sum + 1e-9 I and b = -go_s + sum, pushed to
        // every rank
        const int r0 = c.rank * rpr, nrow = max(0, min(rpr, n - r0));
        for (int t = tid; t < nrow * C; t += kCThreads) {
          const int lr = t / C, q = t - lr * C, r = r0 + lr, o = r / 6, aa = r % 6;
          float s = 0.f;
          for (int src = 0; src < G; ++src)
            s += xg(bXs, xsr + ((long long)src * rpr + lr) * C + q);
          float val;
          if (q == n) {
            val = -gos[r] + s;
          } else {
            val = -s;
            if (q / 6 == o) val += hoos[o * 36 + aa * 6 + q % 6];
            if (r == q) val += 1e-9f;
          }
          for (int dst = 0; dst < G; ++dst) to(bXf, dst)[(long long)r * C + q] = val;
        }
        clk.mark(nReduce);
        cluster_sync(c);
        clk.mark(nSync);
        // every CTA factors the same system alike: sym(S), its factor with
        // z = L^-1 b riding along, then x = L^-T z
        if (!kSmem && !c.smem[bXf]) {
          for (long long i = tid; i < (long long)n * C; i += kCThreads) S[i] = __ldcg(S + i);
          __syncthreads();
        }
        for (int t = tid; t < n * n; t += kCThreads) {
          const int i = t / n, k = t - i * n;
          if (k < i)
            S[(long long)i * C + k] = 0.5f * (S[(long long)i * C + k] + S[(long long)k * C + i]);
        }
        __syncthreads();
        const bool fact_ok = chol_tiles(S, n, C, Pn, rdg, zv);
        if (fact_ok && warp == 0) back_solve_warp(S, n, C, rdg, zv, xv);
        __syncthreads();
        clk.mark(nFactor);
        double cost_new_mine = 0.0;
        bool bad = false;
        if (fact_ok) {
          // back-substitution: rhs = -gc_s - Hco_s x, then d_cam = Hcc_s^-1 rhs * ic * mc
          for (int t = tid; t < nc * 6; t += kCThreads) {
            const int vl = t / 6, i = t % 6;
            float acc = 0.f;
            for (int o = 0; o < O; ++o) {
              const float* hs = hcos + ((long long)vl * O + o) * 36 + i * 6;
#pragma unroll
              for (int cc = 0; cc < 6; ++cc) acc += hs[cc] * xv[o * 6 + cc];
            }
            dcam[t] = -gcs[t] - acc;
          }
          __syncthreads();
          for (int t = tid; t < nc + n; t += kCThreads) {
            if (t < nc) {
              float x[6];
              cho_solve6(Lc + t * 36, dcam + t * 6, x);
              for (int i = 0; i < 6; ++i) {
                dcam[t * 6 + i] = x[i] * ic[t * 6 + i] * mc[t];
                bad |= !isfinite(dcam[t * 6 + i]);
              }
            } else {
              const int r = t - nc;
              dobj[r] = xv[r] * io[r] * mo[r / 6];
              bad |= !isfinite(dobj[r]);
            }
          }
          __syncthreads();
          // the trial poses exp(d) T of the CTA's cameras and of every object,
          // a thread an entry
          for (int t = tid; t < (nc + O) * 16; t += kCThreads) {
            const int q = t / 16, e = t % 16;
            const bool c_ = q < nc;
            const int u = c_ ? q : q - nc;
            const double x = exp_compose_entry((c_ ? dcam : dobj) + u * 6,
                                               (c_ ? camTD : objTD) + u * 16, e / 4, e % 4);
            (c_ ? camND : objND)[u * 16 + e] = x;
            (c_ ? camN : objN)[u * 16 + e] = (float)x;
            bad |= !isfinite(x);
          }
          bad = __syncthreads_or(bad);
          clk.mark(nBack);
          cost_new_mine = warp_sum_d(cl_cost_pass(a, c, plist, np, camND, objND, use_huber));
        }
        if (lane == 0) red2[warp] = cost_new_mine;
        __syncthreads();
        if (tid == 0) {
          double s = 0.0;
          for (int w = 0; w < kCWarps; ++w) s += red2[w];
          for (int r = 0; r < G; ++r) {
            double* x = reinterpret_cast<double*>(to(bXk, r));
            x[G + c.rank] = s;
            x[2 * G + c.rank] = bad ? 1.0 : 0.0;
          }
        }
        clk.mark(nTrial);
        cluster_sync(c);
        clk.mark(nSync);
        double cost_new = 0.0;
        bool any_bad = false;
        for (int r = 0; r < G; ++r) {
          cost_new += xg(bXk, xk + G + r);
          any_bad |= xg(bXk, xk + 2 * G + r) != 0.0;
        }
        const bool accept = fact_ok && !any_bad && cost_new < cost_old;
        if (accept) cur ^= 1;
        fresh = !accept;
        const double cost_prev = cost_old;
        if (accept) cost_old = cost_new;
        const float lam_new = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-10f), 1e6f);
        const double rel_gain = accept ? (cost_prev - cost_new) / fmax(cost_prev, 1e-30) : INFINITY;
        lam = lam_new;
        ++it;
        done = (rel_gain < 1e-6 && isfinite(rel_gain)) || lam_new >= 1e6f;
        clk.mark(nTrial);
      }
      float* camT = pose + cur * cpr * 16;
      float* objT = opose + cur * O * 16;
      for (int t = tid; t < nc + O; t += kCThreads) {
        double* D = t < nc ? poseD + cur * cpr * 16 + t * 16 : oposeD + cur * O * 16 + (t - nc) * 16;
        reorthonormalize64(D);
        round_pose(D, t < nc ? camT + t * 16 : objT + (t - nc) * 16);
      }
      __syncthreads();
      rs = round_exchange(a, c, pcnt, ccnt, ocnt,
                          cl_classify(a, c, plist, np, camT, objT, false, pcnt), set, red, clk);
      set ^= 1;
    }
    if (c.rank == 0 && tid == 0) a.ints[1 + rnd] = it;
  }
  const float* camT = pose + cur * cpr * 16;
  const float* objT = opose + cur * O * 16;
  rs = round_exchange(a, c, pcnt, ccnt, ocnt,
                      cl_classify(a, c, plist, np, camT, objT, false, pcnt), set, red, clk);
  for (int i = tid; i < nc * 16; i += kCThreads) a.cam_out[(long long)c0 * 16 + i] = camT[i];
  if (c.rank == 0) {
    for (int i = tid; i < O * 16; i += kCThreads) a.obj_out[i] = objT[i];
    if (tid == 0) {
      a.ints[0] = rs.count;
      a.total_chi2[0] = (float)rs.chi2;
    }
  }
  clk.mark(nRound);
}

// ---- the tracking path: one CTA -------------------------------------------


// The tracking path's edge mapping: wpc warps per camera (V <= 8: the
// camera's edges spread over its group of warps, whose partial sums each
// of them combines), else a warp per camera, each warp taking cameras w, w
// + 16, ...; a lane per edge.
struct TMap {
  int wpc, ng, grp, sub;
};

__device__ __forceinline__ TMap tr_map(int V) {
  TMap m;
  m.wpc = max(1, kTWarps / V);
  m.ng = kTWarps / m.wpc;
  m.grp = (threadIdx.x >> 5) / m.wpc;
  m.sub = (threadIdx.x >> 5) % m.wpc;
  return m;
}

// The tracking path's classification at the poses `pose(v)`: inl = valid &
// active & (chi2 <= thresh | all_in), the per-camera inlier counts into
// cams (shared-memory integer sums: any order gives the same count) and
// `total`; returns the CTA's chi2 of the inliers in every thread.
__device__ __noinline__ double tr_classify(const Args& a, const TMap& mp, float* cams,
                                           float* wpose, const float* objT, int cur, bool all_in,
                                           int* total, double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, O = a.O, K = a.K, OK = O * K;
  for (int v = tid; v < V; v += kTThreads) reinterpret_cast<int*>(cams + v * kTCam)[60] = 0;
  if (tid == 0) *total = 0;
  __syncthreads();
  double chi2 = 0.0;
  for (int v = mp.grp; v < V && mp.grp < mp.ng; v += mp.ng) {
    const float* Tc = (mp.wpc > 1 ? wpose + warp * 32 : cams + v * kTCam) + cur * 16;
    int cnt = 0;
    for (int j = mp.sub * 32 + lane; j < OK; j += mp.wpc * 32) {
      const int o = j / K, k = j - o * K;
      const long long e = (long long)v * OK + j;
      const Edge ed = project_edge(Tc, objT + o * 16, a.model_kp + ((long long)o * K + k) * 3,
                                   a.cam_k + ((long long)v * O + o) * 4, a.uv + e * 2,
                                   a.info + e * 4);
      const bool in = a.cam_active[v] && a.obj_active[o] && a.valid[e] &&
                      (ed.chi2 <= a.chi2_thresh || all_in);
      a.inl[e] = in ? 1 : 0;
      if (in) {
        ++cnt;
        chi2 += ed.chi2;
      }
    }
    cnt = warp_sum_int(cnt);
    if (lane == 0 && cnt) {
      atomicAdd(reinterpret_cast<int*>(cams + v * kTCam) + 60, cnt);
      atomicAdd(total, cnt);
    }
  }
  return cta_sum_d<kTWarps>(chi2, red);  // its barriers publish the counts
}

// The tracking path (every object frozen: each camera its own 6x6 system,
// no object moves) on one CTA. Per LM iteration: the edge pass (each
// camera's sums Hcc, gc by its group of warps, a warp's share reduced
// across its lanes) and one barrier; then every warp of a camera's group
// combines the group's shares in order, solves the camera's step
// (`warp_camera_step`), forms the trial pose (`exp_compose_entry`, a lane
// an entry) into its own copy of the camera's pose, and sums the trial
// cost of its edges — the warps of a group compute the same bits, so no
// barrier publishes the trial pose —; a second barrier, and every thread
// takes the same decision from the warps' costs in order.
__global__ void __launch_bounds__(kTThreads, 1) ba_lm_track_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ double red_o[kTWarps], red_n[kTWarps], red_c[kTWarps];
  __shared__ float part[kTWarps][32];
  __shared__ float wpose[kTWarps * 32];  // [warp][2][16]: a group's copies of its camera's pose
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, O = a.O, K = a.K, OK = O * K;
  float* objT = dyn;                                       // [O][16]
  double* objD = reinterpret_cast<double*>(dyn + O * 16);  // [O][16] in f64
  double* wposeD = objD + O * 16;                          // [warp][2][16] in f64
  // per camera: pose [2][16] at 0 (a warp per camera), the sums at 32, the
  // mask at 59, the inlier count at 60, the pose in f64 [2][16] at 64
  float* cams = tr_cams_in_smem(V, O) ? dyn + tr_fixed_floats(O) : a.scratch;
  const TMap mp = tr_map(V);
  const bool group = mp.wpc > 1;
  NClock clk(a.cycles, tid == 0);

  for (int i = tid; i < O * 16; i += kTThreads) {
    objT[i] = a.obj_T[i];
    objD[i] = objT[i];
  }
  for (int i = tid; i < V * 16; i += kTThreads) {
    cams[(i / 16) * kTCam + i % 16] = a.cam_T[i];
    reinterpret_cast<double*>(cams + (i / 16) * kTCam + 64)[i % 16] = a.cam_T[i];
  }
  if (group && mp.grp < V && lane < 16) {
    wpose[warp * 32 + lane] = a.cam_T[mp.grp * 16 + lane];
    wposeD[warp * 32 + lane] = a.cam_T[mp.grp * 16 + lane];
  }
  int cur = 0;
  auto pose = [&](int v) { return (group ? wpose + warp * 32 : cams + v * kTCam); };
  auto poseD = [&](int v) {
    return group ? wposeD + warp * 32 : reinterpret_cast<double*>(cams + v * kTCam + 64);
  };

  double chi2_sum = tr_classify(a, mp, cams, wpose, objT, cur, a.init_with_outliers != 0, &total,
                                red_c);
  float lam = 1e-5f;
  const int half = max(1, a.n_rounds / 2);
  for (int rnd = 0; rnd < a.n_rounds; ++rnd) {
    const bool use_huber = rnd <= half;
    int it = 0;
    if (total >= 4) {
      for (int v = tid; v < V; v += kTThreads) {
        const int c = reinterpret_cast<const int*>(cams + v * kTCam)[60];
        cams[v * kTCam + 59] = (c > 0 && a.cam_active[v] && c >= 3) ? 1.f : 0.f;
      }
      // a non-finite object pose refuses every step (its trial pose is itself)
      bool ob = false;
      for (int i = tid; i < O * 16; i += kTThreads) ob |= !isfinite(objT[i]);
      const bool obj_bad = __syncthreads_or(ob);
      clk.mark(nRound);
      // fresh: the sums of the current poses are at hand (a refused step
      // leaves the state as it was, and its edge pass would repeat them)
      bool done = false, fresh = false;
      double cost_old = 0.0;
      while (it < a.rounds[rnd] && !done) {
        if (!fresh) {
          // the camera rows' sums (Hcc, gc) of each camera, and the cost
          double cost = 0.0;
          for (int v = mp.grp; v < V && mp.grp < mp.ng; v += mp.ng) {
            const float* Tc = pose(v) + cur * 16;
            float acc[32];
#pragma unroll
            for (int q = 0; q < 32; ++q) acc[q] = 0.f;
            for (int j = mp.sub * 32 + lane; j < OK; j += mp.wpc * 32) {
              const int o = j / K, k = j - o * K;
              const long long e = (long long)v * OK + j;
              const float* w = a.info + e * 4;
              const float* ck = a.cam_k + ((long long)v * O + o) * 4;
              const Edge ed = project_edge(Tc, objT + o * 16,
                                           a.model_kp + ((long long)o * K + k) * 3, ck,
                                           a.uv + e * 2, w);
              const bool in = a.inl[e] != 0;
              const Res64 r = edge_residual64(poseD(v) + cur * 16, objD + o * 16,
                                              a.model_kp + ((long long)o * K + k) * 3, ck,
                                              a.uv + e * 2, w, ed.iz);
              if (in && it == 0) cost += robust64(r.chi2, use_huber, a);
              const float chi2 = (float)r.chi2;
              const float wt = (in ? 1.f : 0.f) *
                               (use_huber ? huber_weight(chi2, a.huber_d, a.huber_d2) : 1.f);
              float r0[12], r1[12];
              edge_jacobian(Tc, ck, ed, r0, r1);
              accumulate<0, false>(acc, r0, r1, (float)r.ru, (float)r.rv, w[0] * wt, w[1] * wt,
                                   w[3] * wt);
            }
            reduce_scatter<16>(acc, lane);
            if (group)
              part[warp][lane] = acc[0];
            else if (lane < 27)
              cams[v * kTCam + 32 + lane] = acc[0];
          }
          cost = warp_sum_d(cost);
          if (lane == 0) red_o[warp] = cost;
          __syncthreads();
          clk.mark(nEdges);
          if (it == 0) {  // later, the last accepted trial cost (the same sum)
            cost_old = 0.0;
            for (int w = 0; w < kTWarps; ++w) cost_old += red_o[w];
          }
        }
        // each camera's step and trial pose, by every warp of its group alike
        bool bad = obj_bad;
        for (int v = mp.grp; v < V && mp.grp < mp.ng; v += mp.ng) {
          float sq = 0.f;
          if (group) {
            for (int s = 0; s < mp.wpc; ++s) sq += part[mp.grp * mp.wpc + s][lane];
          } else {
            sq = lane < 27 ? cams[v * kTCam + 32 + lane] : 0.f;
          }
          float d[6];
          warp_camera_step(sq, cams[v * kTCam + 59], lam, d);
          float* T = pose(v);
          double* TD = poseD(v);
          const double x = exp_compose_entry(d, TD + cur * 16, (lane >> 2) & 3, lane & 3);
          bool nf = lane < 16 && !isfinite(x);
          for (int i = 0; i < 6; ++i) nf |= !isfinite(d[i]);
          if (lane < 16) {
            TD[(1 - cur) * 16 + lane] = x;
            T[(1 - cur) * 16 + lane] = (float)x;
          }
          bad |= __any_sync(0xffffffffu, nf);
        }
        __syncwarp();
        clk.mark(nBlocks);
        // the trial cost of the warp's edges at its trial poses
        double cn = 0.0;
        if (!bad) {
          for (int v = mp.grp; v < V && mp.grp < mp.ng; v += mp.ng) {
            const double* Tc = poseD(v) + (1 - cur) * 16;
            for (int j = mp.sub * 32 + lane; j < OK; j += mp.wpc * 32) {
              const long long e = (long long)v * OK + j;
              if (!a.inl[e]) continue;
              const int o = j / K, k = j - o * K;
              cn += edge_cost64(Tc, objD + o * 16, a.model_kp + ((long long)o * K + k) * 3,
                                a.cam_k + ((long long)v * O + o) * 4, a.uv + e * 2,
                                a.info + e * 4, use_huber, a);
            }
          }
        }
        cn = warp_sum_d(cn);
        if (lane == 0) red_n[warp] = cn;
        bad = __syncthreads_or(bad);
        double cost_new = 0.0;
        for (int w = 0; w < kTWarps; ++w) cost_new += red_n[w];
        const bool accept = !bad && cost_new < cost_old;
        if (accept) cur ^= 1;
        fresh = !accept;
        const double cost_prev = cost_old;
        if (accept) cost_old = cost_new;
        const float lam_new = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-10f), 1e6f);
        const double rel_gain = accept ? (cost_prev - cost_new) / fmax(cost_prev, 1e-30) : INFINITY;
        lam = lam_new;
        ++it;
        done = (rel_gain < 1e-6 && isfinite(rel_gain)) || lam_new >= 1e6f;
        clk.mark(nTrial);
      }
      // re-orthonormalize: each warp its copies of its cameras, then the objects
      for (int v = mp.grp; v < V && mp.grp < mp.ng; v += mp.ng)
        if (lane == 0) {
          reorthonormalize64(poseD(v) + cur * 16);
          round_pose(poseD(v) + cur * 16, pose(v) + cur * 16);
        }
      for (int o = tid; o < O; o += kTThreads) {
        reorthonormalize64(objD + o * 16);
        round_pose(objD + o * 16, objT + o * 16);
      }
      __syncthreads();
      chi2_sum = tr_classify(a, mp, cams, wpose, objT, cur, false, &total, red_c);
      clk.mark(nRound);
    }
    if (tid == 0) a.ints[1 + rnd] = it;
  }
  chi2_sum = tr_classify(a, mp, cams, wpose, objT, cur, false, &total, red_c);
  for (int v = mp.grp; v < V && mp.grp < mp.ng && mp.sub == 0; v += mp.ng)
    if (lane < 16) a.cam_out[v * 16 + lane] = pose(v)[cur * 16 + lane];
  for (int i = tid; i < O * 16; i += kTThreads) a.obj_out[i] = objT[i];
  if (tid == 0) {
    a.ints[0] = total;
    a.total_chi2[0] = (float)chi2_sum;
  }
  clk.mark(nRound);
}

}  // namespace

extern "C" int suo_ba_lm(const void* cam_T, const void* obj_T, const void* uv, const void* info,
                         const void* model_kp, const void* cam_k, const void* valid,
                         const void* cam_active, const void* obj_active, const void* cam_frozen,
                         const void* obj_frozen, int V, int O, int K, const int* rounds,
                         int n_rounds, int tracking, int fix_first_cam, int init_with_outliers,
                         float huber_d, float huber_2d, float huber_d2, float chi2_thresh,
                         void* cam_out, void* obj_out, void* inl_out, void* ints_out,
                         void* chi2_out, void* scratch, long long scratch_floats, int smem_bytes,
                         void* cycles, void* stream) {
  const long long n = 6LL * O;
  if (V < 1 || O < 1 || K < 1 || n_rounds < 0 || n_rounds > kMaxRounds ||
      scratch_floats < lm_layout(V, O).total ||
      (smem_bytes != 0 && (long long)smem_bytes < lm_sys_floats(n) * (long long)sizeof(float)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cam_T = (const float*)cam_T;
  a.obj_T = (const float*)obj_T;
  a.uv = (const float*)uv;
  a.info = (const float*)info;
  a.model_kp = (const float*)model_kp;
  a.cam_k = (const float*)cam_k;
  a.valid = (const uint8_t*)valid;
  a.cam_active = (const uint8_t*)cam_active;
  a.obj_active = (const uint8_t*)obj_active;
  a.cam_frozen = (const uint8_t*)cam_frozen;
  a.obj_frozen = (const uint8_t*)obj_frozen;
  a.V = V;
  a.O = O;
  a.K = K;
  a.n_rounds = n_rounds;
  for (int r = 0; r < kMaxRounds; ++r) a.rounds[r] = r < n_rounds ? rounds[r] : 0;
  a.fix_first_cam = fix_first_cam;
  a.init_with_outliers = init_with_outliers;
  a.s_in_smem = smem_bytes > 0;
  a.huber_d = huber_d;
  a.huber_2d = huber_2d;
  a.huber_d2 = huber_d2;
  a.chi2_thresh = chi2_thresh;
  a.cam_out = (float*)cam_out;
  a.obj_out = (float*)obj_out;
  a.inl = (uint8_t*)inl_out;
  a.ints = (long long*)ints_out;
  a.total_chi2 = (float*)chi2_out;
  a.scratch = (float*)scratch;
  a.cycles = (long long*)cycles;
  auto kernel = tracking ? ba_lm_kernel<true> : ba_lm_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Both instances of the global path's kernel may claim the whole budget
// and form clusters above the portable 8.
static cudaError_t cluster_attributes() {
  for (auto kern : {ba_lm_cluster_kernel<true>, ba_lm_cluster_kernel<false>}) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * kSmemFloats);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The cluster design (`_ba_lm_cuda(design="cluster")`): the global path on
// a cluster of `cluster` CTAs, the tracking path on one CTA. The wrapper
// plans `cluster`, `smem_bytes` and the scratch (`plan_lm`); anything else
// is refused, never run on another design.
extern "C" int suo_ba_lm_cluster(const void* cam_T, const void* obj_T, const void* uv,
                                 const void* info, const void* model_kp, const void* cam_k,
                                 const void* valid, const void* cam_active,
                                 const void* obj_active, const void* cam_frozen,
                                 const void* obj_frozen, int V, int O, int K, const int* rounds,
                                 int n_rounds, int tracking, int fix_first_cam,
                                 int init_with_outliers, float huber_d, float huber_2d,
                                 float huber_d2, float chi2_thresh, void* cam_out, void* obj_out,
                                 void* inl_out, void* ints_out, void* chi2_out, void* scratch,
                                 long long scratch_floats, int cluster, int smem_bytes,
                                 void* cycles, void* stream) {
  if (V < 1 || O < 1 || K < 1 || n_rounds < 0 || n_rounds > kMaxRounds)
    return (int)cudaErrorInvalidValue;
  long long want_smem, want_scratch;
  if (tracking) {
    const bool in = tr_cams_in_smem(V, O);
    want_smem = 4LL * (tr_fixed_floats(O) + (in ? (long long)V * kTCam : 0));
    want_scratch = in ? 0 : (long long)V * kTCam;
    if (cluster != 1) return (int)cudaErrorInvalidValue;
  } else {
    const long long cpr = cluster >= 1 ? (V + cluster - 1) / cluster : 0;
    if (cluster < 1 || cluster > kMaxCluster || (cluster - 1) * cpr >= V)
      return (int)cudaErrorInvalidValue;
    const CLayout L = cl_layout(V, O, cluster);
    want_smem = 4 * L.smem_floats;
    want_scratch = cluster * L.global_floats;
  }
  if ((long long)smem_bytes != want_smem || scratch_floats < want_scratch)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.cam_T = (const float*)cam_T;
  a.obj_T = (const float*)obj_T;
  a.uv = (const float*)uv;
  a.info = (const float*)info;
  a.model_kp = (const float*)model_kp;
  a.cam_k = (const float*)cam_k;
  a.valid = (const uint8_t*)valid;
  a.cam_active = (const uint8_t*)cam_active;
  a.obj_active = (const uint8_t*)obj_active;
  a.cam_frozen = (const uint8_t*)cam_frozen;
  a.obj_frozen = (const uint8_t*)obj_frozen;
  a.V = V;
  a.O = O;
  a.K = K;
  a.n_rounds = n_rounds;
  for (int r = 0; r < kMaxRounds; ++r) a.rounds[r] = r < n_rounds ? rounds[r] : 0;
  a.fix_first_cam = fix_first_cam;
  a.init_with_outliers = init_with_outliers;
  a.G = cluster;
  a.huber_d = huber_d;
  a.huber_2d = huber_2d;
  a.huber_d2 = huber_d2;
  a.chi2_thresh = chi2_thresh;
  a.cam_out = (float*)cam_out;
  a.obj_out = (float*)obj_out;
  a.inl = (uint8_t*)inl_out;
  a.ints = (long long*)ints_out;
  a.total_chi2 = (float*)chi2_out;
  a.scratch = (float*)scratch;
  a.cycles = (long long*)cycles;
  const cudaStream_t st = (cudaStream_t)stream;
  static int raised_track = 48 * 1024;  // the dynamic shared memory allowed so far
  static bool raised_cluster = false;
  if (tracking) {
    if (smem_bytes > raised_track) {
      const cudaError_t err = cudaFuncSetAttribute(
          ba_lm_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      raised_track = smem_bytes;
    }
    ba_lm_track_kernel<<<1, kTThreads, smem_bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (!raised_cluster) {
    const cudaError_t err = cluster_attributes();
    if (err != cudaSuccess) return (int)err;
    raised_cluster = true;
  }
  const CLayout L = cl_layout(V, O, cluster);
  bool all_smem = true;
  for (int b = 0; b < kCBufs; ++b) all_smem = all_smem && L.smem[b];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = all_smem ? cudaLaunchKernelEx(&cfg, ba_lm_cluster_kernel<true>, a)
                                   : cudaLaunchKernelEx(&cfg, ba_lm_cluster_kernel<false>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The largest cluster of the global path's CTAs this card can co-schedule
// when each CTA claims the whole shared-memory budget (its plan claims no
// more), into *out.
extern "C" int suo_ba_lm_max_cluster(int* out) {
  cudaError_t err = cluster_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = 4 * (size_t)kSmemFloats;
  int n1 = 0, n2 = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&n1, (const void*)ba_lm_cluster_kernel<true>, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxPotentialClusterSize(&n2, (const void*)ba_lm_cluster_kernel<false>, &cfg);
  *out = n1 < n2 ? n1 : n2;
  return (int)err;
}
