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
// the eager form. Design: one persistent 512-thread block per call keeps the
// whole schedule on chip, its phases separated by block barriers, no
// atomics; every reduction runs in a fixed order, so a result repeats run to
// run:
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
// With `cycles`, thread 0 adds each phase's SM clock cycles there (`Phase`).
// Tracking (every object frozen) keeps K7's camera-only form: each camera
// solves its own 6x6 system and no object moves. The wrapper
// (`solvers/ba.py` `_ba_lm_cuda`) plans the scratch (`plan_lm`, whose
// formula `lm_layout` below mirrors) and allocates every buffer: the kernel
// allocates nothing. Compiled with --fmad=false: f32 CUDA-core arithmetic,
// no tensor cores, as the global system at lambda = 1e-5 is ill-conditioned
// even in f32.

#include "ba_common.cuh"

namespace {

using namespace suo_ba;

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
