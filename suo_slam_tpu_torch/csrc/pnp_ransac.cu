// K15 — the whole of PnP RANSAC for a batch of objects in one launch: the
// centroid / scale preconditioning, every hypothesis (P3P + the 4th point +
// the inlier count), the argmax, two rounds of 8 damped Gauss-Newton
// iterations with inlier reselection, the keep-only-if-no-inliers-lost gate,
// the unpreconditioning and the final inlier pass.
//
// Replaces `suo_slam_tpu/solvers/pnp.py` `pnp_ransac` (`:200-271`, vmapped
// by `pnp_ransac_batch` `:274`) after the sampler: the hypotheses, `_gn_refine`
// (`:110`) with `_solve6_spd` (`:96`), the refine block (`:248-262`) and the
// tail (`:264-271`), which the TPU runs as one jitted program. The port's
// eager form (`solvers/pnp.py` `pnp_ransac_batch_plain` with K3) issued
// ~2,900 small PyTorch launches per call after K3. In its draws mode it
// also ranks the sampler's draws into the hypotheses' indices, the work of
// `_sample_hypothesis_indices` (`:171-195`) after its Gumbel draw (K22's
// work, `csrc/pnp_sample.cu`, which stays off the main path): the main path
// hands over `torch.rand`'s u and no index ever reaches memory.
//
// Bound on this card: latency. At the main path's shapes (O = 8 objects,
// n_hyp = 64, N = 41 points) the inputs are ~12 KB and the work ~2 MFLOP of
// hypotheses plus 16 x 41 x ~200 flops of Gauss-Newton per object: well
// under a microsecond of either bytes or f32 operations. What costs is the
// chain of dependent steps — and, measured on the card, the instruction
// fetch of code a warp runs once (a loop's first trip costs several times
// its later ones) — so the design keeps all of it in one block per object,
// on chip, shortens the chain and keeps the code it runs small
// (`pnp_ransac_kernel`, 256 threads; `solvers/pnp.py` `plan_ransac` gives
// its geometry):
//   - (a) stage x (twice: as given for the final pass, and preconditioned
//     in place), y and the mask in shared memory; warp 0 sums the centroid
//     and the RMS scale in f64, rounding each once: `_precondition`'s values
//     bit for bit, whatever the order, so the hypotheses, their counts and
//     the argmax are the plain version's;
//   - (a') in the draws mode, each group of L lanes (below) ranks its
//     hypothesis's row of u in one pass (`rank_draws`); else it reads the
//     row's 4 indices;
//   - (b, c) a group of L lanes per hypothesis (4 where the hypotheses fit
//     one round, as at n_hyp = 64), inside one warp: each lane runs P3P's
//     shared part (`pnp_common.cuh` `p3p_prefix`, K3's code) and its own
//     candidates (`p3p_candidate`: the lambdas, their refinement, the pose,
//     the 4th point's error), the group takes the first minimum by shuffles
//     and writes the pose to shared memory; then the same lanes count the
//     hypothesis's inliers over the points with K3's `is_inlier` and an
//     integer shuffle sum, so every count is the plain version's. A warp
//     counts the hypotheses it solved, so no block barrier separates P3P
//     from the counts. The cubic's 50 Newton steps end where an iterate
//     repeats (a fixed point or a cycle of up to 4, `cubick`), with the
//     value the full trip count gives;
//   - (d) the first maximum of the counts (ties to the lowest index, as
//     torch.argmax), in each Gauss-Newton warp alike;
//   - (e) Gauss-Newton on one warp, two above 32 points (a thread per point
//     n = thread + 32 gw j): one pass over the points per iteration. The
//     pass at the trial pose T' sums, besides its cost under the current
//     weights (the accept test), all 28 terms of the next step at T' (H's 21
//     upper entries, g, the cost under the weights at T') and T''s inlier
//     bits: if T' is accepted they are the next iteration's, if not the
//     current ones stay (T and the weights are unchanged, so `_gn_refine`
//     would sum the same terms again). Each warp's partial sums leave its
//     lanes through a shared-memory transpose and a fixed-order tree; the
//     two warps meet at one named barrier and every lane adds their rows in
//     the same order, then runs the same 6x6 solve (`_solve6_spd`'s
//     closed-form 3x3 Schur blocks) and `exp_compose` (`ba_common.cuh`) on
//     the same values, so the warps agree on the pose with no more exchange.
//     These sums and the solve use fused multiply-adds: their order differs
//     from the plain version's anyway. The keep gate's count is the popcount
//     of the final pose's inlier bits;
//   - (f) `_unprecondition` and the final inliers on the raw points.
// An object whose RANSAC failed (fewer than 4 valid points or no hypothesis
// with 4 inliers) skips the refinement: its result is the identity and zero
// counts whatever the refinement would give. Compiled with --fmad=false;
// the Gauss-Newton sums run in another order than the plain version's
// einsum and reductions, so the accept test, the reselection and the keep
// gate can flip at their edges (chip_smoke holds the outcome, not the bits).
//
// `pnp_ransac_serial_kernel` is the earlier design, kept beside it for
// chip_smoke's comparison and phase clocks: up to 128 threads, a thread per
// hypothesis that also counts its inliers over the N points in series,
// Gauss-Newton on warp 0 with a 5-shuffle butterfly per sum and two passes
// over the points per iteration (it shares this file's helpers and
// `pnp_common.cuh`, so its P3P ends its cubic early too). With `cycles`,
// thread 0 of each block adds each phase's SM clock cycles to its block's
// row (`Phase`).

#include <climits>

#include "ba_common.cuh"
#include "pnp_common.cuh"

namespace {

using suo_pnp::nz;

constexpr int kThreads = 256;         // pnp_ransac_kernel's block (`plan_ransac`)
constexpr int kSerialMaxThreads = 128;
constexpr int kSerialMaxWarps = kSerialMaxThreads / 32;
constexpr int kPoseFloats = 12;       // a hypothesis's R (row-major) and t in shared memory
constexpr int kGnIters = 8;        // solvers/pnp.py REFINE_GN_ITERS
constexpr int kRounds = 2;         // refinement rounds, reselecting inliers between them
constexpr float kLambda0 = 1e-4f;  // _gn_refine's initial damping
constexpr unsigned kFull = 0xffffffffu;

// The phases whose SM clock cycles `cycles` holds, a row of kPhases per
// block (thread 0's view; `solvers/pnp.py` PNP_PHASES names them).
enum Phase {
  kStage, kRank, kP3pPrefix, kP3p, kCounts, kArgmax, kGnSums, kGnSolve, kAccept, kFinal, kPhases
};

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// p = R x + t for a row-major 4x4 pose, in `_reproj_sq_err`'s order
__device__ __forceinline__ void transform(const float* T, const float* x, float* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = x[0] * T[i * 4 + 0] + x[1] * T[i * 4 + 1] + x[2] * T[i * 4 + 2] + T[i * 4 + 3];
}

// One point under a pose: p = R x + t, 1 / z, the normalized projection
// (u, v), the residual r = (u, v) - y and `_reproj_sq_err`'s squared error
// (+inf behind the camera).
struct Proj {
  float p[3];
  float iz, u, v, r0, r1, err;
};

__device__ __forceinline__ Proj project(const float* T, const float* x, const float* y) {
  Proj q;
  transform(T, x, q.p);
  q.iz = 1.f / nz(q.p[2]);
  q.u = q.p[0] * q.iz;
  q.v = q.p[1] * q.iz;
  q.r0 = q.u - y[0];
  q.r1 = q.v - y[1];
  q.err = q.p[2] > 0.f ? q.r0 * q.r0 + q.r1 * q.r1 : INFINITY;
  return q;
}

__device__ __forceinline__ bool all_finite(const float* T) {
  bool f = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) f = f && isfinite(T[k]);
  return f;
}

using suo_ba::mad;

// `pnp._inv3`: the closed-form inverse of a row-major 3x3, its columns the
// cross products of the rows over the determinant (fused multiply-adds:
// Gauss-Newton's results are held to their outcome, not their bits)
__device__ __forceinline__ void inv3(const float* M, float* out) {
  float c[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // c[r] = row(r + 1) x row(r + 2)
    const float* a = M + ((r + 1) % 3) * 3;
    const float* b = M + ((r + 2) % 3) * 3;
    c[r][0] = mad<true>(a[1], b[2], -(a[2] * b[1]));
    c[r][1] = mad<true>(a[2], b[0], -(a[0] * b[2]));
    c[r][2] = mad<true>(a[0], b[1], -(a[1] * b[0]));
  }
  const float det = mad<true>(M[2], c[0][2], mad<true>(M[0], c[0][0], M[1] * c[0][1]));
  const float idet = 1.f / nz(det);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i * 3 + 0] = c[0][i] * idet;
    out[i * 3 + 1] = c[1][i] * idet;
    out[i * 3 + 2] = c[2][i] * idet;
  }
}

// sum_k a[k * sa] * b[k * sb] over k < 3, fused
__device__ __forceinline__ float dot3f(const float* a, int sa, const float* b, int sb) {
  return mad<true>(a[2 * sa], b[2 * sb], mad<true>(a[0], b[0], a[sa] * b[sb]));
}

// `pnp._solve6_spd`: H x = g for the damped SPD 6x6 (row-major) by its 3x3
// Schur blocks A = H[:3, :3], B = H[:3, 3:], D = H[3:, 3:]
__device__ __forceinline__ void solve6(const float* H, const float* g, float* x) {
  float A[9], B[9], Bt[9], D[9], Ai[9], AiB[9], S[9], Si[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = H[i * 6 + j];
      B[i * 3 + j] = H[i * 6 + 3 + j];
      Bt[j * 3 + i] = H[i * 6 + 3 + j];
      D[i * 3 + j] = H[(3 + i) * 6 + 3 + j];
    }
  inv3(A, Ai);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) AiB[i * 3 + j] = dot3f(Ai + i * 3, 1, B + j, 3);
#pragma unroll
  for (int i = 0; i < 3; ++i)  // S = D - B^T (Ai B)
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i * 3 + j] = D[i * 3 + j] - dot3f(Bt + i * 3, 1, AiB + j, 3);
  inv3(S, Si);
  float Aig1[3], r2[3], r1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Aig1[i] = dot3f(Ai + i * 3, 1, g, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2[i] = g[3 + i] - dot3f(Bt + i * 3, 1, Aig1, 1);  // g2 - B^T Ai g1
#pragma unroll
  for (int i = 0; i < 3; ++i) x[3 + i] = dot3f(Si + i * 3, 1, r2, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) r1[i] = g[i] - dot3f(B + i * 3, 1, x + 3, 1);  // g1 - B x2
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = dot3f(Ai + i * 3, 1, r1, 1);
}

// The sums of one Gauss-Newton step: H's 21 upper entries (row-major), g
// (6) and the weighted cost; the current design adds the trial cost (28) and
// pads to a warp (32).
constexpr int kSums = 28;
constexpr int kTrial = 28;

// One point's terms of `_gn_refine`'s step at its projection q: the 2x6
// Jacobian of the left update (Jproj @ [-hat(p) | I]) weighted by wz = w *
// (z > 0) (never pull a behind-camera point), into acc[0..27]. Returns wz.
__device__ __forceinline__ bool add_terms(const Proj& q, bool w, float* acc) {
  const float* p = q.p;
  const bool wzb = w && p[2] > 0.f;
  const float wz = wzb ? 1.f : 0.f;
  const float iz = q.iz;
  const float bu = -q.u * iz, bv = -q.v * iz;
  const float J0[6] = {bu * p[1], iz * p[2] + bu * -p[0], iz * -p[1], iz, 0.f, bu};
  const float J1[6] = {iz * -p[2] + bv * p[1], bv * -p[0], iz * p[0], 0.f, iz, bv};
  float W0[6], W1[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    W0[k] = J0[k] * wz;
    W1[k] = J1[k] * wz;
  }
  // fused multiply-adds: these sums run in another order than the plain
  // version's anyway (the result is held to its outcome, not its bits), and
  // half the instructions keep the pass small
  int e = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int l = k; l < 6; ++l, ++e) acc[e] = __fmaf_rn(W0[k], J0[l], __fmaf_rn(W1[k], J1[l], acc[e]));
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[21 + k] = __fmaf_rn(W0[k], q.r0, __fmaf_rn(W1[k], q.r1, acc[21 + k]));
  acc[27] += wz * (q.r0 * q.r0 + q.r1 * q.r1);
  return wzb;
}

// Pose T's trial step: H (damped by lam * max(tr(H) / 6, 1e-12)) and g from
// the sums S, delta = -H^-1 g, T' = exp(delta) T.
__device__ __forceinline__ void gn_step(const float* S, float lam, const float* T, float* Tn) {
  float H[36], g[6], delta[6];
  int e = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int l = k; l < 6; ++l, ++e) H[k * 6 + l] = H[l * 6 + k] = S[e];
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = S[21 + k];
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) tr += H[k * 6 + k];
  // tr / 6 as PyTorch divides by a Python scalar on the card: by its reciprocal
  const float damp = lam * suo_ba::clampmin(tr * (1.f / 6.f), 1e-12f);
#pragma unroll
  for (int k = 0; k < 6; ++k) H[k * 6 + k] += damp;
  solve6(H, g, delta);
#pragma unroll
  for (int k = 0; k < 6; ++k) delta[k] = -delta[k];
  suo_ba::exp_compose<true>(delta, T, Tn);
}

// Stage one object's points (all threads), then `_precondition` them in
// place: centroid and RMS scale over the valid points, the sums in f64
// (exact for a few dozen f32 terms, so in any order) and each statistic
// rounded once to f32, as the plain version computes them. Leaves the
// centroid, the scale and the valid count in s_cs[0..4]; returns the count
// (in every thread).
__device__ __forceinline__ int stage_and_precondition(const float* xo, const float* yo, const uint8_t* mo,
                                      int N, float* sx, float* sy, float* smk, float* s_cs,
                                      float* sxr = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = xo[n * 3 + k];
    if (sxr)
      for (int k = 0; k < 3; ++k) sxr[n * 3 + k] = xo[n * 3 + k];
    for (int k = 0; k < 2; ++k) sy[n * 2 + k] = yo[n * 2 + k];
    smk[n] = mo[n] ? 1.f : 0.f;
  }
  __syncthreads();
  int n_valid = 0;
  if (warp == 0) {
    double sum[3] = {0.0, 0.0, 0.0};
    int cnt = 0;
    for (int n = lane; n < N; n += 32) {
      for (int k = 0; k < 3; ++k) sum[k] += (double)(sx[n * 3 + k] * smk[n]);
      cnt += smk[n] != 0.f ? 1 : 0;
    }
    n_valid = warp_sum_int(cnt);
    const double nd = n_valid > 1 ? (double)n_valid : 1.0;
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = (float)(warp_sum_f64(sum[k]) / nd);
    double ss = 0.0;
    for (int n = lane; n < N; n += 32)
      for (int k = 0; k < 3; ++k) {
        const float xc = (sx[n * 3 + k] - c[k]) * smk[n];
        ss += (double)(xc * xc);
      }
    const double var = warp_sum_f64(ss) / nd;
    const float s = (float)sqrt(isnan(var) ? var : fmax(var, 1e-12));
    if (lane == 0) {
      for (int k = 0; k < 3; ++k) s_cs[k] = c[k];
      s_cs[3] = s;
      s_cs[4] = (float)n_valid;  // exact: N <= 2048
    }
  }
  __syncthreads();
  n_valid = (int)s_cs[4];
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    for (int k = 0; k < 3; ++k) sx[n * 3 + k] = (sx[n * 3 + k] - s_cs[k]) / s_cs[3];
  __syncthreads();
  return n_valid;
}

// (f) on warp 0: `_unprecondition` T (centroid and scale in s_cs), the final
// inliers on the raw points xr, the success gate, the outputs of object o.
__device__ __forceinline__ void finish(float* T, bool success, const float* s_cs, const float* xr,
                       const float* sy, const float* smk, int N, float thr_sq, int o,
                       float* T_out, uint8_t* inl_out, long long* num_out, uint8_t* succ_out) {
  const int lane = threadIdx.x & 31;
  const float s = s_cs[3];
  for (int i = 0; i < 3; ++i)
    T[i * 4 + 3] = s * T[i * 4 + 3] -
                   (T[i * 4 + 0] * s_cs[0] + T[i * 4 + 1] * s_cs[1] + T[i * 4 + 2] * s_cs[2]);
  success = success && all_finite(T);
  int num = 0;
  for (int n = lane; n < N; n += 32) {
    const bool in = success && project(T, xr + n * 3, sy + n * 2).err < thr_sq && smk[n] != 0.f;
    inl_out[(long long)o * N + n] = in ? 1 : 0;
    num += in ? 1 : 0;
  }
  num = warp_sum_int(num);
#pragma unroll
  for (int k = 0; k < 16; ++k)  // T indexed by constants only: it stays in registers
    if (lane == k) T_out[(long long)o * 16 + k] = success ? T[k] : ((k % 5 == 0) ? 1.f : 0.f);
  if (lane == 0) {
    num_out[o] = num;
    succ_out[o] = success ? 1 : 0;
  }
}

// ---------------------------------------------------------------- current --

constexpr int kPartStride = 33;  // a lane's row of partial sums in s_part, padded

// c[r] += c[r + H] for r < H: one level of a tree sum (every index a constant)
template <int H>
__device__ __forceinline__ void fold(float (&c)[32]) {
#pragma unroll
  for (int r = 0; r < H; ++r) c[r] += c[r + H];
}

// The kTrial + 1 sums v[0..kTrial] of every lane of the warp, summed over the
// lanes into buf[0..kTrial]: each lane stores its partials as a row of s_part
// (the warp's own rows, kPartStride words apart: conflict-free), then lane k
// adds column k in a fixed tree order, the same in every call.
__device__ __forceinline__ void reduce_sums(const float (&v)[32], float* s_part, float* buf,
                                            int lane) {
#pragma unroll
  for (int k = 0; k <= kTrial; ++k) s_part[lane * kPartStride + k] = v[k];
  __syncwarp();
  if (lane <= kTrial) {
    float c[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) c[r] = s_part[r * kPartStride + lane];
    fold<16>(c);
    fold<8>(c);
    fold<4>(c);
    fold<2>(c);
    fold<1>(c);
    buf[lane] = c[0];
  }
  __syncwarp();
}

// The Gauss-Newton warps' rendezvous: warps 0 and 1 alone (named barrier 1).
__device__ __forceinline__ void gn_barrier(int gw) {
  if (gw > 1) asm volatile("bar.sync 1, 64;" ::: "memory");
}

// One refinement round of `_gn_refine` on gw warps (1, or 2 above 32 points:
// thread pl < 32 gw owns points n = pl + 32 gw j, bit j), from pose T (the
// same in every lane of both warps), in place. The round's weights w are the
// inliers of T. Pass -1 sums the terms at T; pass `it` sums, at the trial
// pose T' of iteration it, its cost under the current weights wz = w * (z >
// 0) (the accept test) and all terms and inlier bits at T', which become
// current where T' is accepted. Each warp reduces its lanes' partials into
// its row of s_red (two parities, so a warp never overwrites a row the other
// still reads), the warps meet at one barrier, and every lane adds the rows
// in the same order: both warps hold the same sums, take the same steps and
// agree on T without further exchange. One pass body serves every pass and
// the loops stay rolled: the code a warp runs once costs its instruction
// fetch. Returns the thread's inlier bits of the final T.
__device__ __forceinline__ unsigned long long gn_round(float* T, const float* sx, const float* sy,
                                                       const float* smk, int N, float thr_sq,
                                                       int pl, int gw, float* s_part,
                                                       float (*s_red)[2][32], PhaseClock& clk) {
  const int lane = pl & 31, w_id = pl >> 5, stride = 32 * gw;
  unsigned long long w = 0ull, wz = 0ull, inl = 0ull;
  float S[kTrial + 1];  // the current sums: H's upper entries, g, cost
  float lam = kLambda0;
#pragma unroll 1
  for (int it = -1; it < kGnIters; ++it) {
    float Tn[16];
    bool finite = true;
    if (it < 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) Tn[k] = T[k];
    } else {
      gn_step(S, lam, T, Tn);
      finite = all_finite(Tn);
      clk.mark(kGnSolve);
    }
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    unsigned long long wzn = 0ull, inln = 0ull;
#pragma unroll 1
    for (int n = pl, j = 0; n < N; n += stride, ++j) {
      const Proj q = project(Tn, sx + n * 3, sy + n * 2);
      const bool in = q.err < thr_sq && smk[n] != 0.f;
      acc[kTrial] += (((wz >> j) & 1ull) ? 1.f : 0.f) * (q.r0 * q.r0 + q.r1 * q.r1);
      inln |= (unsigned long long)in << j;
      wzn |= (unsigned long long)add_terms(q, it < 0 ? in : ((w >> j) & 1ull), acc) << j;
    }
    float* row = s_red[(it + 1) & 1][w_id];
    reduce_sums(acc, s_part, row, lane);
    gn_barrier(gw);
    float St[kTrial + 1];
    const float* r0 = s_red[(it + 1) & 1][0];
    const float* r1 = s_red[(it + 1) & 1][1];
#pragma unroll
    for (int k = 0; k <= kTrial; ++k) St[k] = gw > 1 ? r0[k] + r1[k] : r0[k];
    clk.mark(kGnSums);
    if (it < 0) {  // the round's weights: the inliers of T
      w = inl = inln;
      wz = wzn;
#pragma unroll
      for (int k = 0; k <= kTrial; ++k) S[k] = St[k];
      continue;
    }
    const bool ok = St[kTrial] < S[27] && finite;
    if (ok) {
#pragma unroll
      for (int k = 0; k < 16; ++k) T[k] = Tn[k];
#pragma unroll
      for (int k = 0; k <= kTrial; ++k) S[k] = St[k];
      wz = wzn;
      inl = inln;
    }
    lam = ok ? lam * 0.33f : lam * 4.f;
    clk.mark(kAccept);
  }
  return inl;
}

// (a') The draws mode: hypothesis h's 4 point indices from its row ur of the
// draws u, as `hypothesis_indices_plain` picks them: the 4 points of largest
// u among the valid ones (smk), ties to the lower index. On the group's L =
// 2^lshift lanes: lane q0 keeps the top 4 of its points n = q0 + L k in
// registers, a sorted list (one pass over the row, read once, from L2, in
// batches of kRankBatch loads in flight together; a later point displaces
// an equal value only by exceeding it, its index being higher); then 4
// rounds take the best head of the group by shuffles
// (u descending, index ascending) and the lane that held it drops it. Once
// the row's valid points are exhausted every pick is 0 (the JAX contract:
// all scores -inf, the argmax ties to index 0). Draws are finite (uniform in
// [0, 1)). Every lane of the warp calls this (the shuffles); a lane of a
// group past the last hypothesis (active false) holds an empty list.
constexpr int kRankBatch = 8;  // draws a lane loads before it ranks them

__device__ __forceinline__ void rank_draws(const float* __restrict__ ur, const float* smk, int N,
                                           int q0, int lshift, bool active, int* id) {
  const int L = 1 << lshift;
  float v0 = -INFINITY, v1 = -INFINITY, v2 = -INFINITY, v3 = -INFINITY;
  int i0 = INT_MAX, i1 = INT_MAX, i2 = INT_MAX, i3 = INT_MAX;
  if (active) {
#pragma unroll 1
    for (int n0 = q0; n0 < N; n0 += kRankBatch * L) {
      float u[kRankBatch];  // a batch of loads in flight together, then the inserts
#pragma unroll
      for (int b = 0; b < kRankBatch; ++b) {
        const int n = n0 + b * L;
        u[b] = (n < N && smk[n] != 0.f) ? __ldg(ur + n) : -INFINITY;
      }
#pragma unroll
      for (int b = 0; b < kRankBatch; ++b) {
        const float v = u[b];
        if (v > v3) {  // insert, then bubble up past strictly smaller values
          v3 = v; i3 = n0 + b * L;
          if (v3 > v2) { const float a = v2; const int c = i2; v2 = v3; i2 = i3; v3 = a; i3 = c; }
          if (v2 > v1) { const float a = v1; const int c = i1; v1 = v2; i1 = i2; v2 = a; i2 = c; }
          if (v1 > v0) { const float a = v0; const int c = i0; v0 = v1; i0 = i1; v1 = a; i1 = c; }
        }
      }
    }
  }
  bool done = false;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float bv = v0;
    int bi = i0;
    for (int off = 1; off < L; off <<= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    done = done || bi == INT_MAX;  // no valid point left in the row
    id[r] = done ? 0 : bi;
    if (!done && bi == i0) {  // the lane that held the pick drops it
      v0 = v1; i0 = i1; v1 = v2; i1 = i2; v2 = v3; i2 = i3; v3 = -INFINITY; i3 = INT_MAX;
    }
  }
}

// One instance a mode (kDraws: the draws mode), so the rank code sits only
// in the draws instance: compiled into one kernel with both modes, the
// index mode ran slower after the network's forward (chip_smoke's
// `k15_frame_probe`: its Gauss-Newton phases colder), the same warm.
template <bool kDraws>
__global__ void __launch_bounds__(kThreads, 1)
pnp_ransac_kernel(const float* __restrict__ x, const float* __restrict__ yn,
                  const uint8_t* __restrict__ mask, const long long* __restrict__ idx,
                  const float* __restrict__ u, int N, int H, float thr_sq, int refine,
                  int lshift, float* __restrict__ T_out,
                  uint8_t* __restrict__ inl_out, long long* __restrict__ num_out,
                  uint8_t* __restrict__ succ_out, long long* __restrict__ cycles) {
  extern __shared__ float sm[];
  float* sx = sm;                 // [N, 3] x, then preconditioned in place
  float* sy = sm + 3 * N;         // [N, 2]
  float* smk = sm + 5 * N;        // [N]
  float* sxr = sm + 6 * N;        // [N, 3] x as given, for the final inliers
  float* sT = sm + 9 * N;         // [H, 12] each hypothesis's R and t
  int* scnt = reinterpret_cast<int*>(sT + kPoseFloats * H);  // [H] its count, -1: P3P failed
  __shared__ float s_cs[5];       // centroid, scale, valid count
  __shared__ float s_red[2][2][32];  // Gauss-Newton sums: [parity][warp][sum]
  __shared__ float s_part[2][32 * kPartStride];  // each Gauss-Newton warp's partial sums
  __shared__ int s_cnt3[2];       // each Gauss-Newton warp's inliers of the refined pose
  const int o = blockIdx.x;
  PhaseClock clk(cycles ? cycles + (long long)o * kPhases : nullptr);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xo = x + (long long)o * N * 3;
  const int n_valid = stage_and_precondition(xo, yn + (long long)o * N * 2,
                                             mask + (long long)o * N, N, sx, sy, smk, s_cs, sxr);
  clk.mark(kStage);

  // (b, c) per group of L = 2^lshift lanes (`plan_ransac`: 4 where every
  // hypothesis still fits one round), one hypothesis a group, inside its
  // warp: lane q0 solves P3P's candidates q0, q0 + L, ... in order keeping
  // the first of equal errors, the group takes the first minimum (ties to
  // the lower candidate, as a strictly smaller error replaces the best in
  // `p4p`) and writes the pose; then the same lanes count its inliers over
  // the points (n = q0 + L k) and sum the count by shuffles. A warp counts
  // only the hypotheses it solved, so no block barrier separates the two.
  {
    const int L = 1 << lshift, per = kThreads >> lshift;
    const int q0 = tid & (L - 1);
#pragma unroll 1
    for (int h0 = 0; h0 < H; h0 += per) {  // the same trips in every lane
      const int h = h0 + (tid >> lshift);
      float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f}, t[3] = {0.f, 0.f, 0.f};
      float best = INFINITY;
      int bq = q0;
      int id[4] = {-1, -1, -1, -1};
      if (kDraws) {  // every lane: the group ranks its row together
        rank_draws(u + ((long long)o * H + min(h, H - 1)) * N, smk, N, q0, lshift, h < H, id);
#pragma unroll
        for (int k = 0; k < 4; ++k) id[k] = id[k] < N ? id[k] : -1;  // N = 0: no point
      } else if (h < H) {
        const long long* ip = idx + ((long long)o * H + h) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) id[k] = (ip[k] < 0 || ip[k] >= N) ? -1 : (int)ip[k];
      }
      clk.mark(kRank);
      if (h < H) {
        float yb[3][3], xb[3][3];
        if (suo_pnp::gather_rows(sx, sy, N, id, yb, xb)) {
          suo_pnp::P3pPrefix P;
          suo_pnp::p3p_prefix(yb, xb, P);
          clk.mark(kP3pPrefix);
#pragma unroll 1
          for (int q = q0; q < 4; q += L) {
            float Rq[9], tq[3];
            const float err = suo_pnp::p3p_candidate(P, xb[0], q >> 1, q & 1, sx + id[3] * 3,
                                                     sy + id[3] * 2, Rq, tq);
            if (err < best) {
              best = err;
              bq = q;
#pragma unroll
              for (int k = 0; k < 9; ++k) R[k] = Rq[k];
#pragma unroll
              for (int k = 0; k < 3; ++k) t[k] = tq[k];
            }
          }
        }
      }
      for (int off = 1; off < L; off <<= 1) {
        const float oe = __shfl_xor_sync(kFull, best, off);
        const int oq = __shfl_xor_sync(kFull, bq, off);
        if (oe < best || (oe == best && oq < bq)) { best = oe; bq = oq; }
      }
      const bool ok = isfinite(best);
      float* Th = sT + (long long)min(h, H - 1) * kPoseFloats;
      // the lane that solved the winner writes it; lane 0 the identity where none is good
      if (h < H && (ok ? (bq & (L - 1)) == q0 : q0 == 0)) {
#pragma unroll
        for (int k = 0; k < 9; ++k) Th[k] = ok ? R[k] : ((k % 4 == 0) ? 1.f : 0.f);
#pragma unroll
        for (int k = 0; k < 3; ++k) Th[9 + k] = ok ? t[k] : 0.f;
      }
      __syncwarp();
      clk.mark(kP3p);
      int c = 0;
      if (h < H && ok) {
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Th[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = Th[9 + k];
#pragma unroll 1
        for (int n = q0; n < N; n += L) c += suo_pnp::is_inlier(sx, sy, smk, n, R, t, thr_sq) ? 1 : 0;
      }
      for (int off = 1; off < L; off <<= 1) c += __shfl_xor_sync(kFull, c, off);
      if (h < H && q0 == 0) scnt[h] = ok ? c : -1;
      clk.mark(kCounts);
    }
  }
  __syncthreads();
  // Gauss-Newton on one warp, two above 32 points; the rest are done. No
  // more block barriers: warps 0 and 1 meet at named barrier 1.
  const int gw = N > 32 ? 2 : 1;
  if (warp >= gw) return;

  // (d) the first maximum of the counts (in each Gauss-Newton warp alike)
  int top_cnt = INT_MIN, top_h = INT_MAX;
  for (int h = lane; h < H; h += 32)
    if (scnt[h] > top_cnt) { top_cnt = scnt[h]; top_h = h; }
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(kFull, top_cnt, off);
    const int oh = __shfl_xor_sync(kFull, top_h, off);
    if (oc > top_cnt || (oc == top_cnt && oh < top_h)) { top_cnt = oc; top_h = oh; }
  }
  float T[16];
  {
    const float* Th = sT + top_h * kPoseFloats;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) T[i * 4 + j] = Th[i * 3 + j];
      T[i * 4 + 3] = Th[9 + i];
    }
    T[12] = 0.f; T[13] = 0.f; T[14] = 0.f; T[15] = 1.f;
  }
  bool success = n_valid >= 4 && top_cnt >= 4;
  clk.mark(kArgmax);

  // (e) two refinement rounds, each from the inliers of the current pose,
  // then the keep gate: the refined pose only if no inlier was lost
  if (refine && success) {
    float Tr[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) Tr[k] = T[k];
    unsigned long long inl = 0ull;
    for (int r = 0; r < kRounds; ++r)
      inl = gn_round(Tr, sx, sy, smk, N, thr_sq, tid, gw, s_part[warp], s_red, clk);
    const int cw = warp_sum_int(__popcll(inl));
    if (lane == 0) s_cnt3[warp] = cw;
    gn_barrier(gw);
    const int cnt3 = gw > 1 ? s_cnt3[0] + s_cnt3[1] : cw;
    if (cnt3 >= top_cnt && all_finite(Tr))
#pragma unroll
      for (int k = 0; k < 16; ++k) T[k] = Tr[k];
    clk.mark(kAccept);
  }

  // (f) on warp 0
  if (warp != 0) return;
  finish(T, success, s_cs, sxr, sy, smk, N, thr_sq, o, T_out, inl_out, num_out, succ_out);
  clk.mark(kFinal);
}

// ----------------------------------------------------------------- serial --

// `_gn_refine` on warp 0 in the serial design: 8 damped Gauss-Newton
// iterations on the points whose bit is set in w (a lane's points n = lane +
// 32 j), from pose T (the same in every lane), in place; each sum by its own
// butterfly, the trial cost by a second pass.
__device__ __forceinline__ void gn_refine_serial(float* T, const float* sx, const float* sy, int N,
                                 unsigned long long w, int lane, PhaseClock& clk) {
  float lam = kLambda0;
  for (int it = 0; it < kGnIters; ++it) {
    float acc[kSums];
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    unsigned long long wz_bits = 0ull;
    for (int n = lane, j = 0; n < N; n += 32, ++j) {
      const bool wz = add_terms(project(T, sx + n * 3, sy + n * 2), (w >> j) & 1ull, acc);
      wz_bits |= (unsigned long long)wz << j;
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = warp_sum(acc[k]);
    clk.mark(kGnSums);
    float Tn[16];
    gn_step(acc, lam, T, Tn);
    clk.mark(kGnSolve);
    float part = 0.f;
    for (int n = lane, j = 0; n < N; n += 32, ++j) {
      const Proj q = project(Tn, sx + n * 3, sy + n * 2);
      part += (((wz_bits >> j) & 1ull) ? 1.f : 0.f) * (q.r0 * q.r0 + q.r1 * q.r1);
    }
    const float cost2 = warp_sum(part);
    const bool ok = cost2 < acc[27] && all_finite(Tn);
    if (ok)
      for (int k = 0; k < 16; ++k) T[k] = Tn[k];
    lam = ok ? lam * 0.33f : lam * 4.f;
    clk.mark(kAccept);
  }
}

// The inlier bits of a lane's points (n = lane + 32 j) under pose T, and
// their count over the warp.
__device__ __forceinline__ unsigned long long inlier_bits(const float* T, const float* sx,
                                                          const float* sy, const float* smk,
                                                          int N, float thr_sq, int lane,
                                                          int& count) {
  unsigned long long bits = 0ull;
  int c = 0;
  for (int n = lane, j = 0; n < N; n += 32, ++j) {
    const bool in = project(T, sx + n * 3, sy + n * 2).err < thr_sq && smk[n] != 0.f;
    bits |= (unsigned long long)in << j;
    c += in ? 1 : 0;
  }
  count = warp_sum_int(c);
  return bits;
}

__global__ void pnp_ransac_serial_kernel(const float* __restrict__ x,
                                         const float* __restrict__ yn,
                                         const uint8_t* __restrict__ mask,
                                         const long long* __restrict__ idx, int N, int H,
                                         float thr_sq, int refine, float* __restrict__ T_out,
                                         uint8_t* __restrict__ inl_out,
                                         long long* __restrict__ num_out,
                                         uint8_t* __restrict__ succ_out,
                                         long long* __restrict__ cycles) {
  extern __shared__ float sm[];
  float* sx = sm;
  float* sy = sm + 3 * N;
  float* smk = sm + 5 * N;
  __shared__ float s_cs[5];
  __shared__ int s_cnt[kSerialMaxWarps], s_h[kSerialMaxWarps];
  __shared__ float s_T[16];   // the best hypothesis's pose
  const int o = blockIdx.x;
  PhaseClock clk(cycles ? cycles + (long long)o * kPhases : nullptr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xo = x + (long long)o * N * 3;
  const int n_valid = stage_and_precondition(xo, yn + (long long)o * N * 2,
                                             mask + (long long)o * N, N, sx, sy, smk, s_cs);
  clk.mark(kStage);

  // a thread per hypothesis, its count in series; each thread keeps its first maximum
  int best_cnt = INT_MIN, best_h = INT_MAX;
  float bR[9], bt[3];
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const long long* ip = idx + ((long long)o * H + h) * 4;
    int id[4];
    for (int k = 0; k < 4; ++k) id[k] = (ip[k] < 0 || ip[k] >= N) ? -1 : (int)ip[k];
    clk.mark(kRank);
    float R[9], t[3];
    const bool ok = suo_pnp::solve_pose(sx, sy, N, id, R, t);
    clk.mark(kP3p);
    const int all = suo_pnp::count_inliers(sx, sy, smk, N, R, t, thr_sq);
    const int cnt = ok ? all : -1;
    clk.mark(kCounts);
    if (cnt > best_cnt) {
      best_cnt = cnt;
      best_h = h;
      for (int k = 0; k < 9; ++k) bR[k] = R[k];
      for (int k = 0; k < 3; ++k) bt[k] = t[k];
    }
  }

  // the block's first maximum: the warps' winners, then theirs
  int wc = best_cnt, wh = best_h;
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(kFull, wc, off);
    const int oh = __shfl_xor_sync(kFull, wh, off);
    if (oc > wc || (oc == wc && oh < wh)) { wc = oc; wh = oh; }
  }
  if (lane == 0) { s_cnt[warp] = wc; s_h[warp] = wh; }
  __syncthreads();
  int top_cnt = s_cnt[0], top_h = s_h[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (s_cnt[w] > top_cnt || (s_cnt[w] == top_cnt && s_h[w] < top_h)) {
      top_cnt = s_cnt[w];
      top_h = s_h[w];
    }
  if (best_h == top_h) {  // the thread that solved the winner
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_T[i * 4 + j] = bR[i * 3 + j];
      s_T[i * 4 + 3] = bt[i];
    }
    s_T[12] = 0.f; s_T[13] = 0.f; s_T[14] = 0.f; s_T[15] = 1.f;
  }
  __syncthreads();
  clk.mark(kArgmax);
  if (warp != 0) return;

  float T[16];
  for (int k = 0; k < 16; ++k) T[k] = s_T[k];
  bool success = n_valid >= 4 && top_cnt >= 4;
  if (refine && success) {
    float Tr[16];
    for (int k = 0; k < 16; ++k) Tr[k] = T[k];
    for (int r = 0; r < kRounds; ++r) {
      int cnt;
      const unsigned long long w = inlier_bits(Tr, sx, sy, smk, N, thr_sq, lane, cnt);
      clk.mark(kGnSums);
      gn_refine_serial(Tr, sx, sy, N, w, lane, clk);
    }
    int cnt3;
    inlier_bits(Tr, sx, sy, smk, N, thr_sq, lane, cnt3);
    if (cnt3 >= top_cnt && all_finite(Tr))
      for (int k = 0; k < 16; ++k) T[k] = Tr[k];
    clk.mark(kAccept);
  }
  finish(T, success, s_cs, xo, sy, smk, N, thr_sq, o, T_out, inl_out, num_out, succ_out);
  clk.mark(kFinal);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// hypotheses: idx (int64 [O, H, 4]) or, where idx is null, the draws u
// (f32 [O, H, N]); lshift: log2 of the lanes per hypothesis; shmem the
// dynamic shared memory (both from `solvers/pnp.py` `plan_ransac`)
extern "C" int suo_pnp_ransac(const void* x, const void* yn, const void* mask, const void* idx,
                              const void* u, int O, int N, int H, float thr_sq, int refine,
                              int lshift, int shmem, void* T_out, void* inl_out, void* num_out,
                              void* succ_out, void* cycles, void* stream) {
  if (O > 0 && H > 0) {
    const auto kernel = idx ? pnp_ransac_kernel<false> : pnp_ransac_kernel<true>;
    const cudaError_t e = allow_smem(kernel, (size_t)shmem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<O, kThreads, shmem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)yn, (const uint8_t*)mask, (const long long*)idx,
        (const float*)u, N, H, thr_sq, refine, lshift, (float*)T_out, (uint8_t*)inl_out,
        (long long*)num_out, (uint8_t*)succ_out, (long long*)cycles);
  }
  return (int)cudaGetLastError();
}

extern "C" int suo_pnp_ransac_serial(const void* x, const void* yn, const void* mask,
                                     const void* idx, int O, int N, int H, float thr_sq,
                                     int refine, void* T_out, void* inl_out, void* num_out,
                                     void* succ_out, void* cycles, void* stream) {
  if (O > 0 && H > 0) {
    const int threads = H >= kSerialMaxThreads ? kSerialMaxThreads : ((H + 31) / 32) * 32;
    const size_t shmem = (size_t)6 * N * sizeof(float);
    const cudaError_t e = allow_smem(pnp_ransac_serial_kernel, shmem);
    if (e != cudaSuccess) return (int)e;
    pnp_ransac_serial_kernel<<<O, threads, shmem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)yn, (const uint8_t*)mask, (const long long*)idx, N, H,
        thr_sq, refine, (float*)T_out, (uint8_t*)inl_out, (long long*)num_out,
        (uint8_t*)succ_out, (long long*)cycles);
  }
  return (int)cudaGetLastError();
}
