"""Vectorized PnP RANSAC with Gauss-Newton refinement — kernels K3, K15 and
K22.

Port of `suo_slam_tpu/solvers/pnp.py` over a leading object axis:

  1. a fixed batch of n_hyp 4-point hypotheses per object, as Gumbel top-4
     on a `torch.Generator` (torch cannot reproduce the `jax.random`
     stream): the hypotheses reach `pnp_ransac_batch` either as the draws
     (`Draws`: `sample_draws`, one `torch.rand` [O, n_hyp, N]; K15 ranks
     them itself) or as explicit indices `idx [O, n_hyp, 4]`
     (`sample_hypothesis_indices`: the same draws ranked by
     `hypothesis_indices`, on a CUDA tensor one launch of kernel K22,
     `csrc/pnp_sample.cu`, off the main path; or any injected sampler's),
  2. every hypothesis solved by P4P and scored against every point,
  3. the best hypothesis polished by two damped Gauss-Newton rounds with
     inlier reselection, kept only if no inliers are lost.

`pnp_ransac_batch` runs steps 2-3 — with draws, the ranking of step 1 too —
as one launch of kernel K15 (`csrc/pnp_ransac.cu`, one block per object) on
CUDA tensors, and as `pnp_ransac_batch_plain` — plain PyTorch, step 2 by K3's
plain version, draws ranked by `hypothesis_indices_plain` — on CPU tensors. `pnp_hypotheses` (step 2 alone: kernel K3, `csrc/pnp_hypotheses.cu`,
on a CUDA tensor) stays as an entry point off the main path; K3 and K15 share
its solver (`csrc/pnp_common.cuh`).

3D points are centroid/scale preconditioned for f32; identity is returned on
failure (fewer than 4 valid points, no hypothesis with 4 inliers, or a
non-finite solve).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie
from ..kernels import _build
from . import p3p as p3p_mod

DEFAULT_HYPOTHESES = 128
DEFAULT_THRESHOLD = 1e-3
REFINE_GN_ITERS = 8


class Draws(NamedTuple):
    """A sampler's hypotheses as its draws: u [O, n_hyp, N] (or [n_hyp, N]
    for `pnp_ransac`), f32 uniform in [0, 1) as `torch.rand` gives them.
    Hypothesis h of object o is the 4 points of largest u[o, h] among those
    valid under the PnP call's mask (`hypothesis_indices_plain`): the ranking
    happens inside `pnp_ransac_batch` (in K15 on the card), so the sampler
    must draw for the mask that call gets."""
    u: torch.Tensor


class PnpResult(NamedTuple):
    T: torch.Tensor            # [O, 4, 4] camera-from-model pose
    inliers: torch.Tensor      # [O, N] bool
    num_inliers: torch.Tensor  # [O] int
    success: torch.Tensor      # [O] bool


def _precondition(x: torch.Tensor, mask: torch.Tensor):
    """Center + scale [..., N, 3] points to unit RMS over the valid set.
    Returns (x', c [..., 3], s [...]).

    The sums run in f64 and each statistic is rounded once to x's dtype: a
    sum of a few dozen f32 terms is exact in f64, so c and s do not depend
    on the order of the sums, and K15 (`csrc/pnp_ransac.cu`) computes them
    bit for bit. An ulp of c or s moves a hypothesis's inlier count at the
    threshold's edge and with it the argmax."""
    m = mask.to(x.dtype)[..., None]
    n = torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0).double()
    c = (torch.sum((x * m).double(), dim=-2) / n[..., None]).to(x.dtype)
    xc = (x - c[..., None, :]) * m
    ss = torch.sum((xc * xc).double(), dim=(-2, -1)) / n
    s = torch.sqrt(torch.clamp(ss, min=1e-12)).to(x.dtype)
    return (x - c[..., None, :]) / s[..., None, None], c, s


def _unprecondition(T: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """Pose for raw x from the pose for x' = (x - c) / s: (R, s t - R c)."""
    R = T[..., :3, :3]
    t = s[..., None] * T[..., :3, 3] - (R @ c[..., None])[..., 0]
    out = T.clone()
    out[..., :3, 3] = t
    return out


def _reproj_sq_err(T: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Squared normalized-plane reprojection error of [..., N] points under
    [..., 4, 4] poses; behind-camera points get +inf. Returns (err, z)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    p = [x[..., 0] * R[..., i, 0, None] + x[..., 1] * R[..., i, 1, None]
         + x[..., 2] * R[..., i, 2, None] + t[..., i, None] for i in range(3)]
    z = p[2]
    iz = 1.0 / p3p_mod._nz(z)
    du = p[0] * iz - y[..., 0]
    dv = p[1] * iz - y[..., 1]
    err = du * du + dv * dv
    return torch.where(z > 0, err, torch.inf), z


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form [..., 3, 3] inverse (adjugate over determinant)."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1)
    idet = 1.0 / p3p_mod._nz(det)
    return torch.stack([c0, c1, c2], dim=-1) * idet[..., None, None]


def _solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve damped SPD [..., 6, 6] normal equations by 3x3-blocked Schur
    elimination with closed-form 3x3 inverses."""
    A, B, D = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    Bt = B.transpose(-1, -2)
    Ai = _inv3(A)
    S = D - Bt @ (Ai @ B)
    Si = _inv3(S)
    g1, g2 = g[..., :3, None], g[..., 3:, None]
    x2 = Si @ (g2 - Bt @ (Ai @ g1))
    x1 = Ai @ (g1 - B @ x2)
    return torch.cat([x1, x2], dim=-2)[..., 0]


def _gn_refine(T0, x, y, w, iters: int = REFINE_GN_ITERS):
    """Damped Gauss-Newton on SE(3) (left update T <- exp(delta) T) of the
    w-weighted normalized reprojection error, batched over [O]."""
    dtype = T0.dtype
    eye3 = torch.eye(3, dtype=dtype, device=T0.device)
    eye6 = torch.eye(6, dtype=dtype, device=T0.device)

    def resid(T):
        p = x @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
        z = p[..., 2]
        iz = 1.0 / p3p_mod._nz(z)
        r = torch.stack([p[..., 0] * iz - y[..., 0], p[..., 1] * iz - y[..., 1]], -1)
        return p, z, iz, r

    T = T0
    lam = torch.full(T0.shape[:-2], 1e-4, dtype=dtype, device=T0.device)
    for _ in range(iters):
        p, z, iz, r = resid(T)
        u, v = p[..., 0] * iz, p[..., 1] * iz
        zeros = torch.zeros_like(iz)
        Jproj = torch.stack([
            torch.stack([iz, zeros, -u * iz], -1),
            torch.stack([zeros, iz, -v * iz], -1),
        ], dim=-2)  # [..., N, 2, 3]
        Jp = torch.cat([-lie.hat(p), eye3.expand(p.shape[:-1] + (3, 3))], dim=-1)
        J = Jproj @ Jp  # [..., N, 2, 6]
        wz = w * (z > 0)
        JW = J * wz[..., None, None]
        H = torch.einsum("...nik,...nil->...kl", JW, J)
        g = torch.einsum("...nik,...ni->...k", JW, r)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + (lam * torch.clamp(tr / 6.0, min=1e-12))[..., None, None] * eye6
        delta = -_solve6_spd(H, g)
        T_new = lie.se3_exp(delta) @ T
        cost = torch.sum(wz * torch.sum(r * r, -1), -1)
        _, _, _, r2 = resid(T_new)
        cost2 = torch.sum(wz * torch.sum(r2 * r2, -1), -1)
        ok = (cost2 < cost) & torch.isfinite(T_new).flatten(-2).all(-1)
        T = torch.where(ok[..., None, None], T_new, T)
        lam = torch.where(ok, lam * 0.33, lam * 4.0)
    return T


def sample_draws(mask: torch.Tensor, n_hyp: int,
                 generator: torch.Generator | None = None) -> Draws:
    """The Gumbel top-4 sampler's draws for mask [O, N]: one `torch.rand`
    u [O, n_hyp, N] on `generator` (on the mask's device)."""
    O, n = mask.shape
    return Draws(torch.rand((O, n_hyp, n), generator=generator, device=mask.device))


def sample_hypothesis_indices(mask: torch.Tensor, n_hyp: int,
                              generator: torch.Generator | None = None):
    """[O, n_hyp, 4] int64 indices of valid points by Gumbel top-4: the draws
    of `sample_draws`, ranked by `hypothesis_indices` (kernel K22 on a CUDA
    mask).

    Same contract as the JAX sampler: distinct indices while at least 4
    points are valid; exhausted picks return index 0 (all scores -inf), which
    `pnp_ransac_batch` tolerates because it gates on n_valid >= 4."""
    return hypothesis_indices(sample_draws(mask, n_hyp, generator).u, mask)


def hypothesis_indices_plain(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K22: u [O, n_hyp, N] uniform draws, mask [O, N] ->
    [O, n_hyp, 4] int64, the 4 valid points of largest u per row in order.

    The JAX sampler ranks Gumbel scores -log(-log(u)); that map is strictly
    increasing, so ranking u itself picks the same ordered sets with no
    transcendental (and K22 equals this bit for bit). Masked points and picks
    already taken score -inf, not a sentinel such as -1: once a row's valid
    points are exhausted every score is -inf and argmax ties to index 0, the
    JAX contract, where a finite sentinel would pick a masked point. Ties go
    to the lowest index."""
    scores = torch.where(mask[:, None, :].bool(), u, -torch.inf)
    idxs = []
    for _ in range(4):
        i = torch.argmax(scores, dim=-1)
        idxs.append(i)
        scores = scores.scatter(-1, i[..., None], -torch.inf)
    return torch.stack(idxs, dim=-1)


K22_MAX_POINTS = 2048  # K15_MAX_POINTS; 64 values a lane in registers (`csrc/pnp_sample.cu`)
_K22_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _hypothesis_indices_cuda(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K22 (`csrc/pnp_sample.cu`, one warp per row): f32 u, 1 <= N <=
    K22_MAX_POINTS. Raises on what the kernel does not take."""
    O, N = mask.shape
    H = u.shape[1] if u.dim() == 3 else 0
    if u.shape != (O, H, N):
        raise ValueError(f"K22 shapes: u {tuple(u.shape)} mask {tuple(mask.shape)}")
    if u.dtype != torch.float32:
        raise ValueError(f"K22 ranks f32 draws, got {u.dtype}")
    if not 1 <= N <= K22_MAX_POINTS:
        raise ValueError(f"K22 takes 1 to {K22_MAX_POINTS} points, got {N}")
    dev = u.device
    if dev.type != "cuda" or mask.device != dev:
        raise ValueError("K22 inputs must lie on one CUDA device")
    uc = u.contiguous()
    mk = mask.bool().contiguous().view(torch.uint8)
    out = torch.empty((O, H, 4), dtype=torch.int64, device=dev)
    fn = _build.entry("pnp_sample", _K22_ARGTYPES)
    err = fn(_build.ptr(uc), _build.ptr(mk), O, H, N, _build.ptr(out), _build.stream())
    _build.check(err, "K22 pnp_sample")
    kernels.count("pnp_sample")
    return out


def hypothesis_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank the draws u [O, n_hyp, N] into [O, n_hyp, 4] hypothesis indices
    (see `hypothesis_indices_plain`): K22 on CUDA tensors, the plain version
    on CPU tensors."""
    if u.device.type == "cpu":
        return hypothesis_indices_plain(u, mask)
    if u.device.type != "cuda":
        raise ValueError(f"hypothesis_indices: unsupported device {u.device}")
    return _hypothesis_indices_cuda(u, mask)


def pnp_hypotheses_plain(xp, y, mask, idx, thr_sq):
    """Plain PyTorch K3. xp [O, N, 3] preconditioned points, y [O, N, 2],
    mask [O, N], idx [O, H, 4] -> (T [O, H, 4, 4], ok [O, H],
    counts [O, H] int32, -1 where the P4P failed)."""
    idx = idx.long()
    O, H = idx.shape[:2]
    flat = idx.reshape(O, H * 4)
    x4 = torch.gather(xp, 1, flat[..., None].expand(O, H * 4, 3)).reshape(O, H, 4, 3)
    y4 = torch.gather(y, 1, flat[..., None].expand(O, H * 4, 2)).reshape(O, H, 4, 2)
    Ts, _, ok = p3p_mod.p4p(y4, x4)
    err, _ = _reproj_sq_err(Ts, xp[:, None], y[:, None])  # [O, H, N]
    inl = (err < thr_sq) & mask[:, None, :].bool()
    counts = torch.where(ok, inl.sum(-1), -1).to(torch.int32)
    return Ts, ok, counts


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_void_p] * 4)


def _pnp_hypotheses_cuda(xp, y, mask, idx, thr_sq):
    if xp.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("K3 runs in f32")
    O, N = mask.shape
    H = idx.shape[1]
    if xp.shape != (O, N, 3) or y.shape != (O, N, 2) or idx.shape != (O, H, 4):
        raise ValueError(f"K3 shapes: xp {tuple(xp.shape)} y {tuple(y.shape)} "
                         f"mask {tuple(mask.shape)} idx {tuple(idx.shape)}")
    if int(6 * N * 4) > 48 * 1024:
        raise ValueError(f"K3 stages at most {48 * 1024 // 24} points, got {N}")
    dev = xp.device
    if any(a.device != dev for a in (y, mask, idx)):
        raise ValueError("K3 inputs must lie on one CUDA device")
    xpc = xp.contiguous()
    yc = y.contiguous()
    mk = mask.to(torch.uint8).contiguous()
    ix = idx.to(torch.int32).contiguous()
    T = torch.empty((O, H, 4, 4), dtype=torch.float32, device=dev)
    ok = torch.empty((O, H), dtype=torch.uint8, device=dev)
    counts = torch.empty((O, H), dtype=torch.int32, device=dev)
    fn = _build.entry("pnp_hypotheses", _ARGTYPES)
    err = fn(_build.ptr(xpc), _build.ptr(yc), _build.ptr(mk), _build.ptr(ix),
             O, N, H, float(thr_sq), _build.ptr(T), _build.ptr(ok),
             _build.ptr(counts), _build.stream())
    _build.check(err, "K3 pnp_hypotheses")
    kernels.count("pnp_hypotheses")
    return T, ok.bool(), counts


def pnp_hypotheses(xp, y, mask, idx, thr_sq: float):
    """Solve and score every hypothesis: K3 on CUDA tensors, the plain
    version on CPU tensors. See `pnp_hypotheses_plain`."""
    if xp.device.type == "cpu":
        return pnp_hypotheses_plain(xp, y, mask, idx, thr_sq)
    if xp.device.type != "cuda":
        raise ValueError(f"pnp_hypotheses: unsupported device {xp.device}")
    return _pnp_hypotheses_cuda(xp, y, mask, idx, thr_sq)


def pnp_ransac_batch_plain(x, y, mask, hyp, threshold: float = DEFAULT_THRESHOLD,
                           refine: bool = True, use_kernels: bool = False) -> PnpResult:
    """Plain PyTorch K15: robust PnP for a batch of objects from padded
    correspondences (see `pnp_ransac_batch`). `Draws` are ranked by
    `hypothesis_indices_plain`. The hypotheses run on K3's plain version, or
    with `use_kernels` through `pnp_hypotheses` (K3 on a CUDA tensor: the
    schedule K15 replaced, kept for comparison)."""
    dtype = x.dtype
    mask = mask.bool()
    idx = hypothesis_indices_plain(hyp.u, mask) if isinstance(hyp, Draws) else hyp
    feasible = mask.sum(-1) >= 4
    xp, c, s = _precondition(x, mask)
    thr_sq = float(threshold) ** 2

    hyp = pnp_hypotheses if use_kernels else pnp_hypotheses_plain
    Ts, _, counts = hyp(xp, y, mask, idx, thr_sq)
    best = torch.argmax(counts, dim=-1)  # first maximum
    ar = torch.arange(x.shape[0], device=x.device)
    T_best = Ts[ar, best].to(dtype)
    best_count = counts[ar, best]
    success = feasible & (best_count >= 4)

    if refine:
        err, _ = _reproj_sq_err(T_best, xp, y)
        w = ((err < thr_sq) & mask).to(dtype)
        T_ref = _gn_refine(T_best, xp, y, w)
        err2, _ = _reproj_sq_err(T_ref, xp, y)
        w2 = ((err2 < thr_sq) & mask).to(dtype)
        T_ref = _gn_refine(T_ref, xp, y, w2)
        err3, _ = _reproj_sq_err(T_ref, xp, y)
        cnt3 = torch.sum((err3 < thr_sq) & mask, -1)
        use = (cnt3 >= best_count) & torch.isfinite(T_ref).flatten(-2).all(-1)
        T_best = torch.where(use[:, None, None], T_ref, T_best)

    T_out = _unprecondition(T_best, c, s)
    err_f, _ = _reproj_sq_err(T_out, x, y)
    inliers = (err_f < thr_sq) & mask
    num = torch.sum(inliers, -1)
    success = success & torch.isfinite(T_out).flatten(-2).all(-1)
    eye = torch.eye(4, dtype=dtype, device=x.device)
    T_out = torch.where(success[:, None, None], T_out, eye)
    inliers = inliers & success[:, None]
    return PnpResult(T=T_out, inliers=inliers,
                     num_inliers=torch.where(success, num, 0), success=success)


K15_MAX_POINTS = 2048  # 36 B of shared memory per staged point; 64 bits of round weights per lane
# K15's phases, in the order of its `cycles` rows (`csrc/pnp_ransac.cu` `Phase`)
# ("rank": a hypothesis's 4 indices, ranked from the draws or read)
PNP_PHASES = ("stage", "rank", "p3p_prefix", "p3p", "counts", "argmax", "gn_sums", "gn_solve",
              "accept", "final")
K15_THREADS = 256         # kThreads
K15_POSE_FLOATS = 12      # kPoseFloats: R and t of a hypothesis in shared memory
K15_P3P_LANES = 4         # at most a lane per P3P candidate (kept per hypothesis for its count)
K15_STATIC_SMEM = 4 * (5 + 2 * 2 * 32 + 2 * 32 * 33 + 2)  # s_cs, s_red, s_part, s_cnt3
SMEM_PER_BLOCK = 232448   # an H100 block's shared memory


class RansacPlan(NamedTuple):
    """K15's launch geometry (`csrc/pnp_ransac.cu` `pnp_ransac_kernel`, one
    block of `threads` per object): a group of `lanes` lanes per hypothesis,
    threads / lanes hypotheses a round over `rounds` rounds (h = round *
    threads / lanes + thread / lanes). Lane q0 of a group solves P3P's
    candidates q0, q0 + lanes, ..., then counts the hypothesis's inliers
    over points n = q0 + lanes * k. `shared_bytes`: the dynamic shared
    memory (points preconditioned and as given, poses, counts)."""
    threads: int
    lanes: int
    rounds: int
    shared_bytes: int


@functools.lru_cache(maxsize=64)
def plan_ransac(n_hyp: int, N: int) -> RansacPlan:
    """K15's plan for n_hyp hypotheses over N points: as many lanes per
    hypothesis (at most one per P3P candidate) as one round over every
    hypothesis allows. Raises on what it cannot take."""
    if n_hyp < 1 or N < 0:
        raise ValueError(f"K15 needs a hypothesis and N >= 0, got n_hyp {n_hyp}, N {N}")
    if N > K15_MAX_POINTS:
        raise ValueError(f"K15 stages at most {K15_MAX_POINTS} points, got {N}")
    lanes = K15_P3P_LANES
    while lanes > 1 and n_hyp * lanes > K15_THREADS:
        lanes //= 2
    shared = 4 * (9 * N + (K15_POSE_FLOATS + 1) * n_hyp)
    if shared + K15_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"K15 holds at most {SMEM_PER_BLOCK} bytes of shared memory a block: "
                         f"{n_hyp} hypotheses over {N} points need {shared + K15_STATIC_SMEM}")
    return RansacPlan(K15_THREADS, lanes, -(-n_hyp // (K15_THREADS // lanes)), shared)


_K15_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
_K15_SERIAL_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 6)


def _pnp_ransac_cuda(x, y, mask, hyp, threshold: float = DEFAULT_THRESHOLD,
                     refine: bool = True, cycles: torch.Tensor | None = None,
                     serial: bool = False) -> PnpResult:
    """K15: `pnp_ransac_batch` in one launch (f32, N <= K15_MAX_POINTS), on
    `plan_ransac`'s geometry. hyp: `Draws` (the draws mode: each hypothesis
    group ranks its row of u under the mask, `hypothesis_indices_plain`'s
    picks) or int64 indices [O, n_hyp, 4]. With `cycles` (int64
    [O, len(PNP_PHASES)] on the card) each block adds its SM clock cycles
    per phase there; `serial` launches the earlier design
    (`pnp_ransac_serial_kernel`, indices only), kept for comparison. Raises
    on what the kernel does not take; never falls back."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"K15 runs in f32, got {x.dtype} / {y.dtype}")
    O, N = mask.shape
    draws = isinstance(hyp, Draws)
    h = hyp.u if draws else hyp
    H = h.shape[1] if h.dim() == 3 else 0
    if (x.shape != (O, N, 3) or y.shape != (O, N, 2)
            or h.shape != ((O, H, N) if draws else (O, H, 4)) or min(O, H) < 1):
        raise ValueError(f"K15 shapes: x {tuple(x.shape)} y {tuple(y.shape)} "
                         f"mask {tuple(mask.shape)} {'u' if draws else 'idx'} {tuple(h.shape)}")
    if draws and (h.dtype != torch.float32 or serial):
        raise ValueError(f"K15 ranks f32 draws in its current design, got {h.dtype}"
                         f"{' (serial)' if serial else ''}")
    plan = plan_ransac(H, N)
    dev = x.device
    if dev.type != "cuda" or any(a.device != dev for a in (y, mask, h)):
        raise ValueError("K15 inputs must lie on one CUDA device")
    xc, yc = x.contiguous(), y.contiguous()
    # the engine's bool mask, int64 indices and f32 draws pass as they are:
    # no conversion (each bound to a name until the launch)
    mk = mask.bool().contiguous().view(torch.uint8)
    hc = h.contiguous() if draws else h.long().contiguous()
    T = torch.empty((O, 4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty((O, N), dtype=torch.bool, device=dev)
    num = torch.empty((O,), dtype=torch.int64, device=dev)
    success = torch.empty((O,), dtype=torch.bool, device=dev)
    if cycles is not None and (cycles.shape != (O, len(PNP_PHASES)) or cycles.dtype != torch.int64
                               or cycles.device != dev):
        raise ValueError(f"K15 cycles: int64 [{O}, {len(PNP_PHASES)}] on {dev}")
    p = _build.ptr
    ix, u = (None, p(hc)) if draws else (p(hc), None)
    rest = (O, N, H, float(threshold) ** 2, int(bool(refine)))
    outs = (p(T), p(inliers), p(num), p(success), None if cycles is None else p(cycles),
            _build.stream())
    if serial:
        fn = _build.entry("pnp_ransac", _K15_SERIAL_ARGTYPES, "suo_pnp_ransac_serial")
        err = fn(p(xc), p(yc), p(mk), ix, *rest, *outs)
    else:
        fn = _build.entry("pnp_ransac", _K15_ARGTYPES)
        err = fn(p(xc), p(yc), p(mk), ix, u, *rest, plan.lanes.bit_length() - 1,
                 plan.shared_bytes, *outs)
    _build.check(err, "K15 pnp_ransac")
    kernels.count("pnp_ransac")
    return PnpResult(T=T, inliers=inliers, num_inliers=num, success=success)


def pnp_ransac_batch(x, y, mask, hyp, threshold: float = DEFAULT_THRESHOLD,
                     refine: bool = True) -> PnpResult:
    """Robust PnP for a batch of objects from padded correspondences.

    x [O, N, 3] model points, y [O, N, 2] pinhole-normalized image points,
    mask [O, N] validity; hyp the hypotheses: `Draws` u [O, n_hyp, N]
    (ranked under mask, `hypothesis_indices_plain`) or point indices
    idx [O, n_hyp, 4]. K15 (one launch, either input) on CUDA tensors,
    `pnp_ransac_batch_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return pnp_ransac_batch_plain(x, y, mask, hyp, threshold, refine)
    if x.device.type != "cuda":
        raise ValueError(f"pnp_ransac_batch: unsupported device {x.device}")
    return _pnp_ransac_cuda(x, y, mask, hyp, threshold, refine)


def pnp_ransac(x, y, mask, hyp, threshold: float = DEFAULT_THRESHOLD,
               refine: bool = True) -> PnpResult:
    """Robust PnP of one point set: x [N, 3], y [N, 2], mask [N] and the
    hypotheses, `Draws` u [n_hyp, N] or indices idx [n_hyp, 4] (the JAX
    `pnp_ransac` draws DEFAULT_HYPOTHESES = 128 from one whole key).
    `pnp_ransac_batch` with a batch of one; the result's fields drop the
    batch axis."""
    hyp = Draws(hyp.u[None]) if isinstance(hyp, Draws) else hyp[None]
    r = pnp_ransac_batch(x[None], y[None], mask[None], hyp, threshold, refine)
    return PnpResult(T=r.T[0], inliers=r.inliers[0], num_inliers=r.num_inliers[0],
                     success=r.success[0])
