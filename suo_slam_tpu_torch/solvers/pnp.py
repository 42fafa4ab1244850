"""Vectorized PnP RANSAC with Gauss-Newton refinement — kernel K3's home.

Port of `suo_slam_tpu/solvers/pnp.py` over a leading object axis:

  1. a fixed batch of n_hyp 4-point hypotheses per object (explicit
     `idx [O, n_hyp, 4]`; `sample_hypothesis_indices` draws them as Gumbel
     top-4 on a `torch.Generator`, since torch cannot reproduce the
     `jax.random` stream),
  2. every hypothesis solved by P4P and scored against every point —
     `pnp_hypotheses`, kernel K3 on a CUDA tensor, its plain version on a
     CPU tensor,
  3. the best hypothesis polished by two damped Gauss-Newton rounds with
     inlier reselection, kept only if no inliers are lost (plain PyTorch).

3D points are centroid/scale preconditioned for f32; identity is returned on
failure (fewer than 4 valid points, no hypothesis with 4 inliers, or a
non-finite solve).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie
from ..kernels import _build
from . import p3p as p3p_mod

DEFAULT_HYPOTHESES = 128
DEFAULT_THRESHOLD = 1e-3
REFINE_GN_ITERS = 8


class PnpResult(NamedTuple):
    T: torch.Tensor            # [O, 4, 4] camera-from-model pose
    inliers: torch.Tensor      # [O, N] bool
    num_inliers: torch.Tensor  # [O] int
    success: torch.Tensor      # [O] bool


def _precondition(x: torch.Tensor, mask: torch.Tensor):
    """Center + scale [..., N, 3] points to unit RMS over the valid set.
    Returns (x', c [..., 3], s [...])."""
    m = mask.to(x.dtype)[..., None]
    n = torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0)
    c = torch.sum(x * m, dim=-2) / n[..., None]
    xc = (x - c[..., None, :]) * m
    s = torch.sqrt(torch.clamp(torch.sum(xc * xc, dim=(-2, -1)) / n, min=1e-12))
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


def sample_hypothesis_indices(mask: torch.Tensor, n_hyp: int,
                              generator: torch.Generator | None = None):
    """[O, n_hyp, 4] indices of valid points by Gumbel top-4.

    Same contract as the JAX sampler: distinct indices while at least 4
    points are valid; exhausted rows return index 0 (all scores -inf), which
    `pnp_ransac_batch` tolerates because it gates on n_valid >= 4."""
    O, n = mask.shape
    u = torch.rand((O, n_hyp, n), generator=generator, device=mask.device)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(mask[:, None, :], gumbel, -torch.inf)
    idxs = []
    for _ in range(4):
        i = torch.argmax(scores, dim=-1)
        idxs.append(i)
        scores = scores.scatter(-1, i[..., None], -torch.inf)
    return torch.stack(idxs, dim=-1)


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


def pnp_ransac_batch(x, y, mask, idx, threshold: float = DEFAULT_THRESHOLD,
                     refine: bool = True) -> PnpResult:
    """Robust PnP for a batch of objects from padded correspondences.

    x [O, N, 3] model points, y [O, N, 2] pinhole-normalized image points,
    mask [O, N] validity, idx [O, n_hyp, 4] hypothesis point indices."""
    dtype = x.dtype
    mask = mask.bool()
    feasible = mask.sum(-1) >= 4
    xp, c, s = _precondition(x, mask)
    thr_sq = float(threshold) ** 2

    Ts, _, counts = pnp_hypotheses(xp, y, mask, idx, thr_sq)
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


def pnp_ransac(x, y, mask, idx, threshold: float = DEFAULT_THRESHOLD,
               refine: bool = True) -> PnpResult:
    """Robust PnP of one point set: x [N, 3], y [N, 2], mask [N] and
    idx [n_hyp, 4] hypothesis indices (the JAX `pnp_ransac` draws
    DEFAULT_HYPOTHESES = 128 from one whole key). `pnp_ransac_batch` with a
    batch of one; the result's fields drop the batch axis."""
    r = pnp_ransac_batch(x[None], y[None], mask[None], idx[None], threshold, refine)
    return PnpResult(T=r.T[0], inliers=r.inliers[0], num_inliers=r.num_inliers[0],
                     success=r.success[0])
