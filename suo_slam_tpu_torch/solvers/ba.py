"""Fixed-sparsity camera+object pose-graph bundle adjustment — kernel K4's
home.

Port of `suo_slam_tpu/solvers/ba.py`: state cam_T [V, 4, 4] (T_GtoC) and
obj_T [O, 4, 4] (T_OtoG), residuals r[v, o, k] = uv - pi(cam_k[v, o],
T_GtoC[v] T_OtoG[o] p[o, k]) weighted by 2x2 information, a Huber IRLS
factor and the inlier mask; analytic left-se(3) Jacobians; rounds of LM with
chi2 <= 5.991 reclassification between them and Huber on the first half.

The per-(v, o) edge assembly (`_edge_planes_Hg`, `_edge_chi2`) is kernel K4
and the camera-block part of the Schur solve (`_solve_normal_eq_schur`) is
kernel K7 on CUDA tensors; CPU tensors take their plain versions. The
objects' reduced 6O x 6O system stays on `torch.linalg.cholesky_ex` and
triangular solves, as the JAX package left it to XLA. `_lm_while` is a
fixed-length loop whose `done` flag lives on the device and freezes the state
with `torch.where` — the same result as the JAX `while_loop`, with no host
sync per iteration.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels
from ..core import lie
from ..kernels import _build

CHI2_THRESH_2DOF = 5.991
HUBER_DELTA = math.sqrt(CHI2_THRESH_2DOF)
CONVERGENCE_RTOL = 1e-6
DEFAULT_GLOBAL_ROUNDS = (10, 10, 40, 40)
DEFAULT_TRACKING_ROUNDS = (10, 10, 10, 10)


class BAProblem(NamedTuple):
    """Fixed-capacity measurement buffers (V views, O objects, K keypoints)."""

    cam_T: torch.Tensor       # [V, 4, 4] T_GtoC
    obj_T: torch.Tensor       # [O, 4, 4] T_OtoG
    uv: torch.Tensor          # [V, O, K, 2] measured NDC keypoints
    info: torch.Tensor        # [V, O, K, 2, 2] information (symmetric)
    model_kp: torch.Tensor    # [O, K, 3]
    cam_k: torch.Tensor       # [V, O, 4] (fx, fy, cx, cy) in NDC
    valid: torch.Tensor       # [V, O, K] bool
    inliers: torch.Tensor     # [V, O, K] bool
    cam_active: torch.Tensor  # [V] bool
    obj_active: torch.Tensor  # [O] bool
    cam_frozen: torch.Tensor | None = None  # [V] bool
    obj_frozen: torch.Tensor | None = None  # [O] bool


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    obj_T: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    total_chi2: torch.Tensor


def _reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (quaternion round-trip)."""
    out = T.clone()
    out[..., :3, :3] = lie.quat_to_R(lie.R_to_quat(T[..., :3, :3]))
    return out


def _project_planes(cam_T, obj_T, uv, model_kp, cam_k):
    """Pinhole projection as [V, O, K] component planes.
    Returns (p_G [O, K, 3], px, py, pz, iz, ru, rv)."""
    p_G = torch.einsum("oij,okj->oki", obj_T[:, :3, :3], model_kp) + obj_T[:, None, :3, 3]
    p_C = (torch.einsum("vij,okj->voki", cam_T[:, :3, :3], p_G)
           + cam_T[:, None, None, :3, 3])
    px, py, pz = p_C[..., 0], p_C[..., 1], p_C[..., 2]
    iz = 1.0 / torch.where(torch.abs(pz) < 1e-12, 1e-12, pz)
    ru = uv[..., 0] - (cam_k[..., 0][..., None] * px * iz + cam_k[..., 2][..., None])
    rv = uv[..., 1] - (cam_k[..., 1][..., None] * py * iz + cam_k[..., 3][..., None])
    return p_G, px, py, pz, iz, ru, rv


def _chi2_from_planes(ru, rv, info):
    return (info[..., 0, 0] * ru * ru + 2.0 * info[..., 0, 1] * ru * rv
            + info[..., 1, 1] * rv * rv)


def _edge_chi2_plain(cam_T, obj_T, uv, info, model_kp, cam_k):
    _, _, _, _, _, ru, rv = _project_planes(cam_T, obj_T, uv, model_kp, cam_k)
    return _chi2_from_planes(ru, rv, info)


def _edge_planes_Hg_plain(cam_T, obj_T, uv, info, model_kp, cam_k, inl,
                          use_huber: bool, huber_d: float):
    """Plain PyTorch K4: (H [V, O, 12, 12], g [V, O, 12], chi2 [V, O, K]
    unweighted, z [V, O, K]); the Huber IRLS weight comes from this same
    evaluation's chi2, times the inlier mask."""
    V, O = uv.shape[0], uv.shape[1]
    K = model_kp.shape[1]
    p_G, px, py, pz, iz, ru, rv = _project_planes(cam_T, obj_T, uv, model_kp, cam_k)
    R_cw = cam_T[:, :3, :3]
    fx = cam_k[..., 0][..., None]
    fy = cam_k[..., 1][..., None]
    w00, w01, w11 = info[..., 0, 0], info[..., 0, 1], info[..., 1, 1]
    chi2 = _chi2_from_planes(ru, rv, info)
    w_h = torch.where(chi2 <= huber_d ** 2, 1.0,
                      huber_d / torch.sqrt(torch.clamp(chi2, min=1e-30)))
    w = inl.to(ru.dtype) * (w_h if use_huber else 1.0)

    A = fx * iz
    B = -fx * px * iz * iz
    C = fy * iz
    D = -fy * py * iz * iz
    zero = torch.zeros_like(A)
    Jc0 = (-B * py, B * px - A * pz, A * py, -A, zero, -B)
    Jc1 = (C * pz - D * py, D * px, -C * px, zero, -C, -D)
    R = R_cw[:, None, None]
    M0 = tuple(A * R[..., 0, j] + B * R[..., 2, j] for j in range(3))
    M1 = tuple(C * R[..., 1, j] + D * R[..., 2, j] for j in range(3))
    gx, gy, gz = (p_G[None, ..., i].expand(px.shape) for i in range(3))

    def jobj(M):
        return (M[1] * gz - M[2] * gy, -(M[0] * gz - M[2] * gx),
                M[0] * gy - M[1] * gx, -M[0], -M[1], -M[2])

    rows0 = Jc0 + jobj(M0)
    rows1 = Jc1 + jobj(M1)
    v00, v01, v11 = w00 * w, w01 * w, w11 * w
    J0 = torch.stack(rows0, dim=-2)  # [V, O, 12, K]
    J1 = torch.stack(rows1, dim=-2)
    Jcat = torch.cat([J0, J1], dim=-1).reshape(V * O, 12, 2 * K)
    JW0 = torch.stack(tuple(a * v00 + b * v01 for a, b in zip(rows0, rows1)), dim=-2)
    JW1 = torch.stack(tuple(a * v01 + b * v11 for a, b in zip(rows0, rows1)), dim=-2)
    JWcat = torch.cat([JW0, JW1], dim=-1).reshape(V * O, 12, 2 * K)
    H = torch.einsum("nik,njk->nij", JWcat, Jcat).reshape(V, O, 12, 12)
    rcat = torch.cat([ru, rv], dim=-1).reshape(V * O, 2 * K)
    g = torch.einsum("nik,nk->ni", JWcat, rcat).reshape(V, O, 12)
    return H, g, chi2, pz


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)


def _ba_edges_cuda(cam_T, obj_T, uv, info, model_kp, cam_k, inl, use_huber,
                   huber_d, want_hg: bool):
    V, O, K = uv.shape[:3]
    args = (cam_T, obj_T, uv, info, model_kp, cam_k)
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError("K4 runs in f32")
    if (cam_T.shape != (V, 4, 4) or obj_T.shape != (O, 4, 4)
            or info.shape != (V, O, K, 2, 2) or model_kp.shape != (O, K, 3)
            or cam_k.shape != (V, O, 4)
            or (inl is not None and inl.shape != (V, O, K))):
        raise ValueError("K4: inconsistent BA problem shapes")
    if 50 * K * 4 > 48 * 1024:
        raise ValueError(f"K4 holds at most 245 keypoints per object, got {K}")
    dev = uv.device
    if any(a.device != dev for a in args + ((inl,) if inl is not None else ())):
        raise ValueError("K4 inputs must lie on one CUDA device")
    cs = [a.contiguous() for a in args]
    mk = (inl if inl is not None else torch.zeros((V, O, K), dtype=torch.bool,
                                                  device=dev)).to(torch.uint8).contiguous()
    chi2 = torch.empty((V, O, K), dtype=torch.float32, device=dev)
    z = torch.empty((V, O, K), dtype=torch.float32, device=dev)
    if want_hg:
        H = torch.empty((V, O, 12, 12), dtype=torch.float32, device=dev)
        g = torch.empty((V, O, 12), dtype=torch.float32, device=dev)
    else:
        H = g = chi2  # never written in chi2 mode
    fn = _build.entry("ba_edges", _ARGTYPES)
    err = fn(*[_build.ptr(a) for a in cs], _build.ptr(mk), int(bool(use_huber)),
             float(huber_d), V, O, K, int(want_hg), _build.ptr(H), _build.ptr(g),
             _build.ptr(chi2), _build.ptr(z), _build.stream())
    _build.check(err, "K4 ba_edges")
    kernels.count("ba_edges")
    return H, g, chi2, z


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"BA: unsupported device {t.device}")
    return t.device.type


def _edge_chi2(cam_T, obj_T, uv, info, model_kp, cam_k):
    """chi2 [V, O, K] of every edge (no Jacobians): the cheap cost pass for LM
    step acceptance and reclassification. (The JAX function also returns the
    residuals, which no caller on this path reads.)"""
    if _device_of(uv) == "cpu":
        return _edge_chi2_plain(cam_T, obj_T, uv, info, model_kp, cam_k)
    return _ba_edges_cuda(cam_T, obj_T, uv, info, model_kp, cam_k, None, False,
                          0.0, want_hg=False)[2]


def _edge_planes_Hg(cam_T, obj_T, uv, info, model_kp, cam_k, *, inl,
                    use_huber: bool, huber_d: float):
    """Per-(v, o) normal-equation blocks with the Huber IRLS weight derived
    from this evaluation's chi2 (the LM loop's path). Returns
    (H [V, O, 12, 12], g [V, O, 12], chi2 [V, O, K], z [V, O, K])."""
    if _device_of(uv) == "cpu":
        return _edge_planes_Hg_plain(cam_T, obj_T, uv, info, model_kp, cam_k,
                                     inl, use_huber, huber_d)
    return _ba_edges_cuda(cam_T, obj_T, uv, info, model_kp, cam_k, inl,
                          use_huber, huber_d, want_hg=True)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """`jax.lax.linalg.cholesky` semantics: symmetrized input, NaN factor for
    a matrix that is not positive definite (no host sync, no raise)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2)))
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    half = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), half, upper=True)


def _solve_normal_eq_schur_plain(Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam):
    """Plain PyTorch K7 (and the reduced solve around it). Damped,
    Jacobi-scaled Schur-complement solve: eliminate the cameras' 6x6 blocks,
    solve the dense 6O x 6O reduced system over the objects, back-substitute.
    Frozen states get delta 0; a non-finite solve returns zeros and ok
    False."""
    dtype, dev = Hcc.dtype, Hcc.device
    V, O = Hco.shape[0], Hco.shape[1]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    mc = cam_free.to(dtype)
    mo = obj_free.to(dtype)

    def damp(Hbb):
        d = torch.clamp(torch.diagonal(Hbb, dim1=-2, dim2=-1), min=1e-9)
        return Hbb + lam * d[..., None] * eye6

    Hcc = damp(Hcc) * mc[:, None, None] + (1.0 - mc)[:, None, None] * eye6
    Hoo = damp(Hoo) * mo[:, None, None] + (1.0 - mo)[:, None, None] * eye6
    Hco = Hco * mc[:, None, None, None] * mo[None, :, None, None]
    gc = gc * mc[:, None]
    go = go * mo[:, None]

    dc = torch.sqrt(torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-12))
    do = torch.sqrt(torch.clamp(torch.diagonal(Hoo, dim1=-2, dim2=-1), min=1e-12))
    ic, io = 1.0 / dc, 1.0 / do
    Hcc_s = Hcc * ic[:, :, None] * ic[:, None, :] + 1e-9 * eye6
    Hoo_s = Hoo * io[:, :, None] * io[:, None, :]
    Hco_s = Hco * ic[:, None, :, None] * io[None, :, None, :]
    gc_s = gc * ic
    go_s = go * io

    Lc = _cholesky(Hcc_s)
    rhs = torch.cat(
        [Hco_s.permute(0, 2, 1, 3).reshape(V, 6, 6 * O), gc_s[..., None]], dim=-1
    )
    solved = _cho_solve(Lc, rhs)
    A = solved[..., : 6 * O].reshape(V, 6, O, 6).permute(0, 2, 1, 3)  # Hcc^-1 Hco
    y_c = solved[..., -1]

    S = -torch.einsum("voia,vpib->oapb", Hco_s, A)
    S = S + torch.einsum("oab,op->oapb", Hoo_s, torch.eye(O, dtype=dtype, device=dev))
    b_o = -go_s + torch.einsum("voia,vi->oa", Hco_s, y_c)
    S_flat = S.reshape(6 * O, 6 * O) + 1e-9 * torch.eye(6 * O, dtype=dtype, device=dev)
    Ls = _cholesky(S_flat)
    d_obj_s = _cho_solve(Ls, b_o.reshape(-1, 1)).reshape(O, 6)

    rhs_c = -gc_s - torch.einsum("voib,ob->vi", Hco_s, d_obj_s)
    d_cam_s = _cho_solve(Lc, rhs_c[..., None])[..., 0]

    d_cam = d_cam_s * ic * mc[:, None]
    d_obj = d_obj_s * io * mo[:, None]
    return _finite_or_zero(d_cam, d_obj)


def _finite_or_zero(d_cam, d_obj):
    ok = torch.isfinite(d_cam).all() & torch.isfinite(d_obj).all()
    return (torch.where(ok, d_cam, 0.0), torch.where(ok, d_obj, 0.0), ok)


_CAMS_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
_REDUCE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
_BACK_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def _solve_normal_eq_schur_cuda(Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam,
                                objects_frozen: bool):
    V, O = Hco.shape[0], Hco.shape[1]
    fs = (Hcc, Hoo, Hco, gc, go)
    if (Hcc.shape != (V, 6, 6) or Hoo.shape != (O, 6, 6) or Hco.shape != (V, O, 6, 6)
            or gc.shape != (V, 6) or go.shape != (O, 6) or cam_free.shape != (V,)
            or obj_free.shape != (O,)):
        raise ValueError("K7: inconsistent normal-equation shapes")
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K7 runs in f32")
    dev = Hcc.device
    if any(a.device != dev for a in fs + (cam_free, obj_free)):
        raise ValueError("K7 inputs must lie on one CUDA device")
    Hcc, Hoo, Hco, gc, go = (a.contiguous() for a in fs)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=dev).reshape(1).contiguous()
    cf = cam_free.to(torch.uint8).contiguous()
    of = obj_free.to(torch.uint8).contiguous()
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_cam = empty(V, 6)
    p = _build.ptr
    cams = _build.entry("ba_schur", _CAMS_ARGTYPES, "suo_ba_schur_cams")
    if objects_frozen:
        # every object frozen (tracking): Hco_s = 0 and d_obj = 0, so the
        # camera steps come out of the one launch
        err = cams(p(Hcc), p(Hoo), p(Hco), p(gc), p(go), p(cf), p(of), p(lam_t), V, O, 0,
                   *[p(d_cam)] * 8, p(d_cam), _build.stream())
        _build.check(err, "K7 ba_schur (cameras)")
        kernels.count("ba_schur")
        return _finite_or_zero(d_cam, torch.zeros((O, 6), dtype=torch.float32, device=dev))
    Lc, ic, io = empty(V, 6, 6), empty(V, 6), empty(O, 6)
    Hoo_s, go_s, Hco_s, gc_s = empty(O, 6, 6), empty(O, 6), empty(V, O, 6, 6), empty(V, 6)
    X = empty(V, 6, 6 * O + 1)
    err = cams(p(Hcc), p(Hoo), p(Hco), p(gc), p(go), p(cf), p(of), p(lam_t), V, O, 1,
               p(Lc), p(ic), p(io), p(Hoo_s), p(go_s), p(Hco_s), p(gc_s), p(X), p(d_cam),
               _build.stream())
    _build.check(err, "K7 ba_schur (cameras)")
    kernels.count("ba_schur")
    S, b = empty(6 * O, 6 * O), empty(6 * O)
    reduce = _build.entry("ba_schur", _REDUCE_ARGTYPES, "suo_ba_schur_reduce")
    err = reduce(p(Hoo_s), p(go_s), p(Hco_s), p(X), V, O, p(S), p(b), _build.stream())
    _build.check(err, "K7 ba_schur (reduce)")
    kernels.count("ba_schur")
    Ls = _cholesky(S)
    d_obj_s = _cho_solve(Ls, b[:, None]).reshape(O, 6).contiguous()
    back = _build.entry("ba_schur", _BACK_ARGTYPES, "suo_ba_schur_back")
    err = back(p(Lc), p(ic), p(cf), p(Hco_s), p(gc_s), p(d_obj_s), V, O, p(d_cam),
               _build.stream())
    _build.check(err, "K7 ba_schur (back-substitution)")
    kernels.count("ba_schur")
    return _finite_or_zero(d_cam, d_obj_s * io * obj_free.to(torch.float32)[:, None])


def _solve_normal_eq_schur(Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam,
                           objects_frozen: bool = False):
    """Solve (H + lam diag(H)) [d_cam; d_obj] = -g for the two-block BA
    normal equations by eliminating the cameras. K7 on CUDA tensors (with
    `objects_frozen`, a promise that obj_free is all False, the one-launch
    camera-only form, equal to the general one there), the plain version on
    CPU tensors. Returns (d_cam [V, 6], d_obj [O, 6], ok); a non-finite
    solve gives zeros and ok False."""
    if _device_of(Hcc) == "cpu":
        return _solve_normal_eq_schur_plain(Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam)
    return _solve_normal_eq_schur_cuda(Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam,
                                       objects_frozen)


def _make_lm_iteration(problem: BAProblem, tracking_only: bool,
                       fix_first_cam: bool, huber_d: float):
    """The shared LM step: one damped Schur solve + accept/reject."""
    V, O = problem.valid.shape[0], problem.valid.shape[1]
    dev = problem.uv.device
    cam_frozen = (problem.cam_frozen if problem.cam_frozen is not None
                  else torch.zeros((V,), dtype=torch.bool, device=dev))
    obj_frozen = (problem.obj_frozen if problem.obj_frozen is not None
                  else torch.zeros((O,), dtype=torch.bool, device=dev))
    arange_v = torch.arange(V, device=dev)

    def vertex_masks(inl):
        cam_edges = torch.sum(inl, dim=(1, 2))
        obj_edges = torch.sum(inl, dim=(0, 2))
        cam_in_graph = (cam_edges > 0) & problem.cam_active
        obj_in_graph = (obj_edges > 0) & problem.obj_active
        if tracking_only:
            cam_free = cam_in_graph & (cam_edges >= 3)
            obj_free = torch.zeros_like(obj_in_graph)
        else:
            cam_free = cam_in_graph & ~cam_frozen
            if fix_first_cam:
                first = torch.argmax(cam_in_graph.to(torch.uint8))
                cam_free = cam_free & (arange_v != first)
            obj_free = obj_in_graph & ~obj_frozen
        return cam_free, obj_free

    def robust_cost(chi2, inl, use_huber):
        s = chi2
        if use_huber:
            s = torch.where(s <= huber_d ** 2, s,
                            2.0 * huber_d * torch.sqrt(torch.clamp(s, min=1e-30))
                            - huber_d ** 2)
        return torch.sum(torch.where(inl, s, 0.0))

    def lm_iteration(state, use_huber):
        cam_T, obj_T, inl, lam = state
        cam_free, obj_free = vertex_masks(inl)
        Hvo, gvo, chi2, _ = _edge_planes_Hg(
            cam_T, obj_T, problem.uv, problem.info, problem.model_kp,
            problem.cam_k, inl=inl, use_huber=use_huber, huber_d=huber_d,
        )
        Hcc = torch.sum(Hvo[..., :6, :6], dim=1)
        Hoo = torch.sum(Hvo[..., 6:, 6:], dim=0)
        Hco = Hvo[..., :6, 6:]
        gc = torch.sum(gvo[..., :6], dim=1)
        go = torch.sum(gvo[..., 6:], dim=0)
        d_cam, d_obj, ok = _solve_normal_eq_schur(
            Hcc, Hoo, Hco, gc, go, cam_free, obj_free, lam, objects_frozen=tracking_only
        )
        cam_T_new = lie.se3_exp(d_cam) @ cam_T
        obj_T_new = lie.se3_exp(d_obj) @ obj_T
        cost_old = robust_cost(chi2, inl, use_huber)
        chi2_new = _edge_chi2(cam_T_new, obj_T_new, problem.uv, problem.info,
                              problem.model_kp, problem.cam_k)
        cost_new = robust_cost(chi2_new, inl, use_huber)
        accept = (ok & (cost_new < cost_old) & torch.isfinite(cam_T_new).all()
                  & torch.isfinite(obj_T_new).all())
        cam_T = torch.where(accept, cam_T_new, cam_T)
        obj_T = torch.where(accept, obj_T_new, obj_T)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        rel_gain = torch.where(
            accept, (cost_old - cost_new) / torch.clamp(cost_old, min=1e-30),
            torch.inf,
        )
        return (cam_T, obj_T, inl, lam), rel_gain

    return lm_iteration


def _lm_while(lm_iteration, cam_T, obj_T, inl, lam, n_iters: int, use_huber):
    """Up to n_iters LM iterations with the convergence exit of the JAX
    `while_loop` (relative gain < CONVERGENCE_RTOL or lambda >= 1e6), run as
    a fixed-length loop: once `done` (a device bool) is set the state is
    frozen with `torch.where`, so no iteration reads a value on the host."""
    done = torch.zeros((), dtype=torch.bool, device=cam_T.device)
    for _ in range(n_iters):
        (c_new, o_new, _, l_new), rel_gain = lm_iteration(
            (cam_T, obj_T, inl, lam), use_huber)
        cam_T = torch.where(done, cam_T, c_new)
        obj_T = torch.where(done, obj_T, o_new)
        lam = torch.where(done, lam, l_new)
        done = done | ((rel_gain < CONVERGENCE_RTOL) & torch.isfinite(rel_gain)) | (
            l_new >= 1e6)
    return cam_T, obj_T, lam


def optimize(problem: BAProblem, iters_per_round=DEFAULT_GLOBAL_ROUNDS,
             tracking_only: bool = False, fix_first_cam: bool = True,
             init_with_outliers: bool = False, huber_delta: float = HUBER_DELTA,
             chi2_thresh: float = CHI2_THRESH_2DOF) -> BAResult:
    """The robust LM schedule with chi2 reclassification between rounds
    (Huber on rounds 0..max(1, len // 2), as the JAX package pins it)."""
    dtype, dev = problem.cam_T.dtype, problem.cam_T.device
    act_vo = problem.cam_active[:, None] & problem.obj_active[None, :]
    valid = problem.valid & act_vo[..., None]

    def reclassify(cam_T, obj_T):
        chi2 = _edge_chi2(cam_T, obj_T, problem.uv, problem.info,
                          problem.model_kp, problem.cam_k)
        return valid & (chi2 <= chi2_thresh), chi2

    chi2_0 = _edge_chi2(problem.cam_T, problem.obj_T, problem.uv, problem.info,
                        problem.model_kp, problem.cam_k)
    inl = valid & ((chi2_0 <= chi2_thresh) | bool(init_with_outliers))
    lm_iteration = _make_lm_iteration(problem, tracking_only, fix_first_cam,
                                      float(huber_delta))
    cam_T, obj_T = problem.cam_T, problem.obj_T
    lam = torch.tensor(1e-5, dtype=dtype, device=dev)
    half = max(1, len(iters_per_round) // 2)
    for rnd, n_iters in enumerate(iters_per_round):
        use_huber = rnd <= half
        enough = torch.sum(inl) >= 4
        c_r, o_r, l_r = _lm_while(lm_iteration, cam_T, obj_T, inl, lam,
                                  n_iters, use_huber)
        c_r = _reorthonormalize(c_r)
        o_r = _reorthonormalize(o_r)
        inl_r, _ = reclassify(c_r, o_r)
        # the JAX `lax.cond(enough, run_round, identity)` as a device select
        cam_T = torch.where(enough, c_r, cam_T)
        obj_T = torch.where(enough, o_r, obj_T)
        inl = torch.where(enough, inl_r, inl)
        lam = torch.where(enough, l_r, lam)

    inl_final, chi2_final = reclassify(cam_T, obj_T)
    return BAResult(
        cam_T=cam_T, obj_T=obj_T, inliers=inl_final,
        num_inliers=torch.sum(inl_final),
        total_chi2=torch.sum(torch.where(inl_final, chi2_final, 0.0)),
    )
