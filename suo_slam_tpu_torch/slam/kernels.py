"""Per-frame device programs of the SLAM front end and tracking tail.

Port of `suo_slam_tpu/slam/kernels.py`:

- `make_frame_inference`: ROI crop (K1) -> prior render (K5) -> PkpNet ->
  heatmap readout (K2) + validity head, for every object of a frame in one
  call; `has_prior=False` is the statically prior-free program; `int8=True`
  runs the s8-resident executor (K11-K13) with persisted or online-calibrated
  scales;
- `make_multi_frame_inference` / `make_batch_inference`: the same over G
  frames in one call (the throughput evaluation modes), with and without
  priors;
- `frontend_step`: keypoint filter -> hypothesis sampler (the draws) ->
  batched PnP (`pnp_frame`: `pnp_ransac_batch`, one launch of K15, which
  ranks the draws itself) -> information -> (optionally) camera-pose RANSAC
  (`camera_ransac`, one launch of K6), with no host round-trip between the
  stages;
- kernel K6 (`csrc/chi2_counts.cu`): `camera_ransac` (also under the
  JAX-shaped `camera_pose_ransac`) and `reinit_votes` (under
  `reinit_counts`), each one launch with a plain twin for CPU tensors; the
  first design's bare counts (`_chi2_counts_cuda`, `chi2_counts_plain`)
  stay for comparison;
- `tracking_tail`: the symmetric group's scatter into the device mirrors ->
  late init -> re-init vote (`reinit_votes`) -> tracking BA (`ba.optimize`,
  one launch of K14), ending in the frame's second host read-back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as kcount
from .._device import resolve_device
from ..core import lie
from ..kernels import _build
from ..ops import heatmap as hm
from ..ops import roi as roi_ops
from ..solvers import ba
from ..solvers import pnp as pnp_mod
from ..solvers.ba import CHI2_THRESH_2DOF

COV_DIAG_FLOOR = 1e-4


def info_from_cov(cov: torch.Tensor) -> torch.Tensor:
    """2x2 information = closed-form inverse of the covariance with its
    diagonal floored at COV_DIAG_FLOOR."""
    a = torch.clamp(cov[..., 0, 0], min=COV_DIAG_FLOOR)
    d = torch.clamp(cov[..., 1, 1], min=COV_DIAG_FLOOR)
    b = cov[..., 0, 1]
    det = torch.clamp(a * d - b * b, min=1e-12)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-b, a], -1)], dim=-2)
    return inv / det[..., None, None]


def manual_info(shape, manual_kp_std: float, dtype=torch.float32, device=None):
    """Isotropic information I / sigma^2 for the no-network-cov path."""
    # a fill, not `torch.tensor`: no blocking host-to-device copy
    s2 = torch.full((), manual_kp_std, dtype=dtype, device=device) ** 2
    eye = torch.eye(2, dtype=dtype, device=device) / s2
    return eye.expand(tuple(shape) + (2, 2))


def filter_keypoints(uv, cov, mask_prob, model_mask, bbox_thresh: float = 0.9,
                     kp_var_thresh: float = 0.2, mask_thresh: float = 0.3):
    """Keep channels the validity head accepts, the object has, away from the
    ROI border, and (with a covariance) whose stdevs are both below
    2 * kp_var_thresh."""
    keep = (mask_prob > mask_thresh) & model_mask
    keep = keep & (torch.amin(uv, -1) > -bbox_thresh) & (torch.amax(uv, -1) < bbox_thresh)
    if cov is not None:
        var = torch.stack([cov[..., 0, 0], cov[..., 1, 1]], -1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        keep = keep & torch.all(std < 2.0 * kp_var_thresh, dim=-1)
    return keep


def pnp_frame(model_kps, uv, kp_mask, cam_k4, diameters, hyp):
    """Batched per-object PnP with the acceptance gates: success, >= 4
    inliers and t_z > 0.5 * diameter. hyp: the hypotheses, `pnp.Draws` or
    indices [O, n_hyp, 4] (`pnp_ransac_batch`). Returns (T_OtoC [O, 4, 4],
    ok [O]); failed slots hold identity."""
    y_norm = (uv - cam_k4[:, None, 2:]) / cam_k4[:, None, :2]
    res = pnp_mod.pnp_ransac_batch(model_kps, y_norm, kp_mask, hyp)
    ok = res.success & (res.num_inliers >= 4) & (res.T[:, 2, 3] > 0.5 * diameters)
    eye = torch.eye(4, dtype=res.T.dtype, device=res.T.device)
    return torch.where(ok[:, None, None], res.T, eye), ok


def chi2_counts_plain(T_OtoC, model_kp, uv, info, mask, cam_k4,
                      chi2_thresh: float = CHI2_THRESH_2DOF, per_object: bool = False):
    """Plain PyTorch K6. T_OtoC [S, O, 4, 4] pose sets; model_kp [O, K, 3];
    uv [M, O, K, 2], info [M, O, K, 2, 2], mask [M, O, K], cam_k4 [M, O, 4]
    measurement rows, set s reading row s % M (S a multiple of M). An edge
    counts when chi2 <= chi2_thresh, it lies in front of the camera (z > 0)
    and its mask is set. Returns int32 counts: [S] (per set, summed over
    objects and keypoints) or, with per_object, [S // M, O] (per group of M
    consecutive sets and object, summed over the group and keypoints)."""
    S, O = T_OtoC.shape[:2]
    M, K = uv.shape[0], uv.shape[2]
    R, t = T_OtoC[..., :3, :3], T_OtoC[..., :3, 3]
    x, y, z = (model_kp[..., i] for i in range(3))
    p = [x * R[..., i, 0, None] + y * R[..., i, 1, None] + z * R[..., i, 2, None]
         + t[..., i, None] for i in range(3)]                      # [S, O, K]
    p = [a.reshape(S // M, M, O, K) for a in p]
    pz = p[2]
    iz = 1.0 / torch.where(torch.abs(pz) < 1e-12, 1e-12, pz)
    u = cam_k4[..., 0, None] * p[0] * iz + cam_k4[..., 2, None]
    v = cam_k4[..., 1, None] * p[1] * iz + cam_k4[..., 3, None]
    ru = uv[..., 0] - u
    rv = uv[..., 1] - v
    chi2 = (ru * (info[..., 0, 0] * ru + info[..., 0, 1] * rv)
            + rv * (info[..., 1, 0] * ru + info[..., 1, 1] * rv))
    good = (chi2 <= chi2_thresh) & (pz > 0) & mask.bool()          # [G, M, O, K]
    if per_object:
        return good.sum(dim=(1, 3)).to(torch.int32)
    return good.reshape(S, O * K).sum(-1).to(torch.int32)


K6_THREADS = 128       # kThreads: a block per count (`chi2_counts_kernel`)
K6_CAM_THREADS = 512   # kCamThreads: the camera-RANSAC block (`camera_ransac_kernel`)
K6_CAM_HYPS = 16       # kCamHyps: camera hypotheses a round at most
K6_REINIT_THREADS = 256  # kReinitThreads: a re-init block (`reinit_votes_kernel`)
K6_REINIT_CHUNK = 32   # kReinitChunk: re-init views staged at a time
_CHI2_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 2)


def _chi2_counts_cuda(T_OtoC, model_kp, uv, info, mask, cam_k4, chi2_thresh,
                      per_object):
    S, O = T_OtoC.shape[:2]
    M, K = uv.shape[0], uv.shape[2]
    if (T_OtoC.shape != (S, O, 4, 4) or model_kp.shape != (O, K, 3)
            or uv.shape != (M, O, K, 2) or info.shape != (M, O, K, 2, 2)
            or mask.shape != (M, O, K) or cam_k4.shape != (M, O, 4) or S % M):
        raise ValueError("K6: inconsistent chi2-count shapes")
    fs = (T_OtoC, model_kp, uv, info, cam_k4)
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K6 runs in f32")
    dev = uv.device
    if any(a.device != dev for a in fs + (mask,)):
        raise ValueError("K6 inputs must lie on one CUDA device")
    cs = [a.contiguous() for a in fs]
    mk = mask.to(torch.uint8).contiguous()
    out = torch.empty(((S // M) * O,) if per_object else (S,), dtype=torch.int32,
                      device=dev)
    fn = _build.entry("chi2_counts", _CHI2_ARGTYPES)
    err = fn(_build.ptr(cs[0]), _build.ptr(cs[1]), _build.ptr(cs[2]), _build.ptr(cs[3]),
             _build.ptr(mk), _build.ptr(cs[4]), S, O, K, M, int(bool(per_object)),
             float(chi2_thresh), _build.ptr(out), _build.stream())
    _build.check(err, "K6 chi2_counts")
    kcount.count("chi2_counts")
    return out.reshape(S // M, O) if per_object else out


def invert_se3_plain(T):
    """[..., 4, 4] SE(3) inverse [R^T, -R^T t; 0 0 0 1] in K6's written
    order: t'_i = -((R_0i t_0 + R_1i t_1) + R_2i t_2), each product and sum
    rounded on its own (`csrc/chi2_counts.cu`'s hypotheses, built with
    --fmad=false, compute the same bits; `lie.invert_SE3`'s `@` has no
    defined summation order)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    ti = -(R[..., 0, :] * t[..., 0, None] + R[..., 1, :] * t[..., 1, None]
           + R[..., 2, :] * t[..., 2, None])
    return lie.make_T(R.transpose(-1, -2), ti)


def compose_plain(A, B):
    """[..., 4, 4] products A B (broadcast) in K6's written order:
    C_ij = ((A_i0 B_0j + A_i1 B_1j) + A_i2 B_2j) + A_i3 B_3j."""
    C = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, 4):
        C = C + A[..., :, k, None] * B[..., None, k, :]
    return C


def _select(counts, cand, T_hyp, min_num_inliers):
    """The RANSAC tail without a host read: non-candidates score -1, the
    first maximum wins, and below min_num_inliers the pose is the identity.
    Returns (T_GtoC [4, 4], best count, ok, best)."""
    counts = torch.where(cand, counts, -1)
    best = torch.argmax(counts)  # first maximum
    best_count = counts.gather(0, best[None])[0]
    ok = best_count >= min_num_inliers
    eye = torch.eye(4, dtype=T_hyp.dtype, device=T_hyp.device)
    return torch.where(ok, T_hyp.index_select(0, best[None])[0], eye), best_count, ok, best


def camera_pose_ransac(T_pnp, pnp_ok, T_obj, obj_ok, model_kp, uv, info, inliers,
                       cam_k4, min_num_inliers: int = 4):
    """RANSAC over per-object camera-pose hypotheses, JAX's signature.
    Hypothesis j is T_GtoC = T_pnp[j] inv(T_obj[j]); each is scored
    against every object's inlier keypoints of this frame; an object whose
    detection has no inlier does not score. T_pnp [O, 4, 4], pnp_ok [O],
    T_obj [O, 4, 4] (T_OtoG), obj_ok [O], model_kp [O, K, 3], uv [O, K, 2],
    info [O, K, 2, 2], inliers [O, K], cam_k4 [O, 4]: `camera_ransac` with
    row j in slot j (one K6 launch on CUDA tensors). Returns (T_GtoC
    [4, 4], best count, ok), all on the device."""
    slots = torch.arange(T_obj.shape[0], device=T_obj.device)
    return camera_ransac(T_pnp, pnp_ok, uv, info, inliers, cam_k4, slots, T_obj, obj_ok,
                         model_kp, min_num_inliers)[:3]


def camera_ransac_plain(T_pnp, pnp_ok, uv, info, keep, cam_k4, slots, obj_T, obj_active,
                        model_kp_full, min_num_inliers: int = 4,
                        chi2_thresh: float = CHI2_THRESH_2DOF):
    """Plain PyTorch twin of K6's camera-RANSAC mode (`camera_ransac`): the
    group's rows T_pnp [ob, 4, 4], pnp_ok [ob], uv [ob, K, 2],
    info [ob, K, 2, 2], keep [ob, K], cam_k4 [ob, 4] belong to map slots
    slots [ob] (distinct, apart from the pad O, which is dropped); the map
    holds obj_T [O, 4, 4], obj_active [O], model_kp_full [O, K, 3]. Slot j
    without a row has no PnP pose (identity, not ok) and no keypoints.
    Hypothesis j = T_row[j] inv(obj_T[j]), a candidate where the row's PnP
    is ok and the object active; it scores every candidate object's kept
    edges (`chi2_counts_plain`: the kernel's arithmetic); the first maximum
    in slot order wins if it reaches min_num_inliers, else the identity.
    Compositions by `compose_plain` / `invert_se3_plain`, so the kernel
    equals this twin bit for bit. Returns (T_GtoC [4, 4], best count
    (int32), ok, best slot), all on the device."""
    O, ob = obj_T.shape[0], slots.shape[0]
    dev = obj_T.device
    # the row of each slot, ob where none: index_put of distinct slots
    row = torch.full((O + 1,), ob, dtype=torch.long, device=dev)
    row[slots.long()] = torch.arange(ob, device=dev)
    row = row[:O]
    ext = lambda a, fill: torch.cat([a, torch.full_like(a[:1], fill)])[row]
    eye = torch.eye(4, dtype=T_pnp.dtype, device=dev)
    T_row = torch.cat([T_pnp, eye[None]])[row]
    cand = ext(pnp_ok.bool(), False) & obj_active.bool()
    T_hyp = compose_plain(T_row, invert_se3_plain(obj_T))        # [H=O, 4, 4]
    T_OtoC_hyp = compose_plain(T_hyp[:, None], obj_T[None, :])   # [H, O, 4, 4]
    mask = ext(keep.bool(), False) & cand[:, None]
    counts = chi2_counts_plain(T_OtoC_hyp, model_kp_full, ext(uv, 0.0)[None],
                               ext(info, 0.0)[None], mask[None], ext(cam_k4, 0.0)[None],
                               chi2_thresh)
    return _select(counts, cand, T_hyp, min_num_inliers)


_CAM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3
                 + [ctypes.c_void_p] * 6)
# the fused modes' phases, in the order of their `cycles` (`csrc/chi2_counts.cu`)
K6_CAM_PHASES = ("stage", "hypotheses", "compose", "count", "select")
K6_REINIT_PHASES = ("poses", "rows", "count", "reduce")


def _check_cycles(cycles, shape, dev):
    if cycles is not None and (tuple(cycles.shape) != shape or cycles.dtype != torch.int64
                               or cycles.device != dev):
        raise ValueError(f"K6 cycles: int64 zeros {list(shape)} on {dev}")


def camera_ransac_smem(O: int, ob: int, K: int, hr: int | None = None) -> int:
    """K6's camera-RANSAC shared memory (`csrc/chi2_counts.cu`
    `camera_ransac_kernel`, its layout): the staged inputs (the map's poses
    and keypoints, the group's rows), the O hypotheses and a round's
    object-to-camera poses (12 floats each, hr hypotheses a round, by
    default min(O, K6_CAM_HYPS)), the slots' and rows' ints and the warps'
    partial counts of a round, the keep bytes."""
    hr = min(O, K6_CAM_HYPS) if hr is None else hr
    floats = 32 * O + 3 * O * K + ob * (16 + 6 * K + 4) + 12 * hr * O
    return 4 * (floats + 4 * O + 2 * ob + K6_CAM_THREADS // 32 * K6_CAM_HYPS) + ob * K


def camera_ransac_hyps(O: int, ob: int, K: int) -> int:
    """Hypotheses a round of K6's camera RANSAC: the most, up to
    min(O, K6_CAM_HYPS), whose shared memory fits one block; 0 when not
    even one does. The round's poses grow as O times this, the rest of the
    layout as O + ob: at K = 41 every group of a map of up to 128 slots
    fits (16 hypotheses a round up to O = 64, and at O = 128 for groups of
    up to 32 rows; one a round at O = ob = 128), and at O = 256 groups of
    up to 32 rows; larger maps raise (`_camera_ransac_cuda`)."""
    for hr in range(min(O, K6_CAM_HYPS), 0, -1):
        if camera_ransac_smem(O, ob, K, hr) <= pnp_mod.SMEM_PER_BLOCK:
            return hr
    return 0


def _camera_ransac_cuda(T_pnp, pnp_ok, uv, info, keep, cam_k4, slots, obj_T, obj_active,
                        model_kp_full, min_num_inliers=4, chi2_thresh=CHI2_THRESH_2DOF,
                        cycles=None):
    """K6's camera-RANSAC mode: `camera_ransac_plain` in one launch of one
    block. Reads shapes only (no host value); raises on what the kernel
    does not take. With `cycles` (int64 zeros [len(K6_CAM_PHASES)] on the
    card) the kernel adds thread 0's SM clock cycles per phase there."""
    ob, K = keep.shape
    O = obj_T.shape[0]
    if (T_pnp.shape != (ob, 4, 4) or pnp_ok.shape != (ob,) or uv.shape != (ob, K, 2)
            or info.shape != (ob, K, 2, 2) or cam_k4.shape != (ob, 4) or slots.shape != (ob,)
            or obj_T.shape != (O, 4, 4) or obj_active.shape != (O,)
            or model_kp_full.shape != (O, K, 3) or min(O, ob, K) < 1):
        raise ValueError("K6: inconsistent camera-RANSAC shapes")
    fs = (T_pnp, uv, info, cam_k4, obj_T, model_kp_full)
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K6 runs in f32")
    hr = camera_ransac_hyps(O, ob, K)
    if hr == 0:
        raise ValueError(f"K6 camera RANSAC holds at most {pnp_mod.SMEM_PER_BLOCK} bytes of "
                         f"shared memory: {O} objects, {ob} rows of {K} keypoints need "
                         f"{camera_ransac_smem(O, ob, K, 1)}")
    smem = camera_ransac_smem(O, ob, K, hr)
    dev = obj_T.device
    if dev.type != "cuda" or any(a.device != dev for a in fs + (pnp_ok, keep, slots, obj_active)):
        raise ValueError("K6 inputs must lie on one CUDA device")
    _check_cycles(cycles, (len(K6_CAM_PHASES),), dev)
    # every argument bound to a name until the launch (a temporary's memory
    # could be handed to the next one before the kernel reads it); the
    # engine's bool masks and int64 slots pass as they are
    c = [a.contiguous() for a in fs]
    ok8, keep8, act8 = (m.bool().contiguous().view(torch.uint8)
                        for m in (pnp_ok, keep, obj_active))
    sl = slots.long().contiguous()
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    p = _build.ptr
    fn = _build.entry("chi2_counts", _CAM_ARGTYPES, "suo_camera_ransac")
    err = fn(p(c[0]), p(ok8), p(c[1]), p(c[2]), p(keep8), p(c[3]), p(sl), ob, p(c[4]),
             p(act8), p(c[5]), O, K, float(chi2_thresh), int(min_num_inliers), hr, smem,
             p(T_out), p(count), p(ok), p(best), None if cycles is None else p(cycles),
             _build.stream())
    _build.check(err, "K6 camera_ransac")
    kcount.count("chi2_counts")
    return T_out, count, ok, best


def camera_ransac(T_pnp, pnp_ok, uv, info, keep, cam_k4, slots, obj_T, obj_active,
                  model_kp_full, min_num_inliers: int = 4,
                  chi2_thresh: float = CHI2_THRESH_2DOF):
    """Camera-pose RANSAC of one group's front-end rows against the map
    (see `camera_ransac_plain`): one launch of K6 on CUDA tensors, the plain
    twin on CPU tensors. Returns (T_GtoC, best count, ok, best slot)."""
    args = (T_pnp, pnp_ok, uv, info, keep, cam_k4, slots, obj_T, obj_active, model_kp_full,
            min_num_inliers, chi2_thresh)
    if obj_T.device.type == "cpu":
        return camera_ransac_plain(*args)
    if obj_T.device.type != "cuda":
        raise ValueError(f"camera_ransac: unsupported device {obj_T.device}")
    return _camera_ransac_cuda(*args)


def reinit_votes_plain(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv_m, info_m,
                       valid_m, cam_k4_m, cs, chi2_thresh: float = CHI2_THRESH_2DOF):
    """Plain PyTorch twin of K6's re-init mode (`reinit_votes`): the chi2
    inlier counts per object of this frame's PnP poses and of the map
    estimates, T_pnp_OtoG / T_est_OtoG [O, 4, 4], over the views cs [n] of
    the mirrors uv_m [V, O, K, 2], info_m [V, O, K, 2, 2], valid_m
    [V, O, K] (detected keypoints, not inlier gated) and cam_k4_m
    [V, O, 4], seen from cam_T [n, 4, 4] (`compose_plain`: the kernel's
    order); a view with cam_valid [n] false does not count.
    Returns (count_pnp [O], count_est [O]), int32."""
    cs = cs.long()
    mask = valid_m[cs] & cam_valid.bool()[:, None, None]
    T = torch.cat([compose_plain(cam_T[:, None], T_pnp_OtoG[None]),
                   compose_plain(cam_T[:, None], T_est_OtoG[None])])   # [2n, O, 4, 4]
    counts = chi2_counts_plain(T, model_kp, uv_m[cs], info_m[cs], mask, cam_k4_m[cs],
                               chi2_thresh, per_object=True)          # [2, O]
    return counts[0], counts[1]


_REINIT_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float]
                    + [ctypes.c_int] + [ctypes.c_void_p] * 3)


def reinit_smem(K: int) -> int:
    """K6's re-init shared memory (`reinit_votes_kernel`, its layout): for a
    chunk of K6_REINIT_CHUNK views their information, intrinsics,
    measurements and composed poses, the object's keypoints, the views'
    rows and the edge masks."""
    c = K6_REINIT_CHUNK
    return 4 * (3 * K + c * (12 + 4 + 6 * K) + c) + c * K


def _reinit_votes_cuda(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv_m, info_m,
                       valid_m, cam_k4_m, cs, chi2_thresh=CHI2_THRESH_2DOF, cycles=None):
    """K6's re-init mode: `reinit_votes_plain` in one launch (a block per
    (pose set, object)). Reads shapes only; raises on what the kernel does
    not take. With `cycles` (int64 zeros [2 O, len(K6_REINIT_PHASES)] on
    the card) each block adds its thread 0's SM clock cycles per phase to
    its row."""
    V, O, K = valid_m.shape
    n = cs.shape[0]
    if (T_pnp_OtoG.shape != (O, 4, 4) or T_est_OtoG.shape != (O, 4, 4)
            or cam_T.shape != (n, 4, 4) or cam_valid.shape != (n,)
            or model_kp.shape != (O, K, 3) or uv_m.shape != (V, O, K, 2)
            or info_m.shape != (V, O, K, 2, 2) or cam_k4_m.shape != (V, O, 4)
            or min(O, n, K) < 1):
        raise ValueError("K6: inconsistent re-init shapes")
    fs = (T_pnp_OtoG, T_est_OtoG, cam_T, model_kp, uv_m, info_m, cam_k4_m)
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K6 runs in f32")
    smem = reinit_smem(K)
    if smem > pnp_mod.SMEM_PER_BLOCK:
        raise ValueError(f"K6 re-init holds at most {pnp_mod.SMEM_PER_BLOCK} bytes of shared "
                         f"memory: {K} keypoints need {smem}")
    dev = valid_m.device
    if dev.type != "cuda" or any(a.device != dev for a in fs + (cam_valid, valid_m, cs)):
        raise ValueError("K6 inputs must lie on one CUDA device")
    _check_cycles(cycles, (2 * O, len(K6_REINIT_PHASES)), dev)
    # bound to names until the launch; cp.async reads info and cam_k4 rows
    # of 16 bytes and uv rows of 8: a tensor that does not start on 16
    # bytes is copied to one that does
    c = [a.contiguous() for a in fs]
    c = [a if a.data_ptr() % 16 == 0 else a.clone() for a in c]
    cv8, val8 = (m.bool().contiguous().view(torch.uint8) for m in (cam_valid, valid_m))
    cs64 = cs.long().contiguous()
    out = torch.empty((2, O), dtype=torch.int32, device=dev)
    p = _build.ptr
    fn = _build.entry("chi2_counts", _REINIT_ARGTYPES, "suo_reinit_votes")
    err = fn(p(c[0]), p(c[1]), p(c[2]), p(cv8), p(c[3]), p(c[4]), p(c[5]), p(val8), p(c[6]),
             p(cs64), V, O, K, n, float(chi2_thresh), smem, p(out),
             None if cycles is None else p(cycles), _build.stream())
    _build.check(err, "K6 reinit_votes")
    kcount.count("chi2_counts")
    return out[0], out[1]


def reinit_votes(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv_m, info_m, valid_m,
                 cam_k4_m, cs, chi2_thresh: float = CHI2_THRESH_2DOF):
    """The re-init vote's counts over the views cs of the device mirrors
    (see `reinit_votes_plain`): one launch of K6 on CUDA tensors, the plain
    twin on CPU tensors."""
    args = (T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv_m, info_m, valid_m,
            cam_k4_m, cs, chi2_thresh)
    if valid_m.device.type == "cpu":
        return reinit_votes_plain(*args)
    if valid_m.device.type != "cuda":
        raise ValueError(f"reinit_votes: unsupported device {valid_m.device}")
    return _reinit_votes_cuda(*args)


def reinit_counts(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv, info,
                  valid, cam_k4):
    """chi2 inlier counts over the last N views of this frame's PnP poses and
    of the map estimates, per object: T_pnp_OtoG / T_est_OtoG [O, 4, 4],
    cam_T [N, 4, 4], cam_valid [N], model_kp [O, K, 3], uv [N, O, K, 2],
    info [N, O, K, 2, 2], valid [N, O, K] (detected keypoints, not inlier
    gated), cam_k4 [N, O, 4]: `reinit_votes` over views 0..N-1 (one K6
    launch on the card). Returns (count_pnp [O], count_est [O])."""
    cs = torch.arange(valid.shape[0], device=valid.device)
    return reinit_votes(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv, info, valid,
                        cam_k4, cs)


def _scatter_rows(dst, idx, src):
    """dst [O, ...] with rows idx [ob] set to src [ob, ...]; an index equal
    to O (a padded slot) is dropped, as JAX's `.at[].set(mode="drop")`."""
    ext = torch.cat([dst, dst[:1]])
    ext[idx.long()] = src.to(dst.dtype)
    return ext[: dst.shape[0]]


def frontend_step(uv, cov, mask_prob, model_kps, model_masks, cam_k4, diams,
                  hyp_sampler, manual_kp_std: float, bbox_thresh: float,
                  kp_var_thresh: float, mask_thresh: float, n_hyp: int = 64,
                  slots=None, obj_T=None, obj_active=None, model_kp_full=None,
                  min_num_inliers: int = 4, keep_in=None):
    """Fused per-group front end: keypoint filter -> PnP -> information ->
    (when `slots`/`obj_T`/`obj_active`/`model_kp_full` are given) camera-pose
    RANSAC. `hyp_sampler(keep [O, K], n_hyp)` draws the RANSAC hypotheses:
    `pnp.Draws` [O, n_hyp, N] (ranked under keep by K15 itself) or
    indices [O, n_hyp, 4] (`pnp_ransac_batch`). For camera RANSAC
    (`camera_ransac`) the group's rows belong to map slots (slots [ob],
    distinct, a padded slot = O is dropped) and are scored against the map
    poses obj_T [O, 4, 4]. `keep_in` [O, K]
    (debug_gt_kp: the dataset's keypoint masks) replaces the filter.
    Returns a dict of small per-frame tensors that the caller reads back in
    one transfer."""
    if keep_in is not None:
        keep = keep_in
    else:
        keep = filter_keypoints(uv, cov, mask_prob, model_masks,
                                bbox_thresh, kp_var_thresh, mask_thresh)
    T_pnp, pnp_ok = pnp_frame(model_kps, uv, keep, cam_k4, diams, hyp_sampler(keep, n_hyp))
    if cov is not None:
        info = info_from_cov(cov)
        var = torch.stack([cov[..., 0, 0], cov[..., 1, 1]], -1)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        std_sum = torch.sum(torch.where(keep[..., None], std, 0.0))
        std_cnt = 2 * torch.sum(keep)
    else:
        info = manual_info(uv.shape[:2], manual_kp_std, uv.dtype, uv.device)
        std_sum = torch.zeros((), dtype=uv.dtype, device=uv.device)
        std_cnt = torch.zeros((), dtype=torch.int64, device=uv.device)
    out = {
        "uv": uv, "cov": cov, "keep": keep, "info": info,
        "T_pnp": T_pnp, "pnp_ok": pnp_ok,
        "std_sum": std_sum, "std_cnt": std_cnt,
    }
    if slots is not None:
        T_cam, cam_count, cam_ok, _ = camera_ransac(
            T_pnp, pnp_ok, uv, info, keep, cam_k4, slots, obj_T, obj_active, model_kp_full,
            min_num_inliers)
        out.update({"T_cam": T_cam, "cam_count": cam_count, "cam_ok": cam_ok})
    return out


def tracking_tail(uv_m, info_m, valid_m, inliers_m, cam_k4_m, model_kp_m, v: int,
                  cam_T_v, obj_T, obj_active, sym, reinit, info_scale: float,
                  init_with_outliers: bool, iters_per_round=(10, 10, 10, 10)):
    """The per-frame tail, one device chain ending in the frame's second host
    read-back: scatter the symmetric group's measurements into the device
    mirrors of row v -> late object init -> re-init vote over the last views
    -> tracking BA of the current camera with every object fixed.

    uv_m [V, O, K, 2], info_m, valid_m, inliers_m, cam_k4_m are the engine's
    device mirrors and are updated IN PLACE (row v only; the port keeps one
    copy where JAX returns new arrays). sym: the symmetric group's front-end
    outputs plus "slots" [ob] (pad = O) and "cam_k4" [ob, 4], or None.
    reinit: "cand_sel" [O], "T_pnp_G" [O, 4, 4], "cs" [n] view slots,
    "cam_valid" [n], "cam_T_w" [n, 4, 4], or None. Returns the mirrors and a
    dict of the host's updates: late, obj_T, reinit_cond, did_opt, cam_T_v,
    inliers_row."""
    O, K = model_kp_m.shape[:2]
    dt, dev = cam_T_v.dtype, cam_T_v.device
    ok_row = torch.zeros((O,), dtype=torch.bool, device=dev)
    T_pnp_row = torch.eye(4, dtype=dt, device=dev).repeat(O, 1, 1)
    late = torch.zeros((O,), dtype=torch.bool, device=dev)
    T_GtoC_inv = lie.invert_SE3(cam_T_v)
    if sym is not None:
        sl = sym["slots"]
        uv_m[v] = _scatter_rows(uv_m[v], sl, sym["uv"])
        info_m[v] = _scatter_rows(info_m[v], sl, sym["info"])
        valid_m[v] = _scatter_rows(valid_m[v], sl, sym["keep"])
        inliers_m[v] = _scatter_rows(inliers_m[v], sl, sym["keep"])
        cam_k4_m[v] = _scatter_rows(cam_k4_m[v], sl, sym["cam_k4"])
        ok_row = _scatter_rows(ok_row, sl, sym["pnp_ok"])
        T_pnp_row = _scatter_rows(T_pnp_row, sl, sym["T_pnp"])
        # late init: a detected but unmapped object with a successful PnP
        # enters the map at inv(T_GtoC) T_pnp
        late = ok_row & ~obj_active
        obj_T = torch.where(late[:, None, None], T_GtoC_inv[None] @ T_pnp_row, obj_T)
        obj_active = obj_active | late

    reinit_cond = torch.zeros((O,), dtype=torch.bool, device=dev)
    if reinit is not None:
        # candidates: this frame's detections with a PnP pose on an active
        # object (a freshly late-initialized object is a formal candidate
        # that cannot fire: its PnP pose is its map pose)
        T_pnp_G = torch.where(reinit["cand_sel"][:, None, None], reinit["T_pnp_G"],
                              T_GtoC_inv[None] @ T_pnp_row)
        sel = reinit["cand_sel"] | (ok_row & obj_active)
        n_pnp, n_est = reinit_votes(
            T_pnp_G, obj_T, reinit["cam_T_w"], reinit["cam_valid"], model_kp_m,
            uv_m, info_m, valid_m, cam_k4_m, reinit["cs"],
        )
        reinit_cond = sel & (n_pnp >= 3) & (n_pnp > 3 * n_est)
        obj_T = torch.where(reinit_cond[:, None, None], T_pnp_G, obj_T)

    # tracking BA over the current view row only
    row = slice(v, v + 1)
    inl_r = inliers_m[row]
    problem = ba.BAProblem(
        cam_T=cam_T_v[None], obj_T=obj_T, uv=uv_m[row], info=info_m[row] * info_scale,
        model_kp=model_kp_m, cam_k=cam_k4_m[row], valid=valid_m[row], inliers=inl_r,
        cam_active=torch.ones((1,), dtype=torch.bool, device=dev), obj_active=obj_active,
    )
    res = ba.optimize(problem, iters_per_round=iters_per_round, tracking_only=True,
                      fix_first_cam=False, init_with_outliers=init_with_outliers)
    # no tracking opt below 3 inlier edges in the current frame: a select,
    # not a branch
    did_opt = torch.sum(inl_r[0] & obj_active[:, None]) >= 3
    cam_T_new = torch.where(did_opt, res.cam_T[0], cam_T_v)
    inl_new = torch.where(did_opt, res.inliers[0], inl_r[0])
    inliers_m[v] = inl_new
    out = {"late": late, "obj_T": obj_T, "reinit_cond": reinit_cond,
           "did_opt": did_opt, "cam_T_v": cam_T_new, "inliers_row": inl_new}
    return (uv_m, info_m, valid_m, inliers_m, cam_k4_m), out


def make_frame_inference(net, input_hw=(256, 256), device="cuda", int8=False,
                         int8_scales=None, int8_calib_frames=8):
    """The fused per-frame network call.

    `net` is a `models.pkpnet.PkpNet` holding its weights (see
    `models.convert.from_jax_variables`); it is moved to `device`, put in
    eval mode and `channels_last` memory. Its backbone runs in the net's
    working dtype (`PkpNet(dtype=...)`, f32 or bf16); the crops and the
    readout stay f32, and K5 renders the prior in the net's `prior_dtype`
    (bf16 for a bf16 post_stem net), so the net casts nothing; the int8
    program renders it in f32, which K12 quantizes.

    int8=True runs the backbone through the s8-resident executor
    (`models/int8_forward.py`, kernels K11-K13) on the net's f32 parameters,
    whatever its working dtype; its bf16 logits go to K2. Activation scales
    come from `int8_scales` (a persisted tuple, `int8_forward.load_scales`),
    else from online calibration over the first `int8_calib_frames` frames'
    crops with the worst-case prior (peak-1 Gaussians on every channel: K5 on
    zero uv, every keypoint valid), tree-maximised over frames; a frame that
    calibrates then runs with the scales so far. The s8 weights are quantized
    once, at the first call.

    Returns fn(img [H, W, 3], boxes [O, 4], obj_valid [O], prior_uv
    [O, K, 2], prior_valid [O, K], has_prior=True) -> (uv [O, K, 2],
    cov [O, K, 2, 2] | None, mask_prob [O, K]). The with-prior program
    renders the prior keypoints (K5) at `net.prior_hw(input_hw)` with sigma
    `prior_sigma_for` of that size and feeds them to the net.
    has_prior=False runs the statically prior-free program (every
    non-symmetric batch and all of single-view mode): no prior render and,
    for post_stem nets, only the bias of the prior projection — the same
    output as an all-zero prior. The int8 fn also carries `int8_state`
    ("scales", "n_calib", "vq": the quantized weights).
    """
    dev = resolve_device(device)
    net = net.to(dev).eval().to(memory_format=torch.channels_last)
    input_hw = tuple(input_hw)
    phw = net.prior_hw(input_hw)

    def crop(img, boxes, obj_valid):
        return roi_ops.roi_crop_batch(
            img[None].to(dev, torch.float32), boxes[None].to(dev, torch.float32),
            obj_valid[None].to(dev), input_hw,
        )[0]

    def render(uv, valid, dtype=torch.float32):
        return hm.render_prior_heatmaps(uv.to(dev, torch.float32), valid.to(dev), hw=phw,
                                        sigma_px=hm.prior_sigma_for(phw), dtype=dtype)

    if not int8:

        @torch.inference_mode()
        def fn(img, boxes, obj_valid, prior_uv=None, prior_valid=None, has_prior=True):
            crops = crop(img, boxes, obj_valid)
            prior = render(prior_uv, prior_valid, net.prior_dtype) if has_prior else None
            out = net(crops, prior)
            return out.uv, out.cov, out.kp_mask

        fn.supports_no_prior = True
        fn.net = net
        return fn

    from ..models import int8_forward as i8

    if int8_scales is None and int8_calib_frames < 1:
        raise ValueError(
            "int8 inference needs activation scales: pass int8_scales (a "
            "persisted sidecar) or int8_calib_frames >= 1 for online "
            "calibration"
        )
    apply_i8 = i8.make_int8_apply(net)
    apply_i8_np = i8.make_int8_apply(net, no_prior=True)
    state = {}
    if int8_scales is not None:
        state["scales"] = tuple(torch.as_tensor(s, dtype=torch.float32).cpu()
                                for s in int8_scales)
        state["n_calib"] = int8_calib_frames  # calibration complete

    @torch.inference_mode()
    def fn(img, boxes, obj_valid, prior_uv=None, prior_valid=None, has_prior=True):
        crops = crop(img, boxes, obj_valid)
        if state.get("n_calib", 0) < int8_calib_frames:
            # the worst-case prior: a frame's own prior may be all zero (the
            # first frame never has one), which would collapse the prior
            # point's scale and erase all later prior feedback
            n, k = crops.shape[0], net.num_kp
            full = render(torch.zeros((n, k, 2), device=dev),
                          torch.ones((n, k), dtype=torch.bool, device=dev))
            s = i8.calibrate(net, [crops], [full])
            state["scales"] = (s if "scales" not in state
                               else tuple(map(torch.maximum, state["scales"], s)))
            state["n_calib"] = state.get("n_calib", 0) + 1
        if "vq" not in state:
            state["vq"] = i8.quantize_weights(net)
        if has_prior:
            out = apply_i8(state["vq"], state["scales"], crops, render(prior_uv, prior_valid))
        else:
            out = apply_i8_np(state["vq"], state["scales"], crops)
        return out.uv, out.cov, out.kp_mask

    fn.int8_state = state
    fn.supports_no_prior = True
    fn.net = net
    return fn


def make_batch_inference(net, input_hw=(256, 256), device="cuda", int8=False,
                         int8_scales=None):
    """The multi-view prior-free network call of the batched single-view
    evaluation (`evaluate.py --nviews 1 --batched`, `eval/batched.py`): a
    window of G views' crops in one call, as the statically prior-free
    program (single-view mode never feeds priors).

    Returns fn(imgs [G, H, W, 3], boxes [G, O, 4], valid [G, O]) ->
    (uv [G, O, K, 2], cov [G, O, K, 2, 2] | None, mask_prob [G, O, K]), on
    the device. With persisted int8 scales the per-crop outputs equal the
    per-frame program's (`make_frame_inference`) bit for bit: the int8
    executor has no term across the batch. Without, the scales come from
    the first call's crops with the worst-case all-ones prior. The
    prior-free special case of `make_multi_frame_inference`.
    """
    multi = make_multi_frame_inference(net, input_hw, device=device, int8=int8,
                                       int8_scales=int8_scales)

    def fn(imgs, boxes, valid):
        return multi(imgs, boxes, valid, has_prior=False)

    if hasattr(multi, "int8_state"):
        fn.int8_state = multi.int8_state
    return fn


def make_multi_frame_inference(net, input_hw=(256, 256), device="cuda", int8=False,
                               int8_scales=None):
    """The multi-frame network call with priors of the scene-pipelined
    evaluation (`evaluate.py --pipeline_scenes K`, `eval/pipeline.py`): one
    frame from each of G concurrently running engines in one call — K1 crops
    the G images x O boxes in one launch, K5 renders the [G*O] prior
    heatmaps, and the net (f32 / bf16, or with `int8` the s8-resident
    executor, K11-K13) runs the flattened [G*O] crop batch.

    Returns fn(imgs [G, H, W, 3], boxes [G, O, 4], valid [G, O], prior_uv
    [G, O, K, 2], prior_valid [G, O, K], has_prior=True) -> (uv
    [G, O, K, 2], cov [G, O, K, 2, 2] | None, mask_prob [G, O, K]), on the
    device; inputs may be numpy arrays or tensors. has_prior=False runs the
    statically prior-free program (the prior arguments may then be None),
    whose rows equal the with-prior program's on a zero prior (the port keeps
    the prior projection's bias there, `make_frame_inference`). Scales as
    `make_batch_inference`: `int8_scales` (a persisted sidecar), else
    `int8_forward.calibrate` on the first call's crops with the worst-case
    all-ones prior. The int8 fn carries `int8_state` ("scales", "vq").
    """
    dev = resolve_device(device)
    net = net.to(dev).eval().to(memory_format=torch.channels_last)
    input_hw = tuple(input_hw)
    phw = net.prior_hw(input_hw)
    f32 = torch.float32

    def crop(imgs, boxes, valid):
        crops = roi_ops.roi_crop_batch(
            torch.as_tensor(imgs).to(dev, f32), torch.as_tensor(boxes).to(dev, f32),
            torch.as_tensor(valid).to(dev), input_hw)
        return crops.reshape((-1,) + crops.shape[2:])  # [G*O, h, w, 3]

    def render(prior_uv, prior_valid, dtype=f32):
        prior_uv = torch.as_tensor(prior_uv).to(dev, f32)
        nk = prior_uv.shape[-2]
        return hm.render_prior_heatmaps(
            prior_uv.reshape(-1, nk, 2), torch.as_tensor(prior_valid).to(dev).reshape(-1, nk),
            hw=phw, sigma_px=hm.prior_sigma_for(phw), dtype=dtype)  # [G*O, ph, pw, K]

    def unflatten(out, g, o):
        rows = lambda a: None if a is None else a.reshape((g, o) + a.shape[1:])
        return rows(out.uv), rows(out.cov), rows(out.kp_mask)

    if not int8:

        @torch.inference_mode()
        def fn(imgs, boxes, valid, prior_uv=None, prior_valid=None, has_prior=True):
            g, o = boxes.shape[:2]
            crops = crop(imgs, boxes, valid)
            out = net(crops, render(prior_uv, prior_valid, net.prior_dtype) if has_prior
                      else None)
            return unflatten(out, g, o)

        fn.supports_no_prior = True
        return fn

    from ..models import int8_forward as i8

    apply_p = i8.make_int8_apply(net)
    apply_np = i8.make_int8_apply(net, no_prior=True)
    state = {}
    if int8_scales is not None:
        state["scales"] = tuple(torch.as_tensor(s, dtype=f32).cpu() for s in int8_scales)

    @torch.inference_mode()
    def fn(imgs, boxes, valid, prior_uv=None, prior_valid=None, has_prior=True):
        g, o = boxes.shape[:2]
        crops = crop(imgs, boxes, valid)
        if "scales" not in state:
            n, k = crops.shape[0], net.num_kp
            full = render(torch.zeros((n, k, 2), device=dev),
                          torch.ones((n, k), dtype=torch.bool, device=dev))
            state["scales"] = i8.calibrate(net, [crops], [full])
        if "vq" not in state:
            state["vq"] = i8.quantize_weights(net)
        if has_prior:
            out = apply_p(state["vq"], state["scales"], crops, render(prior_uv, prior_valid))
        else:
            out = apply_np(state["vq"], state["scales"], crops)
        return unflatten(out, g, o)

    fn.int8_state = state
    fn.supports_no_prior = True
    return fn
