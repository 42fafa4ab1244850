"""Per-frame device programs of the SLAM front end and tracking tail.

Port of `suo_slam_tpu/slam/kernels.py`:

- `make_frame_inference`: ROI crop (K1) -> prior render (K5) -> PkpNet ->
  heatmap readout (K2) + validity head, for every object of a frame in one
  call; `has_prior=False` is the statically prior-free program; `int8=True`
  runs the s8-resident executor (K11-K13) with persisted or online-calibrated
  scales;
- `frontend_step`: keypoint filter -> batched PnP (`pnp_frame`, K3) ->
  information -> (optionally) camera-pose RANSAC, with no host round-trip
  between the stages;
- `chi2_counts` (kernel K6) under `camera_pose_ransac` and `reinit_counts`;
- `tracking_tail`: the symmetric group's scatter into the device mirrors ->
  late init -> re-init vote -> tracking BA (K4, K7), ending in the frame's
  second host read-back.
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
    s2 = torch.tensor(manual_kp_std, dtype=dtype, device=device) ** 2
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


def pnp_frame(model_kps, uv, kp_mask, cam_k4, diameters, idx):
    """Batched per-object PnP with the acceptance gates: success, >= 4
    inliers and t_z > 0.5 * diameter. idx [O, n_hyp, 4] are the hypothesis
    point indices. Returns (T_OtoC [O, 4, 4], ok [O]); failed slots hold
    identity."""
    y_norm = (uv - cam_k4[:, None, 2:]) / cam_k4[:, None, :2]
    res = pnp_mod.pnp_ransac_batch(model_kps, y_norm, kp_mask, idx)
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


def chi2_counts(T_OtoC, model_kp, uv, info, mask, cam_k4,
                chi2_thresh: float = CHI2_THRESH_2DOF, per_object: bool = False):
    """Masked chi2 inlier counts (see `chi2_counts_plain`): K6 on CUDA
    tensors, the plain version on CPU tensors."""
    if uv.device.type == "cpu":
        return chi2_counts_plain(T_OtoC, model_kp, uv, info, mask, cam_k4,
                                 chi2_thresh, per_object)
    if uv.device.type != "cuda":
        raise ValueError(f"chi2_counts: unsupported device {uv.device}")
    return _chi2_counts_cuda(T_OtoC, model_kp, uv, info, mask, cam_k4, chi2_thresh,
                             per_object)


def camera_pose_ransac(T_pnp, pnp_ok, T_obj, obj_ok, model_kp, uv, info, inliers,
                       cam_k4, min_num_inliers: int = 4):
    """RANSAC over per-object camera-pose hypotheses. Hypothesis j is
    T_GtoC = T_pnp[j] inv(T_obj[j]); each is scored (K6) against every
    object's inlier keypoints of this frame; an object whose detection has
    no inlier does not score. T_pnp [O, 4, 4], pnp_ok [O], T_obj [O, 4, 4]
    (T_OtoG), obj_ok [O], model_kp [O, K, 3], uv [O, K, 2],
    info [O, K, 2, 2], inliers [O, K], cam_k4 [O, 4].
    Returns (T_GtoC [4, 4], best count, ok), all on the device."""
    cand = pnp_ok & obj_ok
    T_hyp = T_pnp @ lie.invert_SE3(T_obj)                 # [H=O, 4, 4]
    T_OtoC_hyp = T_hyp[:, None] @ T_obj[None, :]          # [H, O, 4, 4]
    score_mask = inliers & (torch.any(inliers, -1) & cand)[:, None]
    counts = chi2_counts(T_OtoC_hyp, model_kp, uv[None], info[None], score_mask[None],
                         cam_k4[None])                    # [H]
    counts = torch.where(cand, counts, -1)
    best = torch.argmax(counts)  # first maximum
    best_count = counts[best]
    ok = best_count >= min_num_inliers
    eye = torch.eye(4, dtype=T_hyp.dtype, device=T_hyp.device)
    return torch.where(ok, T_hyp[best], eye), best_count, ok


def reinit_counts(T_pnp_OtoG, T_est_OtoG, cam_T, cam_valid, model_kp, uv, info,
                  valid, cam_k4):
    """chi2 inlier counts over the last N views of this frame's PnP poses and
    of the map estimates, per object: T_pnp_OtoG / T_est_OtoG [O, 4, 4],
    cam_T [N, 4, 4], cam_valid [N], model_kp [O, K, 3], uv [N, O, K, 2],
    info [N, O, K, 2, 2], valid [N, O, K] (detected keypoints, not inlier
    gated), cam_k4 [N, O, 4]. Both pose sets share one K6 launch.
    Returns (count_pnp [O], count_est [O])."""
    mask = valid & cam_valid[:, None, None]
    T = torch.cat([cam_T[:, None] @ T_pnp_OtoG[None], cam_T[:, None] @ T_est_OtoG[None]])
    counts = chi2_counts(T, model_kp, uv, info, mask, cam_k4, per_object=True)  # [2, O]
    return counts[0], counts[1]


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
    RANSAC. `hyp_sampler(keep [O, K], n_hyp) -> idx [O, n_hyp, 4]` draws the
    RANSAC hypotheses. For camera RANSAC the frame's results are scattered
    into slot-indexed [O] rows (slots [ob], a padded slot = O is dropped) and
    scored against the map poses obj_T [O, 4, 4]. `keep_in` [O, K]
    (debug_gt_kp: the dataset's keypoint masks) replaces the filter.
    Returns a dict of small per-frame tensors that the caller reads back in
    one transfer."""
    if keep_in is not None:
        keep = keep_in
    else:
        keep = filter_keypoints(uv, cov, mask_prob, model_masks,
                                bbox_thresh, kp_var_thresh, mask_thresh)
    idx = hyp_sampler(keep, n_hyp)
    T_pnp, pnp_ok = pnp_frame(model_kps, uv, keep, cam_k4, diams, idx)
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
        O, K = obj_T.shape[0], uv.shape[1]
        dt, dev = uv.dtype, uv.device
        rows = lambda shape, src, dtype=dt: _scatter_rows(
            torch.zeros((O,) + shape, dtype=dtype, device=dev), slots, src)
        T_row = _scatter_rows(torch.eye(4, dtype=dt, device=dev).repeat(O, 1, 1),
                              slots, T_pnp)
        ok_row = rows((), pnp_ok, torch.bool)
        T_cam, cam_count, cam_ok = camera_pose_ransac(
            T_row, ok_row, obj_T, obj_active & ok_row, model_kp_full,
            rows((K, 2), uv), rows((K, 2, 2), info), rows((K,), keep, torch.bool),
            rows((4,), cam_k4), min_num_inliers,
        )
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
        cs = reinit["cs"]
        n_pnp, n_est = reinit_counts(
            T_pnp_G, obj_T, reinit["cam_T_w"], reinit["cam_valid"], model_kp_m,
            uv_m[cs], info_m[cs], valid_m[cs], cam_k4_m[cs],
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
    working dtype (`PkpNet(dtype=...)`, f32 or bf16); the crops, the prior
    render and the readout stay f32.

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

    def render(uv, valid):
        return hm.render_prior_heatmaps(uv.to(dev, torch.float32), valid.to(dev), hw=phw,
                                        sigma_px=hm.prior_sigma_for(phw))

    if not int8:

        @torch.inference_mode()
        def fn(img, boxes, obj_valid, prior_uv=None, prior_valid=None, has_prior=True):
            crops = crop(img, boxes, obj_valid)
            prior = render(prior_uv, prior_valid) if has_prior else None
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
