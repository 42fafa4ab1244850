"""Per-frame device programs of the single-view SLAM front end.

Port of the single-view part of `suo_slam_tpu/slam/kernels.py`:

- `make_frame_inference`: ROI crop (K1) -> PkpNet -> heatmap readout (K2)
  + validity head, for every object of a frame in one call;
- `frontend_step`: keypoint filter -> batched PnP (`pnp_frame`, K3) ->
  information matrices, with no host round-trip between the stages.

Camera-pose RANSAC, `reinit_counts` and `tracking_tail` belong to SLAM mode
and are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..ops import roi as roi_ops
from ..solvers import pnp as pnp_mod

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


def frontend_step(uv, cov, mask_prob, model_kps, model_masks, cam_k4, diams,
                  hyp_sampler, manual_kp_std: float, bbox_thresh: float,
                  kp_var_thresh: float, mask_thresh: float, n_hyp: int = 64):
    """Fused per-group front end without camera RANSAC: keypoint filter ->
    PnP -> information. `hyp_sampler(keep [O, K], n_hyp) -> idx
    [O, n_hyp, 4]` draws the RANSAC hypotheses. Returns a dict of small
    per-frame tensors that the caller reads back in one transfer."""
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
    return {
        "uv": uv, "cov": cov, "keep": keep, "info": info,
        "T_pnp": T_pnp, "pnp_ok": pnp_ok,
        "std_sum": std_sum, "std_cnt": std_cnt,
    }


def make_frame_inference(net, input_hw=(256, 256), device="cuda"):
    """The fused per-frame network call in f32.

    `net` is a `models.pkpnet.PkpNet` holding its weights (see
    `models.convert.from_jax_variables`); it is moved to `device`, put in
    eval mode and `channels_last` memory.

    Returns fn(img [H, W, 3], boxes [O, 4], obj_valid [O], prior_uv
    [O, K, 2], prior_valid [O, K], has_prior=True) -> (uv [O, K, 2],
    cov [O, K, 2, 2] | None, mask_prob [O, K]). has_prior=False runs the
    statically prior-free program (every single-view frame): no prior render
    and, for post_stem nets, only the bias of the prior projection. The
    with-prior program needs `render_prior_heatmaps`, which comes with the
    SLAM slice, and raises until then.
    """
    dev = resolve_device(device)
    net = net.to(dev).eval().to(memory_format=torch.channels_last)
    input_hw = tuple(input_hw)

    @torch.inference_mode()
    def fn(img, boxes, obj_valid, prior_uv=None, prior_valid=None, has_prior=True):
        if has_prior:
            raise NotImplementedError(
                "with-prior frame inference needs render_prior_heatmaps "
                "(ROADMAP B2, SLAM slice); single-view frames pass has_prior=False"
            )
        crops = roi_ops.roi_crop_batch(
            img[None].to(dev, torch.float32), boxes[None].to(dev, torch.float32),
            obj_valid[None].to(dev), input_hw,
        )[0]
        out = net(crops)
        return out.uv, out.cov, out.kp_mask

    fn.supports_no_prior = True
    fn.net = net
    return fn
