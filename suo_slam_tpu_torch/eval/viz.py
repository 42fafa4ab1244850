"""Visualization: keypoints, covariance ellipses, boxes, pose reprojections.

The port's copy of the JAX package's `eval/viz.py` (the reference drawing
utilities `lib/utils/utils.py:181-354` draw_points / make_kp_viz /
bbox_color and the 3-panel composition of `lib/object_slam.py:175-309`),
with the same functions and arithmetic. Its OpenCV calls go through
`eval/raster.py`, which gives OpenCV 5.0's pixels in numpy. Host work on
numpy images, evaluation tier only: nothing here touches the device.
"""

from __future__ import annotations

import numpy as np

from ..kp import config as kp_config
from . import raster


def _to_u8(img):
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (255 * np.clip(img, 0, 1)).astype(np.uint8)
    return np.ascontiguousarray(img)


def bbox_color(obj_id: int, num_obj: int = 30) -> list:
    """Deterministic distinct BGR color per object id (rainbow ramp)."""
    hue = int(179 * ((obj_id - 1) % num_obj) / num_obj)
    hsv = np.uint8([[[hue, 255, 255]]])
    return [int(v) for v in raster.hsv2bgr_u8(hsv)[0, 0]]


def ndc_to_px(xy, hw):
    h, w = hw
    x = np.clip(xy[..., 0], -1, 1) * (w / 2.0) + w / 2.0 - 0.5
    y = h - 0.5 - (np.clip(xy[..., 1], -1, 1) * (h / 2.0) + h / 2.0)
    return np.stack([x, y], -1)


def draw_points(rgb, xy, cols, cov=None, ndc=False, rad=4):
    """Draw keypoints (and 3-sigma/3 covariance ellipses) in place.

    xy: [K, 2] pixel (or NDC if ndc=True) coords; cols: [K, 3] BGR;
    cov: optional [K, 2, 2] in PIXEL units (like `utils.py:236-241`).
    """
    h, w = rgb.shape[:2]
    if ndc:
        xy = ndc_to_px(xy, (h, w))
    for j in range(len(xy)):
        x, y = int(round(xy[j, 0])), int(round(xy[j, 1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        col = [int(v) for v in np.asarray(cols[j]).tolist()]
        raster.circle(rgb, (x, y), int(round(1.3 * rad)), [0, 0, 0])
        raster.circle(rgb, (x, y), rad, col)
        if cov is not None:
            lamb, v = np.linalg.eigh(np.asarray(cov[j], np.float64))
            lamb = np.maximum(lamb[::-1], 0.0)  # descending
            v = v[:, ::-1]
            angle = np.degrees(np.arctan2(v[1, 0], v[0, 0]))
            axes = (
                int(round((2.0 / 3.0) * np.sqrt(5.991 * lamb[0]))),
                int(round((2.0 / 3.0) * np.sqrt(5.991 * lamb[1]))),
            )
            raster.ellipse(rgb, (x, y), axes, angle, col)
    return rgb


def draw_bbox(rgb, bbox, obj_id, label=None):
    x1, y1, x2, y2 = [int(round(v)) for v in bbox]
    col = bbox_color(obj_id)
    raster.rectangle(rgb, (x1, y1), (x2, y2), col)
    raster.put_text(rgb, label or f"obj {obj_id}", (x1, max(12, y1 - 4)), col)
    return rgb


def blend_prior(rgb, prior_chw_or_hwk):
    """Alpha-blend colored prior heatmaps over the image
    (`utils.py:342-351`). Accepts [K, H, W] or [H, W, K]."""
    p = np.asarray(prior_chw_or_hwk, np.float32)
    if p.ndim == 3 and p.shape[0] == kp_config.num_kp():
        p = p.transpose(1, 2, 0)
    cols = kp_config.kp_colors().astype(np.float32)  # [K, 3] BGR
    colored = np.clip(p @ cols, 0, 255).astype(np.uint8)
    alpha = np.clip(p.max(-1), 0, 1)[..., None]
    return ((1 - alpha) * rgb + alpha * colored).astype(np.uint8)


def project_model_points(K, T_OtoC, pts, hw):
    p = pts @ np.asarray(T_OtoC)[:3, :3].T + np.asarray(T_OtoC)[:3, 3]
    z = p[:, 2]
    uvw = p @ np.asarray(K).T
    uv = uvw[:, :2] / np.where(np.abs(uvw[:, 2:3]) < 1e-9, 1e-9, uvw[:, 2:3])
    ok = (
        (z > 0)
        & (uv[:, 0] >= 0) & (uv[:, 0] < hw[1])
        & (uv[:, 1] >= 0) & (uv[:, 1] < hw[0])
    )
    return uv[ok].astype(int)


def draw_pose_points(rgb, K, T_OtoC, pts, obj_id, step=7):
    """Scatter the (subsampled) model cloud projected under a pose."""
    uv = project_model_points(K, T_OtoC, pts[::step], rgb.shape[:2])
    col = bbox_color(obj_id)
    rgb[uv[:, 1], uv[:, 0]] = col
    return rgb


def make_frame_viz(
    img,
    detections: dict,
    poses: dict,
    K,
    mesh_db=None,
    kp_cov_scale=None,
    priors=None,
):
    """3-panel view of one frame (`lib/object_slam.py:259-274` composition):
    [detections + keypoints | pose reprojection | prior blend].

    detections: obj_id -> dict with 'bbox' [4], 'uv' [K, 2] NDC in bbox,
      optional 'cov' [K, 2, 2] NDC, 'kp_mask' [K].
    poses: obj_id -> T_OtoC (4x4) or None.
    """
    rgb = _to_u8(img)
    h, w = rgb.shape[:2]
    panel1 = rgb.copy()
    cols_all = kp_config.kp_colors()
    for obj_id, det in detections.items():
        bbox = det["bbox"]
        draw_bbox(panel1, bbox, obj_id)
        m = det.get("kp_mask")
        if m is None:
            m = np.ones(det["uv"].shape[0], bool)
        x1, y1, x2, y2 = bbox
        bw, bh = x2 - x1, y2 - y1
        uv = det["uv"][m]
        px = np.stack(
            [
                x1 + (uv[:, 0] + 1) * bw / 2.0,
                y1 + (1 - uv[:, 1]) * bh / 2.0,
            ], -1,
        )
        cov_px = None
        if det.get("cov") is not None:
            S = np.diag([bw / 2.0, bh / 2.0])
            cov_px = S @ det["cov"][m] @ S.T
        draw_points(panel1, px, cols_all[m], cov=cov_px)

    panel2 = rgb.copy()
    if mesh_db is not None:
        for obj_id, T in poses.items():
            if T is not None:
                draw_pose_points(panel2, K, T, mesh_db.points[obj_id], obj_id)

    panels = [panel1, panel2]
    if priors is not None:
        panels.append(blend_prior(rgb.copy(), priors))
    return np.concatenate(panels, axis=1)


def _bbox_ndc_to_px(uv, bbox):
    """Bbox-NDC keypoints -> full-image pixel coords (y-up NDC convention,
    `lib/utils/utils.py:416-429`)."""
    x1, y1, x2, y2 = bbox
    bw, bh = x2 - x1, y2 - y1
    return np.stack(
        [x1 + (uv[..., 0] + 1) * bw / 2.0, y1 + (1 - uv[..., 1]) * bh / 2.0],
        -1,
    )


def render_prior_px(hw, centers_px, kp_idx, sigma_px=14.0):
    """Host-side [H, W, num_kp] prior map from pixel centers (viz only).

    Matches the reference's full-resolution prior Gaussians
    (`lib/utils/utils.py:364-368,398-411`: blur-derived sigma ~14 px,
    peak-normalized to 1).
    """
    h, w = hw
    out = np.zeros((h, w, kp_config.num_kp()), np.float32)
    r = int(np.ceil(3.5 * sigma_px))
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    patch = np.exp(-(xs**2 + ys**2) / (2.0 * sigma_px**2))
    for (cx, cy), k in zip(np.asarray(centers_px), np.asarray(kp_idx)):
        cx, cy = int(round(cx)), int(round(cy))
        if not (-r < cx < w + r and -r < cy < h + r):
            continue
        x1, x2 = max(0, cx - r), min(w, cx + r + 1)
        y1, y2 = max(0, cy - r), min(h, cy + r + 1)
        out[y1:y2, x1:x2, k] = np.maximum(
            out[y1:y2, x1:x2, k],
            patch[y1 - (cy - r) : y2 - (cy - r), x1 - (cx - r) : x2 - (cx - r)],
        )
    return out


def make_extra_viz(img, detections, poses, K, mesh_db=None, viz_cov=False):
    """Per-object figure panels (`lib/object_slam.py:277-308`): full-frame
    'bbox_input' plus, per object, 'viz_obj_<id>_input' (crop + prior
    blend), 'viz_obj_<id>_output' (crop + keypoints, cov ellipses when
    viz_cov), and 'viz_obj_<id>_overlay' (model cloud at the estimated
    pose, K shifted to crop coords). Returns {name: RGB uint8 image}.

    detections: as `make_frame_viz`, optionally with 'prior_uv' [K, 2]
    bbox-NDC and 'model_mask' [K] (which channels the prior covered).
    """
    rgb = _to_u8(img)
    h, w = rgb.shape[:2]
    out = {}
    panel = rgb.copy()
    for obj_id, det in detections.items():
        draw_bbox(panel, det["bbox"], obj_id)
    out["bbox_input"] = panel
    cols_all = kp_config.kp_colors()
    for obj_id, det in detections.items():
        bbox = det["bbox"]
        x1, y1 = max(0, int(round(bbox[0]))), max(0, int(round(bbox[1])))
        x2, y2 = min(w, int(round(bbox[2]))), min(h, int(round(bbox[3])))
        if x2 <= x1 or y2 <= y1:
            continue
        crop = rgb[y1:y2, x1:x2]
        # input: crop, with the prior blend when the object was given one
        inp = crop.copy()
        if det.get("prior_uv") is not None:
            pm = det.get("model_mask")
            if pm is None:
                pm = np.ones(det["prior_uv"].shape[0], bool)
            centers = _bbox_ndc_to_px(det["prior_uv"][pm], bbox)
            centers -= np.array([x1, y1], np.float32)
            prior = render_prior_px(crop.shape[:2], centers, np.where(pm)[0])
            inp = blend_prior(inp, prior)
        out[f"viz_obj_{obj_id}_input"] = inp
        # output: keypoints (+ covariance ellipses when viz_cov)
        outp = crop.copy()
        m = det.get("kp_mask")
        if m is None:
            m = np.ones(det["uv"].shape[0], bool)
        px = _bbox_ndc_to_px(det["uv"][m], bbox) - np.array([x1, y1], np.float32)
        cov_px = None
        if viz_cov and det.get("cov") is not None:
            bw, bh = bbox[2] - bbox[0], bbox[3] - bbox[1]
            S = np.diag([bw / 2.0, bh / 2.0])
            cov_px = S @ det["cov"][m] @ S.T
        draw_points(outp, px, cols_all[m], cov=cov_px)
        out[f"viz_obj_{obj_id}_output"] = outp
        # overlay: CAD cloud at the estimated pose (`object_slam.py:303-308`)
        T = poses.get(obj_id)
        if T is not None and mesh_db is not None:
            Kc = np.asarray(K, np.float64).copy()
            Kc[0, 2] -= x1
            Kc[1, 2] -= y1
            ov = crop.copy()
            draw_pose_points(ov, Kc, T, np.asarray(mesh_db.points[obj_id]), obj_id)
            out[f"viz_obj_{obj_id}_overlay"] = ov
    return out
