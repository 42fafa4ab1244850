"""Projective geometry and the NDC conventions of the pipeline. Port of
`suo_slam_tpu/core/geometry.py`, with its names and broadcasting; the
engine's numpy `_fix_K_np` stays in `slam/engine.py`, as there.

Keypoints live in bbox-normalized device coordinates (NDC): for a pixel
(u, v) inside a bbox (x, y, w, h), ndc_u = 2 (u - x) / w - 1 and
ndc_v = 1 - 2 (v - y) / h.
"""

from __future__ import annotations

import torch


def transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3/4, 4] pose(s) to [..., N, 3] points; missing batch dims
    of T broadcast over the leading dims of pts."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    while R.ndim - 2 < pts.ndim - 1:
        R = R[..., None, :, :]
        t = t[..., None, :]
    return (pts[..., None, :] @ R.transpose(-1, -2))[..., 0, :] + t


def project(K: torch.Tensor, pts_cam: torch.Tensor):
    """Project camera-frame points [..., N, 3] with a (possibly full)
    [..., 3, 3] K. Returns (uv [..., N, 2], z [..., N]), z the third row of
    K @ p before the division."""
    uvw = pts_cam @ K.transpose(-1, -2)
    z = uvw[..., 2]
    uv = uvw[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
    return uv, z


def project_k4(cam_k: torch.Tensor, pts_cam: torch.Tensor):
    """Project with diagonal intrinsics cam_k = (fx, fy, cx, cy).
    Returns (uv [..., 2], z [...])."""
    z = pts_cam[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = cam_k[..., 0] * pts_cam[..., 0] * iz + cam_k[..., 2]
    v = cam_k[..., 1] * pts_cam[..., 1] * iz + cam_k[..., 3]
    return torch.stack([u, v], dim=-1), z


def fix_K_for_bbox_ndc(K: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Camera matrix projecting camera-frame points into the NDC of bbox
    [..., 4] = (x1, y1, x2, y2): K' = S @ T @ K, T the shift by (-x1, -y1),
    S = diag(2/w, -2/h) with (-1, +1) offsets."""
    x1, y1, x2, y2 = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    w = x2 - x1
    h = y2 - y1
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    T = torch.stack([torch.stack([ones, zeros, -x1], -1),
                     torch.stack([zeros, ones, -y1], -1),
                     torch.stack([zeros, zeros, ones], -1)], dim=-2)
    S = torch.stack([torch.stack([2.0 / w, zeros, -ones], -1),
                     torch.stack([zeros, -2.0 / h, ones], -1),
                     torch.stack([zeros, zeros, ones], -1)], dim=-2)
    return S @ T @ K.to(S.dtype)


def k_to_cam4(K: torch.Tensor) -> torch.Tensor:
    """Extract (fx, fy, cx, cy) from a diagonal-form 3x3 K."""
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)


def ndc_to_pixels(uv_ndc: torch.Tensor, img_hw: tuple[int, int]) -> torch.Tensor:
    """NDC -> pixel coordinates of an (h, w) image:
    x = clip(u) w/2 + w/2 - 0.5, y = h - 0.5 - (clip(v) h/2 + h/2)."""
    h, w = img_hw
    u = torch.clamp(uv_ndc[..., 0], -1.0, 1.0)
    v = torch.clamp(uv_ndc[..., 1], -1.0, 1.0)
    x = u * (w / 2.0) + (w / 2.0) - 0.5
    y = h - 0.5 - (v * (h / 2.0) + (h / 2.0))
    return torch.stack([x, y], dim=-1)


def pixels_to_ndc(xy: torch.Tensor, img_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of `ndc_to_pixels` (without the clip)."""
    h, w = img_hw
    u = (xy[..., 0] + 0.5 - w / 2.0) / (w / 2.0)
    v = (h - 0.5 - xy[..., 1] - h / 2.0) / (h / 2.0)
    return torch.stack([u, v], dim=-1)


def normalize_image_points(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel / NDC uv [..., 2] -> pinhole-normalized image coordinates
    (K^-1 applied; a full 3x3 K)."""
    Kinv = torch.linalg.inv(K)
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    xyw = uv1 @ Kinv.transpose(-1, -2)
    return xyw[..., :2] / xyw[..., 2:3]


def bbox_xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x, y, x + w, y + h], dim=-1)


def homography_ndc_to_full(K_full: torch.Tensor, K_bbox: torch.Tensor) -> torch.Tensor:
    """H = K_full @ inv(K_bbox): maps bbox-NDC uv to full-image pixels
    (apply as uv @ H[:2, :2].T + H[:2, 2])."""
    return K_full @ torch.linalg.inv(K_bbox)


def apply_homography_2d(H: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Affine-apply the top 2x3 of H [..., 3, 3] to [..., N, 2] points."""
    return uv @ H[..., :2, :2].transpose(-1, -2) + H[..., None, :2, 2]
