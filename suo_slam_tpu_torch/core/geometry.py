"""Projective geometry of the NDC pipeline — the part the single-view slice
uses. Port of `suo_slam_tpu/core/geometry.py` (`k_to_cam4`, `project_k4`);
the engine's numpy `_fix_K_np` stays in `slam/engine.py`, as there.

Keypoints live in bbox-normalized device coordinates (NDC): for a pixel
(u, v) inside a bbox (x, y, w, h), ndc_u = 2 (u - x) / w - 1 and
ndc_v = 1 - 2 (v - y) / h.
"""

from __future__ import annotations

import torch


def project_k4(cam_k: torch.Tensor, pts_cam: torch.Tensor):
    """Project with diagonal intrinsics cam_k = (fx, fy, cx, cy).
    Returns (uv [..., 2], z [...])."""
    z = pts_cam[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = cam_k[..., 0] * pts_cam[..., 0] * iz + cam_k[..., 2]
    v = cam_k[..., 1] * pts_cam[..., 1] * iz + cam_k[..., 3]
    return torch.stack([u, v], dim=-1), z


def k_to_cam4(K: torch.Tensor) -> torch.Tensor:
    """Extract (fx, fy, cx, cy) from a diagonal-form 3x3 K."""
    return torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1)

