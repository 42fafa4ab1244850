"""Z-buffer rasterizer (host numpy), for the VSD metric and the labeling
tools.

The port's own copy of `suo_slam_tpu/eval/render.py`: depth, and the
flat-shaded RGB of the labeling and symmetry-choice tools. Triangles bucketed by the power-of-2 size of their clipped pixel bbox, each
bucket's barycentrics evaluated over a shared pixel lattice at once, one
scatter-min into the flat z-buffer; pixel-center sampling and
perspective-correct 1/z interpolation. BOP convention: depth images hold the
camera-frame z coordinate (mm), not ray length.
"""

from __future__ import annotations

import numpy as np


def _rasterize(verts, faces, K, T_OtoC, hw, near=10.0):
    """Z-buffer rasterization, vectorized over triangles.

    Triangles are bucketed by the power-of-2 size of their clipped pixel
    bbox; each bucket evaluates barycentrics for all its triangles over a
    shared [F_b, tile*tile] pixel lattice at once, then resolves visibility
    with a single scatter-min into the flat z-buffer (`np.minimum.at`). A
    second pass recovers the winning face index by z-equality.

    Returns ([H,W] f32 depth with 0=miss, [H,W] int32 face index, -1=miss).
    """
    h, w = hw
    depth = np.zeros((h, w), np.float32)
    fid = np.full((h, w), -1, np.int32)
    if faces is None or len(faces) == 0 or len(verts) == 0:
        return depth, fid
    R, t = np.asarray(T_OtoC)[:3, :3], np.asarray(T_OtoC)[:3, 3]
    p_cam = verts @ R.T + t  # [V, 3]
    z = p_cam[:, 2]
    uvw = p_cam @ np.asarray(K).T
    safe = np.where(np.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
    uv = uvw[:, :2] / safe[:, None]

    tri_uv = uv[faces]        # [F, 3, 2]
    tri_z = z[faces]          # [F, 3]
    # cull triangles fully behind the near plane or outside the image
    ok = np.all(tri_z > near, axis=1)
    ok &= np.any(tri_uv[..., 0] < w, axis=1) & np.any(tri_uv[..., 0] >= 0, axis=1)
    ok &= np.any(tri_uv[..., 1] < h, axis=1) & np.any(tri_uv[..., 1] >= 0, axis=1)

    # degenerate (zero-area in screen space) triangles never shade a pixel
    a = tri_uv[:, 0]
    det = (
        (tri_uv[:, 1, 0] - a[:, 0]) * (tri_uv[:, 2, 1] - a[:, 1])
        - (tri_uv[:, 1, 1] - a[:, 1]) * (tri_uv[:, 2, 0] - a[:, 0])
    )
    ok &= np.abs(det) >= 1e-12

    # clipped integer pixel bboxes
    x0 = np.maximum(0, np.floor(tri_uv[..., 0].min(1)).astype(np.int64))
    x1 = np.minimum(w - 1, np.ceil(tri_uv[..., 0].max(1)).astype(np.int64))
    y0 = np.maximum(0, np.floor(tri_uv[..., 1].min(1)).astype(np.int64))
    y1 = np.minimum(h - 1, np.ceil(tri_uv[..., 1].max(1)).astype(np.int64))
    ok &= (x1 >= x0) & (y1 >= y0)

    zbuf = np.full(h * w, np.inf, np.float32)
    fid_flat = fid.reshape(-1)
    side = np.maximum(x1 - x0, y1 - y0) + 1  # bbox edge in pixels

    # pass 1: scatter-min depth per bucket; remember per-bucket candidates
    passes = []
    tile = 1
    remaining = ok.copy()
    while remaining.any():
        sel = remaining & (side <= tile)
        remaining &= ~sel
        tile_next = tile * 2
        if not sel.any():
            tile = tile_next
            continue
        # bound the [F_b, tile^2] working set (large-bbox triangles are rare
        # but one whole-image triangle at tile=1024 would be 8 MB a row)
        chunk = max(1, 4_000_000 // (tile * tile))
        idx_all = np.where(sel)[0]
        for idx in np.array_split(idx_all, max(1, len(idx_all) // chunk)):
            passes.append(_shade_bucket(
                idx, tile, x0, x1, y0, y1, tri_uv, tri_z, det, w, zbuf
            ))
        tile = tile_next

    # pass 2: the candidate that equals the final z-buffer wins its pixel
    for flat, zv, fids in passes:
        win = zv == zbuf[flat]
        fid_flat[flat[win]] = fids[win]

    hit = np.isfinite(zbuf).reshape(h, w)
    depth[hit] = zbuf.reshape(h, w)[hit]
    return depth, fid


def _shade_bucket(idx, tile, x0, x1, y0, y1, tri_uv, tri_z, det, w, zbuf):
    """Rasterize one bucket of triangles whose bboxes fit a tile x tile
    lattice: vectorized barycentrics + one scatter-min into the flat
    z-buffer. Returns the candidate set for the face-index pass."""
    lin = np.arange(tile * tile)
    px = x0[idx, None] + lin[None, :] % tile  # [F_b, tile^2]
    py = y0[idx, None] + lin[None, :] // tile
    valid = (px <= x1[idx, None]) & (py <= y1[idx, None])
    cx = px + 0.5
    cy = py + 0.5
    A = tri_uv[idx, 0]
    B = tri_uv[idx, 1]
    C = tri_uv[idx, 2]
    d = det[idx][:, None]
    l1 = ((cx - A[:, :1]) * (C[:, 1:] - A[:, 1:])
          - (cy - A[:, 1:]) * (C[:, :1] - A[:, :1])) / d
    l2 = -((cx - A[:, :1]) * (B[:, 1:] - A[:, 1:])
           - (cy - A[:, 1:]) * (B[:, :1] - A[:, :1])) / d
    l0 = 1.0 - l1 - l2
    valid &= (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
    # perspective-correct depth: interpolate 1/z
    fz = tri_z[idx]
    iz = l0 / fz[:, :1] + l1 / fz[:, 1:2] + l2 / fz[:, 2:]
    valid &= iz > 1e-12
    zpix = (1.0 / np.maximum(iz, 1e-12)).astype(np.float32)
    flat = (py * w + px)[valid]
    zv = zpix[valid]
    np.minimum.at(zbuf, flat, zv)
    fids = np.broadcast_to(idx[:, None], valid.shape)[valid]
    return flat, zv, fids


def render_depth(
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    T_OtoC: np.ndarray,
    hw: tuple[int, int],
    near: float = 10.0,
) -> np.ndarray:
    """Render the depth map of one mesh under pose T_OtoC.

    Args:
      verts: [V, 3] object-frame vertices (mm).
      faces: [F, 3] int triangle indices.
      K: [3, 3] intrinsics. T_OtoC: [3/4, 4]. hw: (height, width).
    Returns:
      [H, W] f32 depth (camera z, mm); 0 where no surface.
    """
    depth, _ = _rasterize(verts, faces, K, T_OtoC, hw, near)
    return depth


def render_shaded(
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    T_OtoC: np.ndarray,
    hw: tuple[int, int],
    color=(200, 200, 200),
    light_dir=(0.3, -0.4, -1.0),
    ambient: float = 0.35,
    near: float = 10.0,
):
    """Flat-shaded Lambertian RGB render (+ depth) of one mesh: per-face
    normal in the camera frame, intensity = ambient + (1 - ambient) |n . l|
    (double-sided: the winding of BOP models is not consistent), one base
    colour.

    Returns ([H, W, 3] uint8 RGB with black background, [H, W] f32 depth).
    """
    depth, fid = _rasterize(verts, faces, K, T_OtoC, hw, near)
    img = np.zeros(hw + (3,), np.uint8)
    if faces is None or len(faces) == 0 or not (fid >= 0).any():
        return img, depth
    R, t = np.asarray(T_OtoC)[:3, :3], np.asarray(T_OtoC)[:3, 3]
    p_cam = np.asarray(verts) @ R.T + t
    tri = p_cam[np.asarray(faces)]  # [F, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    l = np.asarray(light_dir, np.float64)
    l /= np.linalg.norm(l)
    intens = ambient + (1.0 - ambient) * np.abs(n @ l)  # [F]
    hit = fid >= 0
    shade = intens[fid[hit]][:, None] * np.asarray(color, np.float64)[None, :]
    img[hit] = np.clip(shade, 0, 255).astype(np.uint8)
    return img, depth
