"""Keypoint-labeling core: render, back-project clicks, aggregate, save.

The port's own copy of `suo_slam_tpu/tools/labeling.py`, drawing through
`eval/raster.py` (OpenCV 5.0's pixels, without OpenCV). A 2 x 4 panel of
views of an object mesh (`eval/render.render_shaded`); each click is
back-projected through the rendered depth into the object frame; >= 3
samples per keypoint give a mean and a 3 x 3 sample covariance; `save`
writes `kp_info/obj_XXXXXX_kp_info.json` with
`{keypoints: {name: {pos_mean[3], pos_cov[9]}}, view_pose[16]}`, the file
`data.bop.BopDataset` reads. Host numpy only: nothing runs on the card.
`python -m suo_slam_tpu_torch.manual_keypoints` wraps it in a window.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.bop import _euler2R_np
from ..eval import raster
from ..eval.render import render_shaded
from ..kp import config as kp_config


def canonical_view_poses(diameter: float, n_views: int = 8) -> np.ndarray:
    """[n, 4, 4] object->camera poses spanning viewpoints (the 2x4 panel)."""
    dist = 3.0 * diameter
    poses = []
    for i in range(n_views):
        az = 2 * np.pi * i / n_views
        el = 0.5 if i % 2 == 0 else -0.5
        ca, sa = np.cos(az), np.sin(az)
        ce, se = np.cos(el), np.sin(el)
        # camera looks at the origin from direction (az, el)
        Rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
        Rx = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])
        T = np.eye(4)
        T[:3, :3] = Rx @ Rz
        T[2, 3] = dist
        poses.append(T)
    return np.stack(poses)


def propagate_cov_2d(K, T_OtoC, mean, cov):
    """First-order propagation of a 3D keypoint covariance into the image:
    with p_C = R @ mean + t and uvz = K @ p_C, the 2x2 image covariance is
    S @ cov @ S.T with S = d(uv)/d(uvz) @ K @ R, where the derivative of
    (u, v) = (x/z, y/z) is [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]] (the
    reference tool's Jacobian repeats 1/z in the first column of both rows;
    the JAX package corrected it, and so does this copy; only the
    inspection pane's ellipses read it).

    Returns (uv [2], cov2 [2, 2], z).
    """
    R, t = np.asarray(T_OtoC)[:3, :3], np.asarray(T_OtoC)[:3, 3]
    p_c = R @ np.asarray(mean, np.float64) + t
    uvz = np.asarray(K, np.float64) @ p_c
    x, y, z = uvz
    uv = np.array([x / z, y / z])
    duv_duvz = np.array([
        [1.0 / z, 0.0, -x / z**2],
        [0.0, 1.0 / z, -y / z**2],
    ])
    S = duv_duvz @ np.asarray(K, np.float64) @ R
    return uv, S @ np.asarray(cov, np.float64) @ S.T, float(z)


def cov_ellipse(cov2, chi2_val=5.991):
    """((major, minor) axis lengths, angle_deg) of the chi2 confidence
    ellipse: axis = 2 * sqrt(chi2 * lambda), angle from the first
    eigenvector."""
    lamb, V = np.linalg.eig(np.asarray(cov2, np.float64))
    lamb = np.maximum(lamb.real, 0.0)
    angle = float(np.degrees(np.arctan2(V[1, 0].real, V[0, 0].real)))
    axes = (2.0 * np.sqrt(chi2_val * lamb[0]), 2.0 * np.sqrt(chi2_val * lamb[1]))
    return axes, angle


def adjust_view_pose(view_pose, key, delta=2.0):
    """The inspection pane's view-pose keys: w/s pitch by -/+delta deg, a/d
    yaw by +/-delta deg (left-composed onto R), i/o zoom by -/+delta along
    z. Returns a NEW [4, 4] pose; unknown keys return the input unchanged."""
    T = np.array(view_pose, np.float64, copy=True)
    if T.shape[0] == 3:
        T = np.concatenate([T, np.eye(4)[3:]], 0)
    if key == "w":
        T[:3, :3] = _euler2R_np([-delta, 0, 0]) @ T[:3, :3]
    elif key == "s":
        T[:3, :3] = _euler2R_np([delta, 0, 0]) @ T[:3, :3]
    elif key == "a":
        T[:3, :3] = _euler2R_np([0, delta, 0]) @ T[:3, :3]
    elif key == "d":
        T[:3, :3] = _euler2R_np([0, -delta, 0]) @ T[:3, :3]
    elif key == "i":
        T[2, 3] -= delta
    elif key == "o":
        T[2, 3] += delta
    return T


class KeypointLabeler:
    """Sample-collecting labeler for one object mesh."""

    def __init__(self, verts, faces, K, hw=(240, 320), diameter=None, n_views=8):
        self.verts = np.asarray(verts, np.float64)
        self.faces = faces
        self.K = np.asarray(K, np.float64)
        self.hw = hw
        if diameter is None:
            d = self.verts - self.verts.mean(0)
            diameter = 2.0 * float(np.linalg.norm(d, axis=1).max())
        self.view_poses = canonical_view_poses(diameter, n_views)
        # shaded RGB for display; depth drives the back-projection
        self.shaded = []
        self.depths = []
        for T in self.view_poses:
            rgb, d = render_shaded(self.verts, self.faces, self.K, T, hw)
            self.shaded.append(rgb)
            self.depths.append(d)
        self.samples: dict[str, list[np.ndarray]] = {}
        # the user-adjusted canonical view pose saved into kp_info (the pose
        # `BopDataset.pick_symmetry_transform` canonicalizes symmetric ground
        # truth against at train time); starts at panel view 0 and is
        # refined in the inspection pane (`adjust_view_pose`)
        self.view_pose = self.view_poses[0].copy()

    def render_panel(self) -> np.ndarray:
        """Flat-shaded RGB panel [2, n/2] grid for display ([H, W, 3] u8)."""
        imgs = self.shaded
        n = len(imgs)
        top = np.concatenate(imgs[: n // 2], axis=1)
        bot = np.concatenate(imgs[n // 2 :], axis=1)
        return np.concatenate([top, bot], axis=0)

    def backproject(self, view_idx: int, x: float, y: float):
        """Pixel click -> 3D point in the OBJECT frame, or None off-surface:
        read the rendered depth, unproject through K, transform by the
        inverse view pose."""
        d = self.depths[view_idx]
        xi, yi = int(x), int(y)
        if not (0 <= xi < d.shape[1] and 0 <= yi < d.shape[0]) or d[yi, xi] <= 0:
            return None
        z = float(d[yi, xi])
        # the renderer samples at pixel centers: unproject (xi+0.5, yi+0.5)
        p_cam = np.linalg.inv(self.K) @ np.array([(xi + 0.5) * z, (yi + 0.5) * z, z])
        T = self.view_poses[view_idx]
        return T[:3, :3].T @ (p_cam - T[:3, 3])

    def add_sample(self, kp_name: str, view_idx: int, x: float, y: float) -> bool:
        assert kp_name in kp_config.KP_INDEX, f"Unknown keypoint {kp_name}"
        p = self.backproject(view_idx, x, y)
        if p is None:
            return False
        self.samples.setdefault(kp_name, []).append(p)
        return True

    def kp_stats(self, min_samples: int = 3):
        """name -> (mean [3], cov [3, 3]) for keypoints with enough samples."""
        out = {}
        for name, pts in self.samples.items():
            if len(pts) < min_samples:
                continue
            arr = np.stack(pts)
            mean = arr.mean(0)
            res = arr - mean
            cov = (res.T @ res) / max(1, len(pts) - 1)
            out[name] = (mean, cov)
        return out

    def render_inspection(self, min_samples: int = 3):
        """The inspection pane: the object at the current user-adjusted
        `self.view_pose`, with the labeled keypoints as dots (left,
        'Unscaled') and as first-order covariance-propagated chi2 ellipses
        (right, 'Scaled w/ Cov').

        Returns (img [H, 2W, 3] u8, ok) where ok=False if any sampled
        keypoint has < min_samples (the pose is not accepted then)."""
        rgb, _ = render_shaded(self.verts, self.faces, self.K, self.view_pose,
                               self.hw)
        normal = np.ascontiguousarray(rgb)
        scaled = normal.copy()
        ok = True
        for name, pts in self.samples.items():
            if len(pts) < min_samples:
                ok = False
        for name, (mean, cov) in self.kp_stats(min_samples).items():
            uv, cov2, z = propagate_cov_2d(self.K, self.view_pose, mean, cov)
            if z <= 0:
                continue
            u, v = int(round(uv[0])), int(round(uv[1]))
            col = [int(c) for c in kp_config.kp_color(name)]
            raster.circle(normal, (u, v), 4, [0, 0, 0])
            raster.circle(normal, (u, v), 3, col)
            (ax0, ax1), ang = cov_ellipse(cov2)
            raster.ellipse(scaled, (u, v), (int(round(ax0)), int(round(ax1))), ang, col, -1)
        raster.put_text(normal, "Unscaled", (3, 18), (10, 10, 255), "simplex_0.5")
        raster.put_text(scaled, "Scaled w/ Cov", (3, 18), (10, 255, 10), "simplex_0.5")
        return np.concatenate([normal, scaled], axis=1), ok

    def save(self, path: str, view_pose: np.ndarray | None = None,
             min_samples: int = 3):
        """Write the kp_info JSON. The saved `view_pose` is the
        user-adjusted `self.view_pose` (set in the inspection pane) unless
        overridden; `pick_symmetry_transform` canonicalizes symmetric
        objects' ground truth against it at train time."""
        stats = self.kp_stats(min_samples)
        assert stats, "No keypoints with enough samples to save"
        vp = self.view_pose if view_pose is None else view_pose
        data = {
            "keypoints": {
                name: {
                    "pos_mean": mean.tolist(),
                    "pos_cov": cov.reshape(-1).tolist(),
                }
                for name, (mean, cov) in stats.items()
            },
            "view_pose": np.asarray(vp).reshape(-1).tolist(),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
        return data


def load_kp_info(path: str):
    with open(path) as f:
        data = json.load(f)
    kps = {
        n: (np.asarray(v["pos_mean"]), np.asarray(v["pos_cov"]).reshape(3, 3))
        for n, v in data["keypoints"].items()
    }
    return kps, np.asarray(data["view_pose"]).reshape(4, 4)
