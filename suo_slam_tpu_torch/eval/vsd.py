"""Visible Surface Discrepancy (VSD) evaluation — BOP'19 SISO protocol.

The port's own copy of `suo_slam_tpu/eval/vsd.py` (numpy only), for T-LESS:
delta = 15 mm visibility tolerance, tau = 20 mm misalignment tolerance,
correct_th = 0.3, n_top = 1 (highest score per GT), visib_gt_min = 0.1; depth
rendering by `eval/render.render_depth`.

e_VSD = average over the union of the estimated and GT visibility masks of
  0 if the pixel is in both masks and |D_est - D_gt| < tau, else 1.
"""

from __future__ import annotations

import os

import numpy as np

from . import render

VSD_DELTA = 15.0
VSD_TAU = 20.0
CORRECT_TH = 0.3
VISIB_GT_MIN = 0.1


def depth_to_dist(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Convert a z-depth image to a euclidean distance-from-camera image.

    The BOP protocol runs both the visibility test and the tau comparison on
    DISTANCE images, not raw z-depth
    (`bop_toolkit_lib/pose_error.py:47-50` via
    `misc.depth_im_to_dist_im_fast`, integer pixel coordinates).
    """
    h, w = depth.shape
    xs = (np.arange(w, dtype=np.float64) - K[0, 2]) / np.float64(K[0, 0])
    ys = (np.arange(h, dtype=np.float64) - K[1, 2]) / np.float64(K[1, 1])
    scale = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
    return depth.astype(np.float64) * scale


def estimate_visib_mask(d_test: np.ndarray, d_model: np.ndarray, delta: float,
                        base: np.ndarray | None = None) -> np.ndarray:
    """Pixels where the rendered model is visible in the test depth image.

    A model pixel is visible if the test depth is missing or not more than
    `delta` in front of it (bop_toolkit `visibility.py` semantics). For the
    estimated pose the GT visibility mask is OR-ed in restricted to model
    pixels (`visibility.estimate_visib_mask_est`).
    """
    mask = (d_model > 0) & ((d_test == 0) | (d_model <= d_test + delta))
    if base is not None:
        mask |= base & (d_model > 0)
    return mask


def vsd_error(
    d_test: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    T_est: np.ndarray,
    T_gt: np.ndarray,
    delta: float = VSD_DELTA,
    tau: float = VSD_TAU,
    dist_test: np.ndarray | None = None,
) -> float:
    """e_VSD for one estimate. Returns 1.0 when nothing is visible.

    All three images are converted to distance images first, exactly like the
    toolkit (`pose_error.py:47-50`); masks and the tau test run on distances.
    `dist_test`: pass the precomputed distance image of `d_test` (from
    `depth_to_dist`) to skip the per-call reconversion when scoring many
    estimates against the same view.
    """
    hw = d_test.shape
    d_est = depth_to_dist(render.render_depth(verts, faces, K, T_est, hw), K)
    d_gt = depth_to_dist(render.render_depth(verts, faces, K, T_gt, hw), K)
    d_test = depth_to_dist(d_test, K) if dist_test is None else dist_test
    v_gt = estimate_visib_mask(d_test, d_gt, delta)
    v_est = estimate_visib_mask(d_test, d_est, delta, base=v_gt)
    union = v_gt | v_est
    n = int(union.sum())
    if n == 0:
        return 1.0
    inter = v_gt & v_est
    good = inter & (np.abs(d_est - d_gt) < tau)
    return 1.0 - float(good.sum()) / n


def run_vsd_eval(
    csv_path: str,
    dataset,
    mesh_db,
    outdir: str,
    delta: float = VSD_DELTA,
    tau: float = VSD_TAU,
    correct_th: float = CORRECT_TH,
) -> dict:
    """Score a BOP'19-format CSV against the dataset GT; SISO top-1.

    Writes `vsd_summary.txt` to outdir and returns
    {"mean_obj_recall": float, "per_object": {obj_id: recall}}.
    Mirrors the reference's `eval_siso.py` output ("Mean object recall").
    """
    # parse CSV: scene_id,im_id,obj_id,score,R9,t3,time
    ests: dict = {}
    with open(csv_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("scene_id"):
                continue
            parts = line.split(",")
            scene_id, im_id, obj_id = int(parts[0]), int(parts[1]), int(parts[2])
            score = float(parts[3])
            R = np.asarray([float(v) for v in parts[4].split()]).reshape(3, 3)
            t = np.asarray([float(v) for v in parts[5].split()])
            key = (scene_id, im_id, obj_id)
            # SISO top-1: keep the highest-score estimate
            if key not in ests or ests[key][0] < score:
                T = np.concatenate([R, t[:, None]], axis=1)
                ests[key] = (score, T)

    per_obj_hits: dict[int, list[int]] = {}
    for scene_id in dataset.scene_ids():
        for view_id in dataset.view_ids(scene_id):
            d_test = dataset.read_depth(scene_id, view_id)
            K = dataset.data[scene_id][view_id].K
            dist_test = depth_to_dist(d_test, K)  # once per view, not per est
            for obj_id in dataset.obj_ids(scene_id, view_id):
                if not dataset.is_target(scene_id, view_id, obj_id):
                    continue
                T_gt = dataset.get_obj_pose(scene_id, view_id, obj_id)
                est = ests.get((scene_id, view_id, obj_id))
                if est is None:
                    per_obj_hits.setdefault(obj_id, []).append(0)
                    continue
                e = vsd_error(
                    d_test,
                    mesh_db.verts_full[obj_id],
                    mesh_db.faces[obj_id],
                    K, est[1], T_gt, delta, tau,
                    dist_test=dist_test,
                )
                per_obj_hits.setdefault(obj_id, []).append(int(e < correct_th))

    per_object = {
        o: float(np.mean(h)) for o, h in sorted(per_obj_hits.items())
    }
    mean_recall = float(np.mean(list(per_object.values()))) if per_object else 0.0
    lines = [f"Mean object recall: {100 * mean_recall:.2f}%"]
    for o, r in per_object.items():
        lines.append(f"  obj {o}: {100 * r:.2f}%")
    txt = "\n".join(lines)
    print(txt)
    with open(os.path.join(outdir, "vsd_summary.txt"), "w") as f:
        f.write(txt + "\n")
    return {"mean_obj_recall": mean_recall, "per_object": per_object}
