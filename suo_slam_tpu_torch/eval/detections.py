"""Saved-detection loaders: PoseCNN (YCB-V) and Pix2Pose (T-LESS) pickles.

The port's own copy of `suo_slam_tpu/eval/detections.py` (numpy only), same
on-disk contract: `<bop_root>/saved_detections/ycbv_posecnn.pkl` with the YCB
model-frame offset fixup from `<bop_root>/ycbv/offsets.txt`, and
`tless_pix2pose_retinanet_siso_top1.pkl` with xyxy box reordering. Poses are
converted m -> mm.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def _quat_wxyz_to_R(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_posecnn_results(bop_root: str) -> dict:
    path = os.path.join(bop_root, "saved_detections", "ycbv_posecnn.pkl")
    with open(path, "rb") as f:
        results = pickle.load(f)

    with open(os.path.join(bop_root, "ycbv", "offsets.txt")) as f:
        lines = f.read().strip().split("\n")
    offsets = {}
    for ln in lines:
        obj_id, off = int(ln[:2]), np.asarray(json.loads(ln[3:]))
        offsets[obj_id] = off

    data = {k: [] for k in ("scene_ids", "view_ids", "scores", "obj_ids", "poses", "bboxes")}
    for scene_view, result in results.items():
        scene_id, view_id = (int(v) for v in scene_view.split("/"))
        for n in range(result["rois"].shape[0]):
            obj_id = int(result["rois"][n, 1])
            qt = result["poses"][n]
            R = _quat_wxyz_to_R(np.asarray(qt[:4], np.float64))
            t = np.asarray(qt[4:7], np.float64) * 1000.0  # m -> mm
            pose = np.concatenate([R, t[:, None]], axis=1)
            T_orig2bop = np.eye(4)
            T_orig2bop[:3, 3] = -offsets[obj_id]
            pose = pose @ T_orig2bop
            data["scene_ids"].append(scene_id)
            data["view_ids"].append(view_id)
            data["scores"].append(float(result["rois"][n, 1]))
            data["obj_ids"].append(obj_id)
            data["bboxes"].append(np.asarray(result["rois"][n, 2:6], np.float32))
            data["poses"].append(pose)
    return data


def load_pix2pose_results(bop_root: str) -> dict:
    path = os.path.join(
        bop_root, "saved_detections", "tless_pix2pose_retinanet_siso_top1.pkl"
    )
    with open(path, "rb") as f:
        results = pickle.load(f)

    data = {k: [] for k in ("scene_ids", "view_ids", "scores", "obj_ids", "poses", "bboxes")}
    for scene_view, result in results.items():
        scene_id, view_id = (int(v) for v in scene_view.split("/"))
        boxes = np.asarray(result["rois"])
        # (y1, x1, y2, x2) -> (x1, y1, x2, y2)
        new_boxes = boxes.copy()
        new_boxes[:, 0], new_boxes[:, 1] = boxes[:, 1], boxes[:, 0]
        new_boxes[:, 2], new_boxes[:, 3] = boxes[:, 3], boxes[:, 2]
        for n in range(boxes.shape[0]):
            pose = np.asarray(result["poses"][n], np.float64).copy()
            pose[:3, 3] *= 1000.0
            data["scene_ids"].append(scene_id)
            data["view_ids"].append(view_id)
            data["scores"].append(float(result["rois"][n, 1]))
            data["obj_ids"].append(int(result["labels_txt"][n].split("_")[-1]))
            data["bboxes"].append(new_boxes[n].astype(np.float32))
            data["poses"].append(pose)
    return data


def build_detection_map(data: dict, targets=None) -> dict:
    """scene_id -> view_id -> obj_id -> index (objects outside `targets`,
    when given, are left out)."""
    out: dict = {}
    for i in range(len(data["view_ids"])):
        s, v, o = data["scene_ids"][i], data["view_ids"][i], data["obj_ids"][i]
        if targets is not None and o not in targets.get(s, {}).get(v, []):
            continue
        out.setdefault(s, {}).setdefault(v, {})
        assert o not in out[s][v], "Duplicate object in saved detections"
        out[s][v][o] = i
    return out
