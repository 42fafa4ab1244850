"""BOP dataset reader: the evaluation surface of `BopDataset`.

Port of `suo_slam_tpu/data/bop.py` for evaluation (numpy, host side). Same
on-disk contract: BOP scene dirs with `scene_camera.json` / `scene_gt.json` /
`scene_gt_info.json`, `kp_info/obj_XXXXXX_kp_info.json` keypoint labels,
`kp_configs/<dset>_kp_config.csv`, YCB-V `keyframe.txt`, T-LESS
`all_target_tless.json`. Keypoints live in fixed [41, 3] vocabulary-layout
arrays with a channel mask built once at init; `get_raw` projects them
vectorized over the vocabulary. Images are read by `data/png.py` (the JAX
package uses OpenCV).

Evaluation reads test splits with ground-truth boxes and no prior
(`get_raw(..., p_give_prior=0.0)`). The training side — augmentations, the
background compositing of synthetic splits, box noise, random priors,
`__getitem__` and `collate` — belongs to the training slice (ROADMAP A12);
asking for it raises.

Units follow BOP: translations and keypoints in mm.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..core.symmetry import build_symmetry_stack
from ..kp import config as kp_config
from . import png

IMAGE_SIZE = (256, 256)
MIN_BOX_WH = 10.0


def _imread(path, flags=png.IMREAD_COLOR):
    img = png.imread(path, flags)
    assert img.size > 0, f"Empty image {path}"
    return img


@dataclass
class ObjectGt:
    obj_id: int
    bbox_xywh: np.ndarray     # [4] visib bbox
    pose: np.ndarray          # [3, 4] T_OtoC (mm)
    mask_path: str


@dataclass
class Frame:
    K: np.ndarray             # [3, 3]
    depth_scale: float
    objects: dict[int, ObjectGt] = field(default_factory=dict)
    cam_pose: np.ndarray | None = None  # [3, 4] T_WtoC if present


class BopDataset:
    """Indexes one test split of a BOP dataset and serves per-frame samples.

    `ignore_symmetry` (True at evaluation) keeps the raw GT pose for the
    keypoint projection; False picks the symmetry closest to the labeled
    view pose. With no augmentation, box noise or prior, a sample involves
    no random draw (the JAX package's `seed` has nothing to seed here).
    """

    def __init__(
        self,
        data_root: str,
        split: str,
        bop_dset: str = "ycbv",
        ignore_symmetry: bool = True,
        kp_config_root: str | None = None,
    ):
        assert bop_dset in ("ycbv", "tless")
        if "train" in split or "synt" in split or "pbr" in split:
            raise NotImplementedError(
                f"split {split!r}: the training splits (augmentations, background "
                "compositing) are not ported yet: ROADMAP A12")
        self.data_root = data_root
        self.split = split
        self.bop_dset = bop_dset
        self.ignore_symmetry = ignore_symmetry
        self.kp_cfg = kp_config.load_kp_config(bop_dset, kp_config_root)
        self._load_labeled_kp()
        self._load_symmetries()
        self._index_scenes()

    # ---------------------------------------------------------------- init --
    @property
    def curr_root(self) -> str:
        return os.path.join(self.data_root, self.split)

    def num_obj(self) -> int:
        return len(self.kp_cfg)

    def _load_labeled_kp(self):
        """Manual 3D keypoints -> vocabulary-layout arrays.

        kp_full[o]: [41, 3] object-frame keypoint means (zeros where the
        object lacks the channel); kp_full_mask[o]: [41] channel validity;
        view_pose[o]: [4, 4].
        """
        K = kp_config.num_kp()
        n = self.num_obj()
        self.kp_full = np.zeros((n, K, 3), np.float64)
        self.kp_full_mask = np.zeros((n, K), bool)
        self.view_pose = np.tile(np.eye(4), (n, 1, 1))
        kp_dir = os.path.join(self.data_root, "kp_info")
        for idx in range(n):
            path = os.path.join(kp_dir, f"obj_{idx + 1:06d}_kp_info.json")
            assert os.path.exists(path), f"No keypoint file {path}."
            with open(path) as f:
                info = json.load(f)
            for name, ch in self.kp_cfg.kp_map[idx].items():
                self.kp_full[idx, ch] = info["keypoints"][name]["pos_mean"]
                self.kp_full_mask[idx, ch] = True
            self.view_pose[idx] = np.asarray(info["view_pose"], np.float64).reshape(4, 4)

    def _load_symmetries(self):
        models = "models_bop-compat" if self.bop_dset == "ycbv" else "models_cad"
        self.models_dir = os.path.join(self.data_root, models)
        with open(os.path.join(self.models_dir, "models_info.json")) as f:
            info = json.load(f)
        self.models_info = {int(k): v for k, v in info.items()}
        self.symmetries = [
            build_symmetry_stack(self.models_info[idx + 1]) for idx in range(self.num_obj())
        ]

    def _index_scenes(self):
        min_visib = 0.1 if self.bop_dset == "tless" else -1.0

        keyframes = None
        self.targets = None
        if "test" in self.split:
            if self.bop_dset == "ycbv":
                with open(os.path.join(self.data_root, "keyframe.txt")) as f:
                    keyframes = set()
                    for line in f.read().splitlines():
                        if line:
                            s, v = line.split("/")
                            keyframes.add((int(s), int(v)))
            else:
                with open(os.path.join(self.data_root, "all_target_tless.json")) as f:
                    targets_list = json.load(f)
                self.targets = {}
                for t in targets_list:
                    self.targets.setdefault(t["scene_id"], {}).setdefault(
                        t["im_id"], []
                    ).append(t["obj_id"])

        self.data: dict[int, dict[int, Frame]] = {}
        self.view_index: list[tuple[int, int]] = []

        for scene_id_str in sorted(os.listdir(self.curr_root)):
            scene_dir = os.path.join(self.curr_root, scene_id_str)
            if not os.path.isdir(scene_dir):
                continue
            scene_id = int(scene_id_str)
            with open(os.path.join(scene_dir, "scene_camera.json")) as f:
                cam_infos = json.load(f)
            with open(os.path.join(scene_dir, "scene_gt_info.json")) as f:
                gt_infos = json.load(f)
            with open(os.path.join(scene_dir, "scene_gt.json")) as f:
                gt_poses = json.load(f)

            scene: dict[int, Frame] = {}
            for view_id_str in cam_infos:
                view_id = int(view_id_str)
                keep = True
                obj_to_keep = None
                if keyframes is not None:
                    keep = (scene_id, view_id) in keyframes
                elif self.targets is not None:
                    keep = view_id in self.targets.get(scene_id, {})
                    if keep:
                        obj_to_keep = self.targets[scene_id][view_id]
                if not keep:
                    continue

                ci = cam_infos[view_id_str]
                frame = Frame(
                    K=np.asarray(ci["cam_K"], np.float64).reshape(3, 3),
                    depth_scale=float(ci.get("depth_scale", 1.0)),
                )
                if "cam_R_w2c" in ci:
                    R = np.asarray(ci["cam_R_w2c"], np.float64).reshape(3, 3)
                    t = np.asarray(ci["cam_t_w2c"], np.float64).reshape(3, 1)
                    frame.cam_pose = np.concatenate([R, t], axis=-1)

                for obj_idx, obj_gt in enumerate(gt_poses[view_id_str]):
                    gi = gt_infos[view_id_str][obj_idx]
                    if gi["visib_fract"] < min_visib:
                        continue
                    obj_id = obj_gt["obj_id"]
                    if obj_to_keep is not None and obj_id not in obj_to_keep:
                        continue
                    R = np.asarray(obj_gt["cam_R_m2c"], np.float64).reshape(3, 3)
                    t = np.asarray(obj_gt["cam_t_m2c"], np.float64).reshape(3, 1)
                    frame.objects[obj_id] = ObjectGt(
                        obj_id=obj_id,
                        bbox_xywh=np.asarray(gi["bbox_visib"], np.float32),
                        pose=np.concatenate([R, t], axis=-1),
                        mask_path=os.path.join(
                            scene_dir, "mask_visib", f"{view_id:06d}_{obj_idx:06d}.png"
                        ),
                    )

                if frame.objects:
                    scene[view_id] = frame
                    self.view_index.append((scene_id, view_id))
            if scene:
                self.data[scene_id] = scene

    # ------------------------------------------------------------ iteration --
    def __len__(self):
        return len(self.view_index)

    def scene_ids(self):
        return list(self.data.keys())

    def view_ids(self, scene_id):
        return list(self.data[scene_id].keys())

    def obj_ids(self, scene_id, view_id):
        return list(self.data[scene_id][view_id].objects.keys())

    def get_cam_pose(self, scene_id, view_id=-1):
        if view_id < 0:
            view_id = min(self.data[scene_id].keys())
        return self.data[scene_id][view_id].cam_pose

    def get_obj_pose(self, scene_id, view_id, obj_id):
        return self.data[scene_id][view_id].objects[obj_id].pose

    def is_target(self, scene_id, view_id, obj_id):
        return self.targets is None or obj_id in self.targets.get(scene_id, {}).get(
            view_id, []
        )

    # ------------------------------------------------------------------- IO --
    def read_img(self, scene_id, view_id):
        path = os.path.join(self.curr_root, f"{scene_id:06d}", "rgb", f"{view_id:06d}.png")
        img = _imread(path)
        assert img.dtype == np.uint8
        return img

    def read_depth(self, scene_id, view_id):
        path = os.path.join(self.curr_root, f"{scene_id:06d}", "depth", f"{view_id:06d}.png")
        depth = _imread(path, png.IMREAD_ANYDEPTH)
        return np.squeeze(depth.astype(np.float32)) * self.data[scene_id][view_id].depth_scale

    def read_mask(self, scene_id, view_id, obj_id):
        path = self.data[scene_id][view_id].objects[obj_id].mask_path
        return np.squeeze(_imread(path, png.IMREAD_GRAYSCALE))

    # ------------------------------------------------------------- sampling --
    def pick_symmetry_transform(self, obj_idx: int, T_OtoC: np.ndarray):
        """The symmetry composition closest to the labeled view pose (host
        numpy)."""
        syms = self.symmetries[obj_idx]
        T = np.eye(4)
        T[:3, :] = T_OtoC[:3, :]
        if len(syms) == 1:
            return T, 0
        kp = self.kp_full[obj_idx][self.kp_full_mask[obj_idx]]
        ref = kp @ self.view_pose[obj_idx][:3, :3].T + self.view_pose[obj_idx][:3, 3]
        ref = ref - ref.mean(0)
        cands = np.einsum("sij,kj->ski", (T @ syms)[:, :3, :3], kp) + (T @ syms)[:, None, :3, 3]
        cands = cands - cands.mean(1, keepdims=True)
        dists = np.linalg.norm(cands - ref[None], axis=-1).mean(1)
        i = int(np.argmin(dists))
        return T @ syms[i], i

    def get_raw(self, scene_id, view_id, obj_ids, p_give_prior: float = 0.5, img=None):
        """One frame with its objects, vocabulary-layout numpy arrays.

        Evaluation form: `p_give_prior` must be 0 (no prior keypoints; the
        random priors belong to training). Returns a dict (all numpy):
          img [H, W, 3] f32 RGB in [0,1]; K [3,3]; bboxes [O,4] xyxy;
          obj_ids [O]; poses [O,3,4] (raw GT); poses_sym [O,3,4] (the pose
          used for the keypoint projection); K_kps [O,3,3] NDC-fixed K;
          kp_uvs [O,41,2]; kp_masks [O,41]; model_kps [O,41,3];
          kp_model_masks [O,41]; prior_uvs [O,41,2] and has_prior [O] (zero).
        img: an optional pre-decoded BGR uint8 frame.
        """
        if p_give_prior != 0.0:
            raise NotImplementedError("random prior keypoints belong to training: ROADMAP A12")
        if img is None:
            img = self.read_img(scene_id, view_id)
        frame = self.data[scene_id][view_id]
        K = frame.K.copy()

        O = len(obj_ids)
        nk = kp_config.num_kp()
        bboxes = np.zeros((O, 4), np.float32)
        for i, obj_id in enumerate(obj_ids):
            x, y, w, h = frame.objects[obj_id].bbox_xywh.astype(np.float32)
            w, h = max(MIN_BOX_WH, w), max(MIN_BOX_WH, h)
            bboxes[i] = (x, y, x + w, y + h)

        poses = np.zeros((O, 3, 4), np.float32)
        poses_sym = np.zeros((O, 3, 4), np.float32)
        K_kps = np.zeros((O, 3, 3), np.float32)
        kp_uvs = np.zeros((O, nk, 2), np.float32)
        kp_masks = np.zeros((O, nk), bool)
        model_kps = np.zeros((O, nk, 3), np.float32)
        kp_model_masks = np.zeros((O, nk), bool)

        for i, obj_id in enumerate(obj_ids):
            oi = obj_id - 1
            T_OtoC = frame.objects[obj_id].pose
            if not self.ignore_symmetry:
                T4, _ = self.pick_symmetry_transform(oi, T_OtoC)
            else:
                T4 = np.eye(4)
                T4[:3, :] = T_OtoC[:3, :]

            kp3d = self.kp_full[oi]  # [41, 3] vocab layout (zeros invalid)
            ch_mask = self.kp_full_mask[oi]
            p_cam = kp3d @ T4[:3, :3].T + T4[:3, 3]
            uvz = p_cam @ K.T
            z = uvz[:, 2]
            uv_px = uvz[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]

            x1, y1, x2, y2 = bboxes[i]
            w, h = x2 - x1, y2 - y1
            uv_ndc = np.stack(
                [2.0 * (uv_px[:, 0] - x1) / w - 1.0, 1.0 - 2.0 * (uv_px[:, 1] - y1) / h], -1
            )
            in_bounds = np.all((uv_ndc >= -1) & (uv_ndc <= 1), axis=1)

            K_i = _fix_K_for_bbox_ndc_np(K, bboxes[i])
            poses[i] = T_OtoC[:3, :].astype(np.float32)
            poses_sym[i] = T4[:3, :].astype(np.float32)
            K_kps[i] = K_i.astype(np.float32)
            kp_uvs[i] = np.where(ch_mask[:, None], uv_ndc, 0.0).astype(np.float32)
            kp_masks[i] = ch_mask & in_bounds
            model_kps[i] = np.where(ch_mask[:, None], kp3d, 0.0).astype(np.float32)
            kp_model_masks[i] = ch_mask

        return {
            "img": img.astype(np.float32)[..., ::-1] / 255.0,  # BGR->RGB, [0,1]
            "K": K.astype(np.float32),
            "obj_ids": np.asarray(obj_ids, np.int32),
            "bboxes": bboxes,
            "poses": poses,
            "poses_sym": poses_sym,
            "K_kps": K_kps,
            "kp_uvs": kp_uvs,
            "kp_masks": kp_masks,
            "model_kps": model_kps,
            "kp_model_masks": kp_model_masks,
            "prior_uvs": np.zeros((O, nk, 2), np.float32),
            "has_prior": np.zeros((O,), bool),
            "scene_id": scene_id,
            "view_id": view_id,
        }


def _to44_cam(T):
    """Promote a [3, 4] (or [4, 4]) pose to 4x4."""
    out = np.eye(4)
    T = np.asarray(T)
    out[: T.shape[0], :] = T
    return out


def _fix_K_for_bbox_ndc_np(K, bbox):
    x1, y1, x2, y2 = bbox
    w, h = x2 - x1, y2 - y1
    T = np.eye(3)
    T[:2, 2] = (-x1, -y1)
    S = np.eye(3)
    S[0, :] *= 2.0 / w
    S[1, :] *= -2.0 / h
    S[0, 2] -= 1.0
    S[1, 2] += 1.0
    return S @ T @ K
