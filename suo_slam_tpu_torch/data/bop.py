"""BOP dataset reader: per-frame samples for evaluation and training, and
`collate`.

Port of `suo_slam_tpu/data/bop.py` (numpy, host side). Same on-disk
contract: BOP scene dirs with `scene_camera.json` / `scene_gt.json` /
`scene_gt_info.json`, `kp_info/obj_XXXXXX_kp_info.json` keypoint labels,
`kp_configs/<dset>_kp_config.csv`, YCB-V `keyframe.txt`, T-LESS
`all_target_tless.json`. Keypoints live in fixed [41, 3] vocabulary-layout
arrays with a channel mask built once at init; `get_raw` projects them
vectorized over the vocabulary. Images are read by `data/png.py` and
`data/jpeg.py`, chosen by the file's signature (the JAX package uses
OpenCV); pbr splits read `rgb/*.jpg`.

Training samples draw, from a per-thread numpy `Generator`, in the JAX
package's order: on synthetic splits and T-LESS `train_primesense`, the VOC
background composite (`SUO_BG_IMAGES_DIR` or
`<bop_root>/VOCdevkit/VOC2012/JPEGImages`: primesense's 0-2 occluder
sources, then the background's index; the background resized by
`augmentations.resize_linear` and written over the pixels off the objects),
the `gt+noise` box jitter, primesense's occluder pastes, then per object the
augmentation stack (`data/augmentations.py`: the scale-and-rotate warp,
which also moves K, the boxes and the depth map that `mask_occluded`
reads, then the blur and Pillow's enhancers), then per object the
give-prior coin, the random symmetry of a prior object and its noisy pose.
numpy's streams are the same on both sides, so the same seed gives
bit-equal samples (`sample_seeded`, the loader's per-item seeds). Without
background images on disk both packages train the synthetic splits on with
a warning.

Units follow BOP: translations and keypoints in mm.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from dataclasses import dataclass, field

import numpy as np

from ..core.symmetry import build_symmetry_stack
from ..kp import config as kp_config
from . import augmentations as aug
from . import jpeg, png

IMAGE_SIZE = (256, 256)
MIN_BOX_WH = 10.0


def _imread(path, flags=png.IMREAD_COLOR):
    """`cv2.imread(path, flags)` of a PNG or JPEG file, chosen by its
    signature."""
    with open(path, "rb") as f:
        data = f.read()
    if jpeg.is_jpeg(data):
        img = jpeg.decode(data, flags, name=str(path))
    elif png.is_png(data):
        img = png.imdecode(data, flags)
    else:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
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
    """Indexes one split of a BOP dataset and serves per-frame samples.

    Args mirror the JAX package's: `map_by` "view" (a sample is every object
    of a frame), "obj" (one object) or "obj_<id>"; `det_type` "gt" or
    "gt+noise" (sigma 20 px box noise); `mask_occluded` masks keypoints whose
    depth disagrees with the depth map; `ignore_symmetry` (the default here,
    as evaluation reads) keeps the raw GT pose for the keypoint projection,
    False picks the symmetry closest to the labeled view pose (or, for an
    object given a prior, a random one); `seed` the per-thread RNGs' base.
    """

    def __init__(
        self,
        data_root: str,
        split: str,
        bop_dset: str = "ycbv",
        map_by: str = "view",
        mask_occluded: bool = False,
        ignore_symmetry: bool = True,
        no_aug: bool = False,
        det_type: str = "gt",
        kp_config_root: str | None = None,
        seed: int | None = None,
    ):
        assert bop_dset in ("ycbv", "tless")
        assert det_type in ("gt", "gt+noise")
        self.no_aug = no_aug or "train" not in split
        self.augs = [] if self.no_aug else aug.default_train_augs()
        self.data_root = data_root
        self.split = split
        self.bop_dset = bop_dset
        self.map_by = map_by
        self.mask_occluded = mask_occluded
        self.ignore_symmetry = ignore_symmetry
        self.det_type = det_type
        # per-thread RNGs (numpy Generators are not thread-safe; the threaded
        # loader calls get_raw concurrently): seed + 7919 * thread index
        self._seed = (int(np.random.SeedSequence().entropy % (2 ** 31))
                      if seed is None else int(seed))
        if seed is None:
            print(f"BopDataset: seed=None -> generated base seed {self._seed}")
        self._tls = threading.local()
        self._thread_counter = itertools.count()
        self.single_obj = int(map_by.split("_")[1]) if map_by.startswith("obj_") else None
        self.kp_cfg = kp_config.load_kp_config(bop_dset, kp_config_root)
        self._load_labeled_kp()
        self._load_symmetries()
        self.bg_image_files = self._background_files()
        if "pbr" in split or self.bg_image_files:
            jpeg.load_library()  # built here, before any loader process starts
        self._index_scenes()

    @property
    def rng(self) -> np.random.Generator:
        """The calling thread's RNG."""
        r = getattr(self._tls, "rng", None)
        if r is None:
            r = np.random.default_rng(self._seed + 7919 * next(self._thread_counter))
            self._tls.rng = r
        return r

    @rng.setter
    def rng(self, value):
        self._tls.rng = value

    def reset_rng(self) -> None:
        """Restart every per-thread stream from the base seed (the validation
        epoch's identical draws). Only between epochs."""
        self._tls = threading.local()
        self._thread_counter = itertools.count()

    def _should_load_bg_images(self) -> bool:
        """Synthetic splits and T-LESS primesense composite backgrounds."""
        return "synt" in self.split or (
            self.bop_dset == "tless" and self.split == "train_primesense")

    def _background_files(self) -> list[str]:
        """The sorted VOC background list (empty, with a warning, when none
        is on disk)."""
        if not self._should_load_bg_images():
            return []
        bop_root = os.path.realpath(os.path.join(self.data_root, ".."))
        bg_dir = os.environ.get("SUO_BG_IMAGES_DIR",
                                os.path.join(bop_root, "VOCdevkit/VOC2012/JPEGImages"))
        files = []
        if os.path.isdir(bg_dir):
            exts = (".jpg", ".jpeg", ".JPEG", ".png")
            files = [os.path.join(bg_dir, f) for f in sorted(os.listdir(bg_dir))
                     if f.endswith(exts)]
        if not files:
            print(f"WARNING: no background images under {bg_dir} — training synthetic "
                  "splits without VOC compositing (download VOCtrainval_11-May-2012.tar "
                  "or set SUO_BG_IMAGES_DIR).")
        return files

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
        min_visib = 0.1 if ("train" in self.split or self.bop_dset == "tless") else -1.0

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
        self.object_index: list[tuple[int, int, int]] = []
        frame_count = 0

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
                # YCB-V train_real: every 5th frame
                if self.bop_dset == "ycbv" and self.split == "train_real":
                    keep = frame_count % 5 == 0
                frame_count += 1
                if keyframes is not None:
                    keep = (scene_id, view_id) in keyframes
                elif self.targets is not None:
                    keep = view_id in self.targets.get(scene_id, {})
                    if keep:
                        obj_to_keep = self.targets[scene_id][view_id]
                if self.single_obj is not None:
                    obj_to_keep = [self.single_obj]
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
                    self.object_index.append((scene_id, view_id, obj_id))

                if frame.objects:
                    scene[view_id] = frame
                    self.view_index.append((scene_id, view_id))
            if scene:
                self.data[scene_id] = scene

    # ------------------------------------------------------------ iteration --
    def __len__(self):
        return len(self.view_index) if self.map_by == "view" else len(self.object_index)

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

    def __getitem__(self, index):
        if self.map_by == "view":
            scene_id, view_id = self.view_index[index]
            return self.get_all_obj(scene_id, view_id)
        scene_id, view_id, obj_id = self.object_index[index]
        return self.get_raw(scene_id, view_id, [obj_id])

    def sample_seeded(self, index, seed):
        """`self[index]` with the calling thread's RNG pinned to `seed`: the
        sample's draws depend only on (index, seed)."""
        self.rng = np.random.default_rng(seed)
        return self[index]

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_tls", None)
        state.pop("_thread_counter", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tls = threading.local()
        self._thread_counter = itertools.count()

    def get_all_obj(self, scene_id, view_id):
        return self.get_raw(scene_id, view_id, self.obj_ids(scene_id, view_id))

    # ------------------------------------------------------------------- IO --
    def read_img(self, scene_id, view_id):
        ext = ".jpg" if "pbr" in self.split else ".png"
        path = os.path.join(self.curr_root, f"{scene_id:06d}", "rgb", f"{view_id:06d}{ext}")
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

    def _composite(self, scene_id, view_id, obj_ids, img, depth):
        """A random background over the pixels off the objects, on a copy of
        img: synthetic splits mask by depth == 0; T-LESS primesense by the
        object's mask, and draws 0-2 occluder crops for `get_raw` to paste.
        -> (img, [(crop [h, w, 3], mask [h, w] bool)])"""
        img = np.ascontiguousarray(img).copy()
        paste_imgs = []
        if self.bop_dset == "tless" and self.split == "train_primesense":
            assert len(obj_ids) == 1
            bg_mask = self.read_mask(scene_id, view_id, obj_ids[0]) != 255
            for _ in range(int(self.rng.integers(0, 3))):
                s_p, v_p, o_p = self.object_index[int(self.rng.integers(len(self.object_index)))]
                img_p = self.read_img(s_p, v_p)
                mask_p = self.read_mask(s_p, v_p, o_p)
                x, y, w, h = (int(v) for v in self.data[s_p][v_p].objects[o_p].bbox_xywh)
                paste_imgs.append((img_p[y:y + h, x:x + w], mask_p[y:y + h, x:x + w] == 255))
        else:
            d = depth if depth is not None else self.read_depth(scene_id, view_id)
            bg_mask = d == 0
        bg_path = self.bg_image_files[int(self.rng.integers(len(self.bg_image_files)))]
        bg = aug.resize_linear(_imread(bg_path), img.shape[:2][::-1])
        img[bg_mask] = bg[bg_mask]
        return img, paste_imgs

    # ------------------------------------------------------------- sampling --
    def pick_symmetry_transform(self, obj_idx: int, T_OtoC: np.ndarray, random: bool = False):
        """The symmetry composition closest to the labeled view pose, or a
        random one (host numpy)."""
        syms = self.symmetries[obj_idx]
        T = np.eye(4)
        T[:3, :] = T_OtoC[:3, :]
        if len(syms) == 1:
            return T, 0
        if random:
            i = int(self.rng.integers(len(syms)))
            return T @ syms[i], i
        kp = self.kp_full[obj_idx][self.kp_full_mask[obj_idx]]
        ref = kp @ self.view_pose[obj_idx][:3, :3].T + self.view_pose[obj_idx][:3, 3]
        ref = ref - ref.mean(0)
        cands = np.einsum("sij,kj->ski", (T @ syms)[:, :3, :3], kp) + (T @ syms)[:, None, :3, 3]
        cands = cands - cands.mean(1, keepdims=True)
        dists = np.linalg.norm(cands - ref[None], axis=-1).mean(1)
        i = int(np.argmin(dists))
        return T @ syms[i], i

    def get_raw(self, scene_id, view_id, obj_ids, p_give_prior: float = 0.5, img=None,
                depth=None):
        """One frame with its objects, vocabulary-layout numpy arrays.

        Returns a dict (all numpy): img [H, W, 3] f32 RGB in [0,1]; K [3,3];
        bboxes [O,4] xyxy; obj_ids [O]; poses [O,3,4] (raw GT); poses_sym
        [O,3,4] (the pose of the keypoint projection); K_kps [O,3,3]
        NDC-fixed K; kp_uvs [O,41,2]; kp_masks [O,41]; model_kps [O,41,3];
        kp_model_masks [O,41]; prior_uvs [O,41,2] (a noisy projection where
        the p_give_prior coin fell, NDC of the box); has_prior [O].
        img / depth: an optional pre-decoded BGR uint8 frame / mm depth map
        (the frame cache's, never written: the composite works on a copy).
        """
        if img is None:
            img = self.read_img(scene_id, view_id)
        frame = self.data[scene_id][view_id]
        K = frame.K.copy()
        if self.mask_occluded and depth is None:
            depth = self.read_depth(scene_id, view_id)

        paste_imgs = []
        if self.bg_image_files:
            img, paste_imgs = self._composite(scene_id, view_id, obj_ids, img, depth)

        O = len(obj_ids)
        nk = kp_config.num_kp()
        bboxes = np.zeros((O, 4), np.float32)
        for i, obj_id in enumerate(obj_ids):
            xywh = frame.objects[obj_id].bbox_xywh.astype(np.float32).copy()
            if "+noise" in self.det_type:
                xywh += self.rng.normal(scale=20, size=4).astype(np.float32)
            x, y, w, h = xywh
            w, h = max(MIN_BOX_WH, w), max(MIN_BOX_WH, h)
            bboxes[i] = (x, y, x + w, y + h)

        # occluders pasted near a random detection
        for img_p, mask_p in paste_imgs:
            ph, pw = img_p.shape[:2]
            if ph == 0 or pw == 0 or ph > img.shape[0] or pw > img.shape[1]:
                continue
            x1, y1, x2, y2 = bboxes[int(self.rng.integers(len(bboxes)))].astype(int)
            px = min(max(0, int(self.rng.integers(x1 - pw, max(x1 - pw + 1, x2)))),
                     img.shape[1] - pw)
            py = min(max(0, int(self.rng.integers(y1 - ph, max(y1 - ph + 1, y2)))),
                     img.shape[0] - ph)
            img[py:py + ph, px:px + pw][mask_p] = img_p[mask_p]

        # the warp moves K, the boxes and the depth map the occlusion test reads
        img, depth, bboxes, K = aug.apply_augs(self.augs, self.rng, img, depth, bboxes, K)

        poses = np.zeros((O, 3, 4), np.float32)
        poses_sym = np.zeros((O, 3, 4), np.float32)
        K_kps = np.zeros((O, 3, 3), np.float32)
        kp_uvs = np.zeros((O, nk, 2), np.float32)
        kp_masks = np.zeros((O, nk), bool)
        model_kps = np.zeros((O, nk, 3), np.float32)
        kp_model_masks = np.zeros((O, nk), bool)
        prior_uvs = np.zeros((O, nk, 2), np.float32)
        has_prior = np.zeros((O,), bool)

        for i, obj_id in enumerate(obj_ids):
            oi = obj_id - 1
            T_OtoC = frame.objects[obj_id].pose
            give_prior = bool(self.rng.random() < p_give_prior)
            if not self.ignore_symmetry:
                T4, _ = self.pick_symmetry_transform(oi, T_OtoC, random=give_prior)
            else:
                T4 = np.eye(4)
                T4[:3, :] = T_OtoC[:3, :]

            kp3d = self.kp_full[oi]  # [41, 3] vocab layout (zeros invalid)
            ch_mask = self.kp_full_mask[oi]
            p_cam = kp3d @ T4[:3, :3].T + T4[:3, 3]
            uvz = p_cam @ K.T
            z = uvz[:, 2]
            uv_px = uvz[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]

            if self.mask_occluded and depth is not None:
                ui = np.clip((uv_px[:, 0] + 0.5).astype(int), 0, depth.shape[1] - 1)
                vi = np.clip((uv_px[:, 1] + 0.5).astype(int), 0, depth.shape[0] - 1)
                depths_agree = np.abs(depth[vi, ui] - z) < 10.0  # mm
            else:
                depths_agree = np.ones((nk,), bool)

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
            kp_masks[i] = ch_mask & depths_agree & in_bounds
            model_kps[i] = np.where(ch_mask[:, None], kp3d, 0.0).astype(np.float32)
            kp_model_masks[i] = ch_mask

            if give_prior:
                # noisy prior from the perturbed GT: dT with ~5 deg rotation and
                # (5, 5, 10) mm translation noise, left-multiplied
                dT = np.eye(4)
                dT[:3, :3] = _euler2R_np(self.rng.normal(scale=5, size=3))
                dT[:3, 3] = self.rng.normal(scale=(5.0, 5.0, 10.0))
                p_noisy = kp3d @ (dT @ T4)[:3, :3].T + (dT @ T4)[:3, 3]
                uvw = p_noisy @ K_i.T
                prior_uvs[i] = (
                    uvw[:, :2] / np.where(np.abs(uvw[:, 2:3]) < 1e-9, 1e-9, uvw[:, 2:3])
                ).astype(np.float32)
                has_prior[i] = True

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
            "prior_uvs": prior_uvs,
            "has_prior": has_prior,
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


def _euler2R_np(euler_deg):
    g, b, a = np.deg2rad(np.asarray(euler_deg, np.float64))
    ca, cb, cg = np.cos(a), np.cos(b), np.cos(g)
    sa, sb, sg = np.sin(a), np.sin(b), np.sin(g)
    return np.array(
        [
            [ca * cb, ca * sb * sg - sa * cg, ca * sb * cg + sa * sg],
            [sa * cb, sa * sb * sg + ca * cg, sa * sb * cg - ca * sg],
            [-sb, cb * sg, cb * cg],
        ]
    )


def collate(samples: list[dict], truncate_obj: int | None = None, seed: int = 0):
    """Pad a list of `get_raw` dicts to dense [B, O_max, ...] arrays.

    Past `truncate_obj` objects a frame keeps a random sorted subset (from
    `seed`); images pad to the batch's largest H and W. Returns the
    `train.harness.Batch` fields plus the label extras (poses, K_kps,
    model_kps, ...), numpy.
    """
    rng = np.random.default_rng(seed)
    b = len(samples)
    nk = kp_config.num_kp()
    o_max = max(s["bboxes"].shape[0] for s in samples)
    if truncate_obj is not None:
        o_max = min(o_max, truncate_obj)
    hmax = max(s["img"].shape[0] for s in samples)
    wmax = max(s["img"].shape[1] for s in samples)

    out = {
        "images": np.zeros((b, hmax, wmax, 3), np.float32),
        "boxes": np.zeros((b, o_max, 4), np.float32),
        "obj_mask": np.zeros((b, o_max), bool),
        "obj_ids": np.zeros((b, o_max), np.int32),
        "prior_uv": np.zeros((b, o_max, nk, 2), np.float32),
        "prior_mask": np.zeros((b, o_max, nk), bool),
        "uv_gt": np.zeros((b, o_max, nk, 2), np.float32),
        "kp_mask": np.zeros((b, o_max, nk), bool),
        "poses": np.zeros((b, o_max, 3, 4), np.float32),
        "K_kps": np.zeros((b, o_max, 3, 3), np.float32),
        "model_kps": np.zeros((b, o_max, nk, 3), np.float32),
        "kp_model_masks": np.zeros((b, o_max, nk), bool),
        "K": np.zeros((b, 3, 3), np.float32),
    }
    for i, s in enumerate(samples):
        o = s["bboxes"].shape[0]
        keep = np.arange(o)
        if o > o_max:
            keep = np.sort(rng.choice(o, o_max, replace=False))
        h, w = s["img"].shape[:2]
        out["images"][i, :h, :w] = s["img"]
        out["K"][i] = s["K"]
        o = len(keep)
        out["boxes"][i, :o] = s["bboxes"][keep]
        out["obj_mask"][i, :o] = True
        out["obj_ids"][i, :o] = s["obj_ids"][keep]
        out["prior_uv"][i, :o] = s["prior_uvs"][keep]
        out["prior_mask"][i, :o] = s["kp_model_masks"][keep] & s["has_prior"][keep, None]
        out["uv_gt"][i, :o] = s["kp_uvs"][keep]
        out["kp_mask"][i, :o] = s["kp_masks"][keep]
        out["poses"][i, :o] = s["poses"][keep]
        out["K_kps"][i, :o] = s["K_kps"][keep]
        out["model_kps"][i, :o] = s["model_kps"][keep]
        out["kp_model_masks"][i, :o] = s["kp_model_masks"][keep]
    return out
