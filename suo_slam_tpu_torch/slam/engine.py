"""The object-SLAM engine, single-view configuration.

Port of `suo_slam_tpu/slam/engine.py` for `SlamConfig(single_view_mode=True)`
— `evaluate.py --nviews 1`, which resets the engine before every view. Per
view: frame inference (K1 crop -> PkpNet -> K2 readout) and the fused front
end (filter -> PnP with K3 -> information) in one device chain with ONE host
read-back; first-view object init from the PnP poses; then the robust LM
bundle adjustment (`solvers.ba.optimize`, K4) over the [V, O, K] buffers,
the behind-camera and low-inlier removals, and `collect_results`.

The state machine and the measurement buffers are host numpy, as in the JAX
engine; the BA problem is uploaded per `optimize()`. SLAM and SfM modes,
camera-pose RANSAC, prior feedback, `debug_gt_kp` and int8 inference are not
ported yet and raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..kp import config as kp_config
from ..solvers import ba
from ..solvers import pnp as pnp_mod
from . import kernels


def _to44(T):
    out = np.eye(4)
    out[: T.shape[0], :] = np.asarray(T)[: T.shape[0], :]
    return out


MIN_PAD_BOX = 16.0  # harmless box size for padded (masked-out) ROI slots


def _bucket(n: int, lo: int = 4) -> int:
    """Next power-of-two >= n (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pad0(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _fix_K_np(K, bbox):
    """Camera matrix projecting camera-frame points into bbox NDC (host
    numpy, f64): K' = S @ T @ K."""
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


@dataclass
class SlamConfig:
    # mode flags
    sfm_mode: bool = False
    single_view_mode: bool = False
    # ablations
    no_network_cov: bool = False
    debug_gt_kp: bool = False
    # thresholds
    kp_var_thresh: float = 0.2
    bbox_thresh: float = 0.9
    bbox_inflate: float = 0.0
    mask_thresh: float = 0.3
    manual_kp_std: float = 0.005
    ref_manual_info: bool = False
    # capacities
    view_capacity: int = 16
    obj_capacity: int = 8
    pnp_hypotheses: int = 64
    input_hw: tuple[int, int] = (256, 256)
    int8_inference: bool = False
    seed: int = 666

    @property
    def slam_mode(self) -> bool:
        return not (self.sfm_mode or self.single_view_mode)


class TorchGumbelSampler:
    """The default RANSAC hypothesis sampler: Gumbel top-4 on a
    `torch.Generator` seeded from `SlamConfig.seed` (re-made at every
    `ObjectSlam.reset()`)."""

    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def __call__(self, mask: torch.Tensor, n_hyp: int) -> torch.Tensor:
        return pnp_mod.sample_hypothesis_indices(mask, n_hyp, self.gen)


@dataclass
class _Detection:
    bbox: np.ndarray
    pose_pnp: np.ndarray | None  # T_OtoC from this frame's PnP or None
    score: float = 0.0
    prior_uv: np.ndarray | None = None


class ObjectSlam:
    """Feed `process_view` per view (after `reset()`); read
    `collect_results`."""

    def __init__(self, config: SlamConfig, mesh_db=None, net=None,
                 infer_fn=None, hyp_sampler=None, device="cuda"):
        """mesh_db: any object with `.diameter` and `.is_symmetric` arrays
        indexed by obj_id - 1.

        net: a `models.pkpnet.PkpNet` with its weights; or infer_fn, a frame
        inference callable with the `kernels.make_frame_inference` signature
        `(img, boxes, obj_valid, prior_uv, prior_valid) -> (uv, cov,
        mask_prob)`, which overrides net.

        hyp_sampler: factory `seed -> sampler`, where `sampler(keep [O, K],
        n_hyp) -> idx [O, n_hyp, 4]` draws the PnP RANSAC hypotheses; called
        at every `reset()`. Default: `TorchGumbelSampler`.
        """
        if not config.single_view_mode:
            raise NotImplementedError(
                "SLAM and SfM modes (camera RANSAC, tracking tail, global BA "
                "schedule) are not ported yet: ROADMAP A9"
            )
        if config.debug_gt_kp:
            raise NotImplementedError("debug_gt_kp is not ported yet: ROADMAP A9")
        if config.int8_inference:
            raise NotImplementedError("int8 inference is not ported yet: ROADMAP A11")
        self.device = resolve_device(device)
        self.cfg = config
        self.mesh_db = mesh_db
        self._infer = infer_fn
        if infer_fn is None:
            if net is None:
                raise ValueError("ObjectSlam needs net or infer_fn")
            self._infer = kernels.make_frame_inference(net, config.input_hw,
                                                       device=self.device)
        self._hyp_factory = hyp_sampler or (
            lambda seed: TorchGumbelSampler(seed, self.device)
        )
        self.nk = kp_config.num_kp()
        self.track_times: list[float] = []
        self.opt_times: list[float] = []
        self.avg_std_sum = 0.0
        self.avg_std_n = 0
        self.all_time_num_views = 0
        self.reset()

    # ------------------------------------------------------------- state ----
    def reset(self):
        c = self.cfg
        self._sampler = self._hyp_factory(c.seed)
        self.V = c.view_capacity
        self.O = c.obj_capacity
        K = self.nk
        self.uv = np.zeros((self.V, self.O, K, 2), np.float32)
        self.info = np.zeros((self.V, self.O, K, 2, 2), np.float32)
        self.valid = np.zeros((self.V, self.O, K), bool)
        self.inliers = np.zeros((self.V, self.O, K), bool)
        self.cam_k4 = np.zeros((self.V, self.O, 4), np.float32)
        self.model_kp = np.zeros((self.O, K, 3), np.float32)
        self.model_mask = np.zeros((self.O, K), bool)
        self.cam_T = np.tile(np.eye(4, dtype=np.float32), (self.V, 1, 1))
        self.obj_T = np.tile(np.eye(4, dtype=np.float32), (self.O, 1, 1))
        self.cam_active = np.zeros((self.V,), bool)
        self.obj_active = np.zeros((self.O,), bool)
        self.obj_diam = np.full((self.O,), 1e-3, np.float32)
        self.view_slot: dict[int, int] = {}
        self.obj_slot: dict[int, int] = {}
        self.view_ids: list[int] = []
        self.views_seen: list[int] = []
        self.detections: dict[int, dict[int, _Detection]] = {}
        self.cam_K_full: dict[int, np.ndarray] = {}
        self.obj_num_dets: dict[int, int] = {}
        self.obj_num_det_kps: dict[int, int] = {}
        self.needs_opt = False

    def _ensure_view_slot(self, view_id) -> int:
        if view_id not in self.view_slot:
            if len(self.view_slot) >= self.V:
                raise NotImplementedError("view-capacity growth is SLAM mode: ROADMAP A9")
            self.view_slot[view_id] = len(self.view_slot)
        return self.view_slot[view_id]

    def _ensure_obj_slot(self, obj_id, model_kp=None, model_mask=None) -> int:
        if obj_id in self.obj_slot:
            return self.obj_slot[obj_id]
        n = len(self.obj_slot)
        if n >= self.O:
            raise ValueError(f"more than obj_capacity={self.O} objects in one view")
        self.obj_slot[obj_id] = n
        if model_kp is not None:
            self.model_kp[n] = model_kp
            self.model_mask[n] = model_mask
        if self.mesh_db is not None:
            self.obj_diam[n] = self.mesh_db.diameter[obj_id - 1]
        self.obj_num_dets.setdefault(obj_id, 0)
        self.obj_num_det_kps.setdefault(obj_id, 0)
        return n

    def num_views_processed(self):
        return len(self.view_ids)

    def obj_num_inliers(self, obj_id):
        s = self.obj_slot.get(obj_id)
        return 0 if s is None else int(self.inliers[:, s].sum())

    # ------------------------------------------------------------- frame ----
    def process_view(self, view_id, img, K, obj_ids, bboxes, model_kps,
                     model_kps_masks, kp_masks, uv_gt=None, cam_pose=None):
        """Process one view. img [H, W, 3] f32 RGB in [0, 1]; K [3, 3];
        obj_ids [O_f]; bboxes [O_f, 4] xyxy pixels; model_kps [O_f, K, 3];
        model_kps_masks / kp_masks [O_f, K]; cam_pose optional T_GtoC."""
        if view_id in self.views_seen:
            raise ValueError(f"repeat view {view_id}")
        if self.view_ids:
            raise NotImplementedError(
                "single-view mode is driven with reset() before every view; a "
                "second posed view needs camera RANSAC: ROADMAP A7"
            )
        c = self.cfg
        tt0 = time.perf_counter()
        self.views_seen.append(view_id)
        self.all_time_num_views += 1
        self.cam_K_full[view_id] = np.asarray(K, np.float64)
        img = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        obj_ids = np.asarray(obj_ids)
        bboxes = np.array(bboxes, np.float32)
        model_kps = np.asarray(model_kps, np.float32)
        model_kps_masks = np.asarray(model_kps_masks, bool)
        if cam_pose is not None:
            self._set_cam_pose(view_id, _to44(cam_pose))
        self.needs_opt = True
        bboxes[:, :2] *= 1.0 - c.bbox_inflate
        bboxes[:, 2:] *= 1.0 + c.bbox_inflate
        # single-view mode: every object goes through the non-symmetric group
        self._process_objects(view_id, img, K, obj_ids, bboxes, model_kps,
                              model_kps_masks)
        if not self._has_cam_pose(view_id):
            self._set_cam_pose(view_id, np.eye(4))
        tt1 = time.perf_counter()
        if self.all_time_num_views > 5:
            self.track_times.append(tt1 - tt0)
        t0 = time.perf_counter()
        self.optimize()
        self.opt_times.append(time.perf_counter() - t0)
        self.needs_opt = False

    def _has_cam_pose(self, view_id):
        s = self.view_slot.get(view_id)
        return s is not None and bool(self.cam_active[s])

    def _set_cam_pose(self, view_id, T):
        s = self._ensure_view_slot(view_id)
        self.cam_T[s] = np.asarray(T, np.float32)[:4, :4]
        if not self.cam_active[s]:
            self.cam_active[s] = True
            self.view_ids.append(view_id)

    def _process_objects(self, view_id, img, K, obj_ids, bboxes, model_kps,
                         model_kps_masks):
        """Network + PnP for the view's objects: one device chain, ONE host
        read-back."""
        if len(obj_ids) == 0:
            return
        meta, dev = self._group_frontend(view_id, img, K, obj_ids, bboxes,
                                         model_kps, model_kps_masks)
        host = {k: (None if x is None else x.cpu().numpy()) for k, x in dev.items()}
        self._commit_group(view_id, meta, host)

    def _group_frontend(self, view_id, img, K, obj_ids, bboxes, model_kps,
                        model_kps_masks):
        c = self.cfg
        of = len(obj_ids)
        nk = self.nk
        dev = self.device
        cam_k4 = np.zeros((of, 4), np.float32)
        for i in range(of):
            K_nd = _fix_K_np(np.asarray(K, np.float64), bboxes[i])
            cam_k4[i] = (K_nd[0, 0], K_nd[1, 1], K_nd[0, 2], K_nd[1, 2])
        prior_uv = np.zeros((of, nk, 2), np.float32)
        prior_valid = np.zeros((of, nk), bool)
        slots = np.empty((of,), np.int32)
        for i, obj_id in enumerate(int(o) for o in obj_ids):
            slots[i] = self._ensure_obj_slot(obj_id, model_kps[i], model_kps_masks[i])
        ob = _bucket(of)
        obj_valid = np.zeros((ob,), bool)
        obj_valid[:of] = True
        bx = _pad0(bboxes, ob)
        bx[of:] = (0.0, 0.0, MIN_PAD_BOX, MIN_PAD_BOX)
        infer_kw = {}
        if getattr(self._infer, "supports_no_prior", False):
            infer_kw["has_prior"] = False  # single view never has a prior
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(dev)
        uv_d, cov_d, maskp_d = self._infer(
            img, t(bx, torch.float32), t(obj_valid),
            t(_pad0(prior_uv, ob)), t(_pad0(prior_valid, ob)), **infer_kw,
        )
        if c.no_network_cov:
            cov_d = None
        diams = _pad0(np.asarray([self._diam(o) for o in obj_ids], np.float32), ob)
        diams[of:] = np.inf  # padded slots never pass the depth gate
        out = kernels.frontend_step(
            uv_d, cov_d, maskp_d,
            t(_pad0(model_kps, ob), torch.float32), t(_pad0(model_kps_masks, ob)),
            t(_pad0(cam_k4, ob), torch.float32), t(diams, torch.float32),
            self._sampler, c.manual_kp_std, c.bbox_thresh, c.kp_var_thresh,
            c.mask_thresh, n_hyp=c.pnp_hypotheses,
        )
        meta = dict(of=of, obj_ids=[int(o) for o in obj_ids], bboxes=bboxes,
                    cam_k4=cam_k4, slots=slots, prior_uv=prior_uv,
                    prior_valid=prior_valid)
        return meta, out

    def _commit_group(self, view_id, meta, host):
        """Host bookkeeping for the read-back: buffer rows, detection
        records, meters, first-view object init."""
        of = meta["of"]
        uv_pred = host["uv"][:of]
        keep = host["keep"][:of]
        info = host["info"][:of]
        T_pnp = host["T_pnp"][:of]
        pnp_ok = host["pnp_ok"][:of]
        if host["cov"] is not None:
            self.avg_std_sum += float(host["std_sum"])
            self.avg_std_n += int(host["std_cnt"])
        dets = self.detections.setdefault(view_id, {})
        v = self._ensure_view_slot(view_id)
        for i, obj_id in enumerate(meta["obj_ids"]):
            s = meta["slots"][i]
            self.uv[v, s] = uv_pred[i]
            self.info[v, s] = info[i]
            self.valid[v, s] = keep[i]
            self.inliers[v, s] = keep[i]
            self.cam_k4[v, s] = meta["cam_k4"][i]
            pose = _to44(T_pnp[i]) if pnp_ok[i] else None
            dets[obj_id] = _Detection(
                bbox=meta["bboxes"][i].copy(), pose_pnp=pose,
                score=float(keep[i].mean()),
                prior_uv=meta["prior_uv"][i].copy()
                if meta["prior_valid"][i].any() else None,
            )
            self.obj_num_dets[obj_id] += 1
            self.obj_num_det_kps[obj_id] += int(keep[i].sum())
            if self.num_views_processed() == 0 and pose is not None:
                if self._has_cam_pose(view_id):
                    T_GtoC = _to44(self.cam_T[self.view_slot[view_id]])
                    self._set_obj_pose(obj_id, np.linalg.inv(T_GtoC) @ pose)
                else:
                    self._set_obj_pose(obj_id, pose)
        return v

    def _diam(self, obj_id):
        if self.mesh_db is None:
            return 1e-3
        return float(self.mesh_db.diameter[int(obj_id) - 1])

    def _set_obj_pose(self, obj_id, T_OtoG):
        s = self._ensure_obj_slot(obj_id)
        self.obj_T[s] = np.asarray(T_OtoG, np.float32)[:4, :4]
        self.obj_active[s] = True

    def _remove_obj(self, obj_id):
        s = self.obj_slot.get(obj_id)
        if s is not None:
            self.obj_active[s] = False

    # BA ----------------------------------------------------------------------
    def optimize(self):
        """Robust LM over the measurement buffers (single view: rounds
        (10, 10, 10, 10), the first camera fixed as the gauge)."""
        if len(self.view_ids) == 0:
            return
        c = self.cfg
        dev = self.device
        t = lambda a: torch.as_tensor(a).to(dev)
        info = self.info
        if c.ref_manual_info and c.no_network_cov:
            info = info * np.float32(c.manual_kp_std ** 2)
        problem = ba.BAProblem(
            cam_T=t(self.cam_T), obj_T=t(self.obj_T), uv=t(self.uv),
            info=t(info), model_kp=t(self.model_kp), cam_k=t(self.cam_k4),
            valid=t(self.valid), inliers=t(self.inliers),
            cam_active=t(self.cam_active), obj_active=t(self.obj_active),
            cam_frozen=t(np.zeros((self.V,), bool)),
        )
        with torch.inference_mode():
            result = ba.optimize(problem, iters_per_round=(10, 10, 10, 10),
                                 tracking_only=False, fix_first_cam=True,
                                 init_with_outliers=False)
        new_cam = result.cam_T.cpu().numpy()
        new_obj = result.obj_T.cpu().numpy()
        new_inl = result.inliers.cpu().numpy()
        upd = self.cam_active
        self.cam_T[upd] = new_cam[upd]
        self.obj_T[self.obj_active] = new_obj[self.obj_active]
        self.inliers[self.cam_active] = new_inl[self.cam_active]
        self._remove_behind_camera()
        self._remove_low_inlier_objects()

    def _remove_behind_camera(self):
        """Behind-camera object removal after the global BA."""
        if not self.view_ids:
            return
        v = self.view_slot[self.view_ids[-1]]
        T_GtoC = self.cam_T[v]
        for obj_id, s in list(self.obj_slot.items()):
            if not self.obj_active[s]:
                continue
            p = T_GtoC[:3, :3] @ self.obj_T[s][:3, 3] + T_GtoC[:3, 3]
            if p[2] < 0.5 * self._diam(obj_id):
                self._remove_obj(obj_id)

    def _remove_low_inlier_objects(self):
        """Min-inlier object removal."""
        for obj_id, s in list(self.obj_slot.items()):
            if not self.obj_active[s]:
                continue
            min_inl = 3 if self.obj_num_dets.get(obj_id, 0) < 3 else 6
            if self.obj_num_inliers(obj_id) < min_inl:
                self._remove_obj(obj_id)

    # results -----------------------------------------------------------------
    def collect_results(self, last_only=False, final=False):
        """Per-view object poses T_OtoC for evaluation (single view has no
        pending optimize, so `final` changes nothing)."""
        results = {}
        view_ids = [self.view_ids[-1]] if last_only else list(self.view_ids)
        for view_id in view_ids:
            T_GtoC = _to44(self.cam_T[self.view_slot[view_id]])
            dets = self.detections.get(view_id, {})
            obj_ids = set(dets) | {o for o, s in self.obj_slot.items() if self.obj_active[s]}
            poses = {}
            for obj_id in obj_ids:
                s = self.obj_slot.get(obj_id)
                T_OtoC = None
                if s is not None and self.obj_active[s]:
                    T_OtoC = T_GtoC @ _to44(self.obj_T[s])
                poses[obj_id] = {"T_OtoC": T_OtoC,
                                 "score": 1 + self.obj_num_inliers(obj_id)}
            results[view_id] = {"poses": poses}
        return results

    # timing ------------------------------------------------------------------
    def tracking_hz(self):
        return 0.0 if not self.track_times else 1.0 / (
            sum(self.track_times) / len(self.track_times)
        )

    def avg_kp_std(self):
        return 0.0 if self.avg_std_n == 0 else self.avg_std_sum / self.avg_std_n
