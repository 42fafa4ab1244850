"""The object-SLAM engine: symmetric / non-symmetric split, prior feedback,
camera-pose RANSAC, late init, re-init voting and removals, tracking and
global bundle adjustment.

Port of `suo_slam_tpu/slam/engine.py`. The state machine (which objects and
views exist, success and failure branches) is host Python over host numpy
measurement buffers [V, O, K]; the numeric paths are the device programs of
`slam.kernels` and `solvers.ba`, and a frame costs two host read-backs:

1. the non-symmetric group: frame inference (K1 crop -> K5 prior render ->
   PkpNet -> K2 readout) chained into `kernels.frontend_step` (filter ->
   PnP with K3 -> information -> camera-pose RANSAC with K6), read back
   once;
2. `kernels.tracking_tail`: the symmetric group's front end (dispatched,
   not yet read) is scattered into the device mirrors, then late init, the
   re-init vote (K6) and the tracking BA (K4, K7) run on them; one combined
   read-back.

Global BA (`optimize`, K4 + K7) runs every `global_opt_every` posed views
(every view in SfM and single-view modes) over device mirrors of the bulk
buffers (`_dev_buf`), which are updated row by row (`_sync_view_row`) and
dropped when a capacity grows. Modes: SLAM (default), SfM (`sfm_mode`) and
single view (`single_view_mode`, `evaluate.py --nviews 1`, which resets the
engine before every view). `debug_gt_kp` replaces the network with the
ground-truth keypoints plus N(0, gt_kp_noise_std) NDC noise drawn by the
hypothesis sampler's `noise` hook. `int8_inference` serves the network
with the s8-resident executor (`make_frame_inference(int8=True)`: kernels
K11-K13) on scales from `int8_scales_path` (an `.npz` sidecar) or from
online calibration over the first `int8_calib_frames` frames.
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


def _host(tree):
    """Read a (nested) dict of device tensors back as numpy."""
    if isinstance(tree, dict):
        return {k: _host(x) for k, x in tree.items()}
    return None if tree is None else tree.cpu().numpy()


@dataclass
class SlamConfig:
    # mode flags
    sfm_mode: bool = False
    single_view_mode: bool = False
    # ablations
    no_network_cov: bool = False
    no_prior_det: bool = False
    give_all_prior: bool = False
    debug_gt_kp: bool = False
    # thresholds
    global_opt_every: int = 10
    kp_var_thresh: float = 0.2
    bbox_thresh: float = 0.9
    bbox_inflate: float = 0.0
    mask_thresh: float = 0.3
    manual_kp_std: float = 0.005
    opt_init_with_outliers: bool = False
    gt_kp_noise_std: float = 0.01  # debug_gt_kp's NDC noise
    # rescale the BA information of a run whose information is manual
    # (1 / manual_kp_std^2) back to identity, as the reference BA weights
    # no-cov edges; RANSAC and re-init keep 1 / sigma^2
    ref_manual_info: bool = False
    # sliding window: global BA moves only the last N views' cameras
    max_active_views: int | None = None
    # capacities (power-of-2 growth)
    view_capacity: int = 16
    obj_capacity: int = 8
    pnp_hypotheses: int = 64
    reinit_check_views: int = 15
    input_hw: tuple[int, int] = (256, 256)
    # s8-resident network inference (`models/int8_forward.py`, norm="batch"
    # nets, either prior mode). Activation scales: the `.npz` sidecar at
    # int8_scales_path (`calibrate_int8`) when given, else absmax over the
    # first int8_calib_frames frames' crops.
    int8_inference: bool = False
    int8_scales_path: str | None = None
    int8_calib_frames: int = 8
    seed: int = 666

    @property
    def slam_mode(self) -> bool:
        return not (self.sfm_mode or self.single_view_mode)


class TorchGumbelSampler:
    """The engine's random draws on one `torch.Generator` seeded from
    `SlamConfig.seed` (re-made at every `ObjectSlam.reset()`): the RANSAC
    hypotheses by Gumbel top-4 — `sampler(keep [O, K], n_hyp)` draws a
    group's [O, n_hyp, 4] indices, `sampler.single(mask [N], n_hyp)` one
    point set's [n_hyp, 4] (the backup camera pose) — and
    `sampler.noise(shape, std)`, debug_gt_kp's keypoint noise (f32 numpy)."""

    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def __call__(self, mask: torch.Tensor, n_hyp: int) -> torch.Tensor:
        return pnp_mod.sample_hypothesis_indices(mask, n_hyp, self.gen)

    def single(self, mask: torch.Tensor, n_hyp: int) -> torch.Tensor:
        return pnp_mod.sample_hypothesis_indices(mask[None], n_hyp, self.gen)[0]

    def noise(self, shape, std: float) -> np.ndarray:
        z = torch.randn(tuple(shape), generator=self.gen, device=self.gen.device)
        return (z * std).cpu().numpy()


@dataclass
class _Detection:
    bbox: np.ndarray
    pose_pnp: np.ndarray | None  # T_OtoC from this frame's PnP or None
    score: float = 0.0
    prior_uv: np.ndarray | None = None


class ObjectSlam:
    """Feed `process_view` per frame; read `collect_results`."""

    def __init__(self, config: SlamConfig, mesh_db=None, net=None,
                 infer_fn=None, hyp_sampler=None, device="cuda"):
        """mesh_db: any object with `.diameter` and `.is_symmetric` arrays
        indexed by obj_id - 1.

        net: a `models.pkpnet.PkpNet` with its weights; or infer_fn, a frame
        inference callable with the `kernels.make_frame_inference` signature
        `(img, boxes, obj_valid, prior_uv, prior_valid) -> (uv, cov,
        mask_prob)`, which overrides net.

        hyp_sampler: factory `seed -> sampler` called at every `reset()`;
        `sampler(keep [O, K], n_hyp) -> idx [O, n_hyp, 4]` draws a group's
        PnP RANSAC hypotheses, `sampler.single(mask [N], n_hyp) ->
        idx [n_hyp, 4]` the backup camera pose's and, with debug_gt_kp,
        `sampler.noise(shape, std)` the keypoint noise (f32 numpy), each
        in the engine's order of draws. Default: `TorchGumbelSampler`.
        With `config.debug_gt_kp` neither net nor infer_fn is needed.
        """
        self.device = resolve_device(device)
        self.cfg = config
        self.mesh_db = mesh_db
        self._infer = infer_fn
        if infer_fn is None and not config.debug_gt_kp:
            if net is None:
                raise ValueError("ObjectSlam needs net or infer_fn unless debug_gt_kp is set")
            int8_scales = None
            if config.int8_inference and config.int8_scales_path:
                from ..models import int8_forward as i8

                int8_scales = i8.load_scales(config.int8_scales_path)
            self._infer = kernels.make_frame_inference(
                net, config.input_hw, device=self.device, int8=config.int8_inference,
                int8_scales=int8_scales, int8_calib_frames=config.int8_calib_frames)
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
        self.cam_active = np.zeros((self.V,), bool)   # view has a pose
        self.obj_active = np.zeros((self.O,), bool)   # object has a map pose
        self.obj_diam = np.full((self.O,), 1e-3, np.float32)
        self.view_slot: dict[int, int] = {}
        self.obj_slot: dict[int, int] = {}
        self.view_ids: list[int] = []     # insertion order of POSED views
        self.views_seen: list[int] = []   # all processed views
        self.detections: dict[int, dict[int, _Detection]] = {}
        self.cam_K_full: dict[int, np.ndarray] = {}
        self.obj_num_dets: dict[int, int] = {}
        self.obj_num_det_kps: dict[int, int] = {}
        self.needs_opt = False
        # whether this run's stored information is manual (1/sigma^2, the
        # front end got no covariance) or network-predicted; uniform within
        # a run (None until the first detection)
        self._manual_info_run: bool | None = None
        # device mirrors of the bulk measurement buffers (host numpy stays
        # the source of truth for the control logic)
        self._dev: dict[str, torch.Tensor] = {}

    def _up(self, a, dtype=None) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # device mirrors ----------------------------------------------------------
    _MIRRORED = ("uv", "info", "valid", "inliers", "cam_k4", "model_kp")

    def _dev_buf(self, name):
        """Device copy of a mirrored host buffer (uploaded once, then kept in
        sync by `_sync_view_row`, the tracking tail and the BA write-back, or
        dropped)."""
        buf = self._dev.get(name)
        if buf is None:
            buf = self._up(getattr(self, name))
            self._dev[name] = buf
        return buf

    def _sync_view_row(self, v):
        """Push row v of the per-view buffers to the device mirrors (in
        place: one small transfer per buffer)."""
        for name in ("uv", "info", "valid", "inliers", "cam_k4"):
            if name in self._dev:
                self._dev[name][v] = self._up(getattr(self, name)[v])

    # capacity management ----------------------------------------------------
    def _ensure_view_slot(self, view_id) -> int:
        if view_id in self.view_slot:
            return self.view_slot[view_id]
        n = len(self.view_slot)
        if n >= self.V:
            self._grow_views(self.V * 2)
        self.view_slot[view_id] = n
        return n

    def _grow_views(self, new_v):
        grow = new_v - self.V
        pad = lambda a: np.concatenate([a, np.zeros((grow,) + a.shape[1:], a.dtype)])
        self.uv = pad(self.uv)
        self.info = pad(self.info)
        self.valid = pad(self.valid)
        self.inliers = pad(self.inliers)
        self.cam_k4 = pad(self.cam_k4)
        self.cam_T = np.concatenate([self.cam_T,
                                     np.tile(np.eye(4, dtype=np.float32), (grow, 1, 1))])
        self.cam_active = np.concatenate([self.cam_active, np.zeros((grow,), bool)])
        self.V = new_v
        self._dev.clear()  # mirror shapes changed

    def _ensure_obj_slot(self, obj_id, model_kp=None, model_mask=None) -> int:
        if obj_id in self.obj_slot:
            return self.obj_slot[obj_id]
        n = len(self.obj_slot)
        if n >= self.O:
            self._grow_objects(self.O * 2)
        self.obj_slot[obj_id] = n
        if model_kp is not None:
            self.model_kp[n] = model_kp
            self.model_mask[n] = model_mask
            self._dev.pop("model_kp", None)  # rare; re-uploaded lazily
        if self.mesh_db is not None:
            self.obj_diam[n] = self.mesh_db.diameter[obj_id - 1]
        self.obj_num_dets.setdefault(obj_id, 0)
        self.obj_num_det_kps.setdefault(obj_id, 0)
        return n

    def _grow_objects(self, new_o):
        grow = new_o - self.O
        pad1 = lambda a: np.concatenate(
            [a, np.zeros((a.shape[0], grow) + a.shape[2:], a.dtype)], axis=1)
        self.uv = pad1(self.uv)
        self.info = pad1(self.info)
        self.valid = pad1(self.valid)
        self.inliers = pad1(self.inliers)
        self.cam_k4 = pad1(self.cam_k4)
        self.model_kp = np.concatenate([self.model_kp, np.zeros((grow, self.nk, 3), np.float32)])
        self.model_mask = np.concatenate([self.model_mask, np.zeros((grow, self.nk), bool)])
        self.obj_T = np.concatenate([self.obj_T,
                                     np.tile(np.eye(4, dtype=np.float32), (grow, 1, 1))])
        self.obj_active = np.concatenate([self.obj_active, np.zeros((grow,), bool)])
        self.obj_diam = np.concatenate([self.obj_diam, np.full((grow,), 1e-3, np.float32)])
        self.O = new_o
        self._dev.clear()  # mirror shapes changed

    def num_views_processed(self):
        return len(self.view_ids)

    def obj_num_inliers(self, obj_id):
        s = self.obj_slot.get(obj_id)
        return 0 if s is None else int(self.inliers[:, s].sum())

    # ------------------------------------------------------------- frame ----
    @torch.inference_mode()
    def process_view(self, view_id, img, K, obj_ids, bboxes, model_kps,
                     model_kps_masks, kp_masks, uv_gt=None, cam_pose=None):
        """Process one frame. img [H, W, 3] f32 RGB in [0, 1]; K [3, 3];
        obj_ids [O_f]; bboxes [O_f, 4] xyxy pixels; model_kps [O_f, K, 3];
        model_kps_masks / kp_masks [O_f, K]; uv_gt [O_f, K, 2] ground-truth
        NDC keypoints (debug_gt_kp); cam_pose optional external T_GtoC."""
        if view_id in self.views_seen:
            raise ValueError(f"repeat view {view_id}")
        c = self.cfg
        tt0 = time.perf_counter()
        self.views_seen.append(view_id)
        self.all_time_num_views += 1
        self.cam_K_full[view_id] = np.asarray(K, np.float64)
        if not c.debug_gt_kp:  # the frame goes to the device once
            img = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        obj_ids = np.asarray(obj_ids)
        bboxes = np.array(bboxes, np.float32)
        model_kps = np.asarray(model_kps, np.float32)
        model_kps_masks = np.asarray(model_kps_masks, bool)
        kp_masks = np.asarray(kp_masks, bool)
        gt = (lambda sel: None) if uv_gt is None else (lambda sel: np.asarray(uv_gt)[sel])

        # symmetric / non-symmetric split
        if not c.no_prior_det and self.mesh_db is not None:
            is_sym = np.array([bool(self.mesh_db.is_symmetric[o - 1]) for o in obj_ids],
                              bool)
        else:
            is_sym = np.zeros(len(obj_ids), bool)
        if cam_pose is not None:
            self._set_cam_pose(view_id, _to44(cam_pose))
            is_sym = np.ones(len(obj_ids), bool)
        if c.give_all_prior:
            is_sym = np.ones(len(obj_ids), bool)
        if c.single_view_mode:
            is_sym = np.zeros(len(obj_ids), bool)

        n_non_sym = int((~is_sym).sum())
        if (cam_pose is None and not c.single_view_mode and len(self.view_ids) > 0
                and n_non_sym == 0):
            self._backup_estimate_camera_pose(view_id, obj_ids, bboxes)

        self.needs_opt = True
        bboxes[:, :2] *= 1.0 - c.bbox_inflate
        bboxes[:, 2:] *= 1.0 + c.bbox_inflate

        if n_non_sym > 0:
            ns = ~is_sym
            self._process_objects(False, view_id, img, K, obj_ids[ns], bboxes[ns],
                                  model_kps[ns], model_kps_masks[ns], kp_masks[ns], gt(ns))
        if not self._has_cam_pose(view_id):
            if len(self.view_ids) == 0:
                self._set_cam_pose(view_id, np.eye(4))
            else:
                self._backup_estimate_camera_pose(view_id, obj_ids, bboxes)
        sym_pending = None
        if is_sym.any() and (self._has_cam_pose(view_id) or c.no_prior_det):
            # the symmetric group's front end is dispatched now and read back
            # with the tracking tail
            sym_pending = self._group_frontend(
                True, view_id, img, K, obj_ids[is_sym], bboxes[is_sym],
                model_kps[is_sym], model_kps_masks[is_sym], kp_masks[is_sym], gt(is_sym),
                with_cam_ransac=False,
            )
        if not c.single_view_mode:
            self._fused_tail(view_id, sym_pending)

        tt1 = time.perf_counter()
        if self.all_time_num_views > 5:  # warm-up exclusion
            self.track_times.append(tt1 - tt0)
        if c.sfm_mode or c.single_view_mode or (
            len(self.view_ids) > 1 and len(self.view_ids) % c.global_opt_every == 0
        ):
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

    def _process_objects(self, is_sym, view_id, img, K, obj_ids, bboxes, model_kps,
                         model_kps_masks, kp_masks, uv_gt):
        """Network + PnP + camera-pose RANSAC for the non-symmetric group: one
        device chain, the frame's first host read-back; then the camera pose
        and late init."""
        if len(obj_ids) == 0:
            return
        with_cam_ransac = not self._has_cam_pose(view_id) and self.num_views_processed() > 0
        meta, dev = self._group_frontend(is_sym, view_id, img, K, obj_ids, bboxes,
                                         model_kps, model_kps_masks, kp_masks, uv_gt,
                                         with_cam_ransac)
        host = _host(dev)
        self._commit_group(view_id, meta, host, sync=True)

        if not self._has_cam_pose(view_id):
            if self.num_views_processed() == 0:
                self._set_cam_pose(view_id, np.eye(4))
            elif host["cam_ok"]:
                self._set_cam_pose(view_id, _to44(host["T_cam"]))
            else:
                # RANSAC found no camera: no late init for this group; the
                # caller falls back to the backup pose
                return

        # late object init
        T_GtoC = _to44(self.cam_T[self.view_slot[view_id]])
        dets = self.detections[view_id]
        for obj_id in meta["obj_ids"]:
            s = self.obj_slot[obj_id]
            det = dets.get(obj_id)
            if not self.obj_active[s] and det is not None and det.pose_pnp is not None:
                self._set_obj_pose(obj_id, np.linalg.inv(T_GtoC) @ det.pose_pnp)

    def _group_frontend(self, is_sym, view_id, img, K, obj_ids, bboxes, model_kps,
                        model_kps_masks, kp_masks, uv_gt, with_cam_ransac):
        """Host preparation and the device chain of one group: network
        inference (or, with debug_gt_kp, the noisy ground-truth keypoints
        and the dataset's keypoint masks as keep) ->
        `kernels.frontend_step`. No host read-back: the caller decides when
        to read the returned device dict."""
        c = self.cfg
        of = len(obj_ids)
        nk = self.nk
        K_nd = np.zeros((of, 3, 3), np.float64)
        cam_k4 = np.zeros((of, 4), np.float32)
        for i in range(of):
            K_nd[i] = _fix_K_np(np.asarray(K, np.float64), bboxes[i])
            cam_k4[i] = (K_nd[i][0, 0], K_nd[i][1, 1], K_nd[i][0, 2], K_nd[i][1, 2])

        # prior detections for symmetric objects with map estimates (host
        # numpy, f64)
        prior_uv = np.zeros((of, nk, 2), np.float32)
        prior_valid = np.zeros((of, nk), bool)
        if is_sym and not c.no_prior_det and self._has_cam_pose(view_id):
            T_GtoC = _to44(self.cam_T[self.view_slot[view_id]])
            for i, obj_id in enumerate(obj_ids):
                s = self.obj_slot.get(obj_id)
                if s is None or not self.obj_active[s]:
                    continue
                T_OtoC = T_GtoC @ _to44(self.obj_T[s])
                m = model_kps_masks[i]
                p_C = model_kps[i] @ T_OtoC[:3, :3].T + T_OtoC[:3, 3]
                uvd = p_C @ K_nd[i].T
                if np.all(uvd[m, 2] > 0):
                    prior_uv[i] = uvd[:, :2] / np.where(
                        np.abs(uvd[:, 2:3]) < 1e-9, 1e-9, uvd[:, 2:3])
                    prior_valid[i] = m

        # slot assignment before the chain (insertion order, host only)
        slots = np.empty((of,), np.int32)
        for i, obj_id in enumerate(int(o) for o in obj_ids):
            slots[i] = self._ensure_obj_slot(obj_id, model_kps[i], model_kps_masks[i])

        # pad the object batch to a power-of-2 bucket
        ob = _bucket(of)
        pad_slots = np.full((ob,), self.O, np.int64)  # O = dropped in a scatter
        pad_slots[:of] = slots
        f32 = torch.float32
        keep_in = None
        if c.debug_gt_kp:
            if uv_gt is None:
                raise ValueError("debug_gt_kp needs uv_gt")
            uv_in = np.asarray(uv_gt, np.float32) + np.asarray(
                self._sampler.noise((of, nk, 2), c.gt_kp_noise_std), np.float32)
            uv_d = self._up(_pad0(uv_in, ob))
            cov_d = maskp_d = None
            keep_in = self._up(_pad0(np.asarray(kp_masks, bool), ob))
        else:
            obj_valid = np.zeros((ob,), bool)
            obj_valid[:of] = True
            bx = _pad0(bboxes, ob)
            bx[of:] = (0.0, 0.0, MIN_PAD_BOX, MIN_PAD_BOX)
            infer_kw = {}
            if not prior_valid.any() and getattr(self._infer, "supports_no_prior", False):
                infer_kw["has_prior"] = False  # the statically prior-free program
            uv_d, cov_d, maskp_d = self._infer(
                img, self._up(bx, f32), self._up(obj_valid),
                self._up(_pad0(prior_uv, ob), f32), self._up(_pad0(prior_valid, ob)),
                **infer_kw,
            )
            if c.no_network_cov:
                cov_d = None  # manual information, no stdev filter or meter
        diams = _pad0(np.asarray([self._diam(o) for o in obj_ids], np.float32), ob)
        diams[of:] = np.inf  # padded slots never pass the depth gate
        fs_kw = {}
        if with_cam_ransac:
            fs_kw = dict(slots=self._up(pad_slots), obj_T=self._up(self.obj_T),
                         obj_active=self._up(self.obj_active),
                         model_kp_full=self._dev_buf("model_kp"))
        dev = kernels.frontend_step(
            uv_d, cov_d, maskp_d, self._up(_pad0(model_kps, ob), f32),
            self._up(_pad0(model_kps_masks, ob)), self._up(_pad0(cam_k4, ob), f32),
            self._up(diams, f32), self._sampler, c.manual_kp_std, c.bbox_thresh,
            c.kp_var_thresh, c.mask_thresh, n_hyp=c.pnp_hypotheses, keep_in=keep_in, **fs_kw,
        )
        meta = dict(of=of, obj_ids=[int(o) for o in obj_ids], bboxes=bboxes,
                    cam_k4=cam_k4, slots=slots, pad_slots=pad_slots,
                    prior_uv=prior_uv, prior_valid=prior_valid)
        return meta, dev

    def _commit_group(self, view_id, meta, host, sync):
        """Host bookkeeping for one group's read-back: buffer rows, detection
        records, meters, first-view object init. sync=False when the device
        mirrors were already updated (the tracking tail's scatter)."""
        of = meta["of"]
        uv_pred = host["uv"][:of]
        keep = host["keep"][:of]
        info = host["info"][:of]
        T_pnp = host["T_pnp"][:of]
        pnp_ok = host["pnp_ok"][:of]
        if host["cov"] is not None:
            self.avg_std_sum += float(host["std_sum"])
            self.avg_std_n += int(host["std_cnt"])
        is_manual = host["cov"] is None
        if self._manual_info_run is None:
            self._manual_info_run = is_manual
        elif self._manual_info_run != is_manual:
            raise ValueError(
                "mixed manual/network info within one run: the ref_manual_info "
                "BA rescale assumes a uniform info source"
            )
        dets = self.detections.setdefault(view_id, {})
        v = self._ensure_view_slot(view_id)
        for i, obj_id in enumerate(meta["obj_ids"]):
            s = meta["slots"][i]
            self.uv[v, s] = uv_pred[i]
            self.info[v, s] = info[i]
            self.valid[v, s] = keep[i]
            self.inliers[v, s] = keep[i]  # every edge starts as an inlier
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
            # first-view object init (only the non-symmetric group can run
            # before the first camera pose)
            if self.num_views_processed() == 0 and pose is not None:
                if self._has_cam_pose(view_id):
                    T_GtoC = _to44(self.cam_T[self.view_slot[view_id]])
                    self._set_obj_pose(obj_id, np.linalg.inv(T_GtoC) @ pose)
                else:
                    self._set_obj_pose(obj_id, pose)
        if sync:
            self._sync_view_row(v)
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

    def _backup_estimate_camera_pose(self, view_id, obj_ids, bboxes):
        """bbox-centroid PnP against the mapped objects' centres (>= 4 of
        them), else constant velocity, else hold the last pose."""
        assert len(self.view_ids) > 0 and not self._has_cam_pose(view_id)
        K = self.cam_K_full[view_id]
        centroids, centers = [], []
        for i, obj_id in enumerate(int(o) for o in obj_ids):
            s = self.obj_slot.get(obj_id)
            if s is not None and self.obj_active[s]:
                centroids.append(0.5 * (bboxes[i, :2] + bboxes[i, 2:]))
                centers.append(self.obj_T[s][:3, 3])
        T = None
        if len(centroids) >= 4:
            uv1 = np.concatenate([np.stack(centroids), np.ones((len(centroids), 1))], -1)
            y = (uv1 @ np.linalg.inv(K).T)[:, :2]
            mask = torch.ones((len(centroids),), dtype=torch.bool, device=self.device)
            idx = self._sampler.single(mask, pnp_mod.DEFAULT_HYPOTHESES)
            res = pnp_mod.pnp_ransac(self._up(np.stack(centers), torch.float32),
                                     self._up(y, torch.float32), mask, idx)
            if bool(res.success):
                T = res.T.cpu().numpy()
        if T is None:
            if len(self.view_ids) > 1:
                T1 = _to44(self.cam_T[self.view_slot[self.view_ids[-2]]])
                T2 = _to44(self.cam_T[self.view_slot[self.view_ids[-1]]])
                T = (T2 @ np.linalg.inv(T1)) @ T2  # constant velocity
            else:
                T = _to44(self.cam_T[self.view_slot[self.view_ids[-1]]])
        self._set_cam_pose(view_id, T)

    # fused per-frame tail ------------------------------------------------------
    def _fused_tail(self, view_id, sym_pending):
        """Symmetric-group scatter + re-init vote + tracking BA in one device
        chain ending in the frame's second host read-back
        (`kernels.tracking_tail`)."""
        c = self.cfg
        if len(self.view_ids) == 0 or not self._has_cam_pose(view_id):
            assert sym_pending is None  # the symmetric group runs with a pose
            return
        v = self.view_slot[view_id]
        f32 = torch.float32

        sym_dev = meta_sym = None
        if sym_pending is not None:
            meta_sym, dev = sym_pending
            ob = len(meta_sym["pad_slots"])
            sym_dev = {
                "slots": self._up(meta_sym["pad_slots"]),
                "uv": dev["uv"], "info": dev["info"], "keep": dev["keep"],
                "T_pnp": dev["T_pnp"], "pnp_ok": dev["pnp_ok"],
                "cam_k4": self._up(_pad0(meta_sym["cam_k4"], ob), f32),
            }

        # re-init vote window over the last views (from 2 posed views on)
        reinit_in = None
        if self.num_views_processed() >= 2:
            check_n_views = len(self.view_ids) if c.sfm_mode else c.reinit_check_views
            check_n = min(len(self.view_ids), check_n_views)
            # non-symmetric candidates are host state (committed above);
            # symmetric ones join on the device from the pending group
            cand_sel = np.zeros((self.O,), bool)
            T_pnp_G = np.tile(np.eye(4, dtype=np.float32), (self.O, 1, 1))
            T_GtoC_inv = np.linalg.inv(_to44(self.cam_T[v]))
            for obj_id, det in self.detections.get(view_id, {}).items():
                s = self.obj_slot[obj_id]
                if det.pose_pnp is not None and self.obj_active[s]:
                    T_pnp_G[s] = T_GtoC_inv @ det.pose_pnp
                    cand_sel[s] = True
            # fixed-size view window padded with invalid slots
            n_fix = _bucket(check_n, lo=c.reinit_check_views)
            cs = np.zeros((n_fix,), np.int64)
            cam_valid = np.zeros((n_fix,), bool)
            for i in range(check_n):
                cs[i] = self.view_slot[self.view_ids[-(i + 1)]]
                cam_valid[i] = self.cam_active[cs[i]]
            reinit_in = {
                "cand_sel": self._up(cand_sel), "T_pnp_G": self._up(T_pnp_G),
                "cs": self._up(cs), "cam_valid": self._up(cam_valid),
                "cam_T_w": self._up(self.cam_T[cs]),
            }

        info_scale = float(np.float32(
            c.manual_kp_std ** 2 if (c.ref_manual_info and self._manual_info_run) else 1.0))
        mirrors, tail_dev = kernels.tracking_tail(
            self._dev_buf("uv"), self._dev_buf("info"), self._dev_buf("valid"),
            self._dev_buf("inliers"), self._dev_buf("cam_k4"), self._dev_buf("model_kp"),
            v, self._up(self.cam_T[v]), self._up(self.obj_T), self._up(self.obj_active),
            sym_dev, reinit_in, info_scale, bool(c.opt_init_with_outliers),
        )
        fetch = {"tail": tail_dev}
        if sym_pending is not None:
            fetch["sym"] = sym_pending[1]
        host = _host(fetch)  # the frame's second host read-back
        for name, buf in zip(self._MIRRORED[:5], mirrors):
            self._dev[name] = buf

        t = host["tail"]
        if sym_pending is not None:
            self._commit_group(view_id, meta_sym, host["sym"], sync=False)
        # the kernel's map updates: late inits and re-init votes (untouched
        # slots pass through, so a full copy is exact)
        self.obj_T[...] = t["obj_T"]
        self.obj_active |= t["late"]
        # tracking BA write-back (the unchanged values when the < 3-edge
        # gate fired)
        self.cam_T[v] = t["cam_T_v"]
        self.inliers[v] = t["inliers_row"]
        if t["did_opt"]:
            # min-inlier removal runs after every completed optimize,
            # tracking included
            self._remove_low_inlier_objects()

    # BA ----------------------------------------------------------------------
    @torch.inference_mode()
    def optimize(self):
        """Global robust LM over the measurement buffers: rounds
        (10, 10, 40, 40), or (10, 10, 10, 10) in single-view mode, the first
        camera fixed as the gauge, cameras older than `max_active_views`
        frozen; then both removals. Per-frame tracking runs in the fused
        tail instead."""
        if len(self.view_ids) == 0:
            return
        c = self.cfg
        cam_frozen = np.zeros((self.V,), bool)
        if c.max_active_views is not None:
            for view_id_old in self.view_ids[: -c.max_active_views]:
                cam_frozen[self.view_slot[view_id_old]] = True
        # stored information is 1/sigma^2 for a manual-information run (what
        # RANSAC and re-init need); ref_manual_info rescales the BA's copy
        info = self._dev_buf("info")
        if c.ref_manual_info and self._manual_info_run:
            info = info * (c.manual_kp_std ** 2)
        problem = ba.BAProblem(
            cam_T=self._up(self.cam_T), obj_T=self._up(self.obj_T),
            uv=self._dev_buf("uv"), info=info, model_kp=self._dev_buf("model_kp"),
            cam_k=self._dev_buf("cam_k4"), valid=self._dev_buf("valid"),
            inliers=self._dev_buf("inliers"), cam_active=self._up(self.cam_active),
            obj_active=self._up(self.obj_active), cam_frozen=self._up(cam_frozen),
        )
        rounds = (10, 10, 10, 10) if c.single_view_mode else (10, 10, 40, 40)
        result = ba.optimize(problem, iters_per_round=rounds, tracking_only=False,
                             fix_first_cam=True, init_with_outliers=False)
        new_cam, new_obj, new_inl = (result.cam_T.cpu().numpy(), result.obj_T.cpu().numpy(),
                                     result.inliers.cpu().numpy())
        upd = self.cam_active
        self.cam_T[upd] = new_cam[upd]
        self.obj_T[self.obj_active] = new_obj[self.obj_active]
        self.inliers[self.cam_active] = new_inl[self.cam_active]
        # the masked write-back changes rows of the inlier mirror: refresh it
        self._dev["inliers"] = self._up(self.inliers)
        self._remove_behind_camera()
        # min-inlier removal runs after every optimize, tracking included
        self._remove_low_inlier_objects()

    def _remove_behind_camera(self):
        """Behind-camera object removal, global BA only."""
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
        """Per-view object poses T_OtoC for evaluation; with `final` in SLAM
        mode, the pending global BA runs first."""
        if self.cfg.slam_mode and self.needs_opt and final:
            t0 = time.perf_counter()
            self.optimize()
            self.opt_times.append(time.perf_counter() - t0)
            self.needs_opt = False
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

    def get_view_viz_data(self, view_id):
        """Per-detection data of one view for drawing: obj_id -> {bbox,
        uv [K, 2] NDC, cov [K, 2, 2] NDC (the inverse of the stored
        information) or None with manual information, kp_mask [K],
        prior_uv or None, model_mask [K]}."""
        out = {}
        v = self.view_slot.get(view_id)
        if v is None:
            return out
        for obj_id, det in self.detections.get(view_id, {}).items():
            s = self.obj_slot[obj_id]
            info = self.info[v, s]
            a, b, d = info[:, 0, 0], info[:, 0, 1], info[:, 1, 1]
            det_i = np.maximum(a * d - b * b, 1e-12)
            cov = np.stack([np.stack([d, -b], -1), np.stack([-b, a], -1)],
                           axis=-2) / det_i[:, None, None]
            out[obj_id] = {
                "bbox": det.bbox,
                "uv": self.uv[v, s],
                "cov": None if self.cfg.no_network_cov or self.cfg.debug_gt_kp else cov,
                "kp_mask": self.valid[v, s],
                "prior_uv": det.prior_uv,
                "model_mask": self.model_mask[s],
            }
        return out

    # timing ------------------------------------------------------------------
    def tracking_hz(self):
        return 0.0 if not self.track_times else 1.0 / (
            sum(self.track_times) / len(self.track_times)
        )

    def avg_kp_std(self):
        return 0.0 if self.avg_std_n == 0 else self.avg_std_sum / self.avg_std_n
