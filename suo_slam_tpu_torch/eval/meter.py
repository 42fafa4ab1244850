"""ADD / ADD-S / ADD(-S) pose-error metrics with PoseCNN-style AUC.

Port of `suo_slam_tpu/eval/meter.py`. The point distances — the ADD-S
pairwise minimum is O(P^2) per object — run on the dense padded point clouds
of `data.mesh.MeshDb.points_padded()` through kernel K10 (`csrc/add_dists.cu`)
on the card, or its plain version on the CPU; the AUC bookkeeping stays in
numpy.

AUC convention: mm errors, 0.1 m cutoff, monotone precision envelope
(`compute_auc_posecnn`); per-object AUC averaging.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels as kcount
from .._device import resolve_device
from ..kernels import _build


def compute_auc_posecnn(errors) -> float:
    """Area under the accuracy-vs-threshold curve, threshold in [0, 0.1] m.

    Errors are in mm (converted internally); errors > 0.1 m count as never
    correct.
    """
    errors = np.squeeze(np.asarray(errors, np.float64).copy()) * 1e-3
    errors = np.atleast_1d(errors)
    errors[errors > 0.1] = np.inf
    d = np.sort(errors)
    accuracy = np.cumsum(np.ones(d.shape[0])) / d.shape[0]
    finite = np.isfinite(d)
    if finite.sum() == 0:
        return 0.0
    d = d[finite]
    accuracy = accuracy[finite]
    mrec = np.concatenate(([0.0], d, [0.1]))
    mpre = np.concatenate(([0.0], accuracy, [accuracy[-1]]))
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    ids = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[ids] - mrec[ids - 1]) * mpre[ids]).sum() * 10.0)


class AverageMeter:
    """Numerically stable running average."""

    def __init__(self):
        self.avg = 0.0
        self.n = 0

    def update(self, x, k=1):
        self.n += k
        self.avg = ((self.n - k) * self.avg + x) / self.n

    def average(self):
        return self.avg


class AddAucMeter:
    """Per-class error accumulation -> AUC."""

    def __init__(self, obj_avg=True):
        self.err_map: dict[int, list[float]] = {}
        self.obj_avg = obj_avg

    def update(self, obj_ids, errs):
        for obj_id, err in zip(obj_ids, errs):
            self.err_map.setdefault(int(obj_id), []).append(float(err))

    def average(self):
        assert self.err_map, "AddAucMeter.average() with no data"
        auc_map = {o: compute_auc_posecnn(e) for o, e in self.err_map.items()}
        if self.obj_avg:
            return sum(auc_map.values()) / len(auc_map), auc_map
        all_errs = [e for errs in self.err_map.values() for e in errs]
        return compute_auc_posecnn(all_errs), auc_map


def _transform(T: torch.Tensor, points: torch.Tensor) -> list[torch.Tensor]:
    """R x + t of [B, P, 3] points under [B, 4, 4] poses, as three [B, P]
    coordinates, each a left-to-right sum of elementwise products."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return [T[:, i, 0, None] * x + T[:, i, 1, None] * y + T[:, i, 2, None] * z
            + T[:, i, 3, None] for i in range(3)]


def add_dists_plain(points, n_pts, T_pred, T_gt, per_point: bool = False):
    """(mean ADD [B], mean ADD-S [B]) over padded point clouds.

    points [B, P, 3] f32; n_pts [B] valid counts; T_pred, T_gt [B, 4, 4].
    The ADD-S minimum runs over the [B, P, P] squared distances
    dx^2 + dy^2 + dz^2 with padded columns at +inf, then the square root;
    padded rows are left out of the mean, whose denominator is max(n, 1).
    per_point also returns the per-point distances ([B, P] each, 0 on
    padded rows)."""
    P = points.shape[1]
    mask = torch.arange(P, device=points.device)[None, :] < n_pts[:, None]
    gx, gy, gz = _transform(T_gt, points)
    px, py, pz = _transform(T_pred, points)
    denom = torch.clamp(n_pts.to(points.dtype), min=1.0)
    dx, dy, dz = gx - px, gy - py, gz - pz
    d_add = torch.where(mask, torch.sqrt(dx * dx + dy * dy + dz * dz), 0.0)
    dx = gx[:, :, None] - px[:, None, :]
    dy = gy[:, :, None] - py[:, None, :]
    dz = gz[:, :, None] - pz[:, None, :]
    d2 = torch.where(mask[:, None, :], dx * dx + dy * dy + dz * dz, torch.inf)
    d_adds = torch.where(mask, torch.sqrt(torch.amin(d2, dim=-1)), 0.0)
    add = torch.sum(d_add, -1) / denom
    adds = torch.sum(d_adds, -1) / denom
    if per_point:
        return add, adds, d_add, d_adds
    return add, adds


_ADD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6


def _add_dists_cuda(points, n_pts, T_pred, T_gt, per_point: bool = False):
    B, P = points.shape[:2]
    if points.shape != (B, P, 3) or n_pts.shape != (B,) or T_pred.shape != (B, 4, 4) \
            or T_gt.shape != (B, 4, 4):
        raise ValueError("K10: expected points [B, P, 3], n_pts [B], poses [B, 4, 4]")
    fs = (points, T_pred, T_gt)
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K10 runs in f32")
    dev = points.device
    if any(a.device != dev for a in fs + (n_pts,)):
        raise ValueError("K10 inputs must lie on one CUDA device")
    pts, tp, tg = (a.contiguous() for a in fs)
    n = n_pts.to(torch.int32).contiguous()
    chunks = (P + 511) // 512 if P > 0 else 1
    part = torch.empty((B, chunks, P), dtype=torch.float32, device=dev)  # scratch
    d_add = torch.empty((B, P), dtype=torch.float32, device=dev)
    d_adds = torch.empty((B, P), dtype=torch.float32, device=dev)
    add = torch.empty((B,), dtype=torch.float32, device=dev)
    adds = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _build.entry("add_dists", _ADD_ARGTYPES)
    err = fn(_build.ptr(pts), _build.ptr(n), _build.ptr(tp), _build.ptr(tg), B, P,
             _build.ptr(part), _build.ptr(d_add), _build.ptr(d_adds), _build.ptr(add),
             _build.ptr(adds), _build.stream())
    _build.check(err, "K10 add_dists")
    kcount.count("add_dists")
    if per_point:
        return add, adds, d_add, d_adds
    return add, adds


def add_dists(points, n_pts, T_pred, T_gt):
    """(mean ADD [B], mean ADD-S [B]) (see `add_dists_plain`): K10 on CUDA
    tensors, the plain version on CPU tensors."""
    if points.device.type == "cpu":
        return add_dists_plain(points, n_pts, T_pred, T_gt)
    if points.device.type != "cuda":
        raise ValueError(f"add_dists: unsupported device {points.device}")
    return _add_dists_cuda(points, n_pts, T_pred, T_gt)


class EvalMeter:
    """ADD/ADD-S/ADD(-S) AUC meters over a MeshDb; the point clouds live on
    `device` (default "cuda")."""

    def __init__(self, mesh_db, d=0.1, device="cuda"):
        self.mesh_db = mesh_db
        self.d = d
        self.device = resolve_device(device)
        pts, cnt = mesh_db.points_padded()
        self._points = torch.from_numpy(pts).to(self.device)
        self._counts = torch.from_numpy(cnt).to(self.device)
        self.add_meter = AddAucMeter(obj_avg=True)
        self.adds_meter = AddAucMeter(obj_avg=True)
        self.add_maybe_s_meter = AddAucMeter(obj_avg=True)

    def update(self, obj_ids, poses_pred, poses_gt):
        obj_ids = [int(o) for o in obj_ids]
        idx = torch.tensor([o - 1 for o in obj_ids], device=self.device)
        t = lambda ps: torch.from_numpy(np.stack([_to44_np(p) for p in ps])).to(self.device)
        add, adds = add_dists(self._points[idx], self._counts[idx], t(poses_pred), t(poses_gt))
        add = add.cpu().numpy()
        adds = adds.cpu().numpy()
        is_sym = self.mesh_db.is_symmetric[[o - 1 for o in obj_ids]]
        add_ms = np.where(is_sym, adds, add)
        self.add_meter.update(obj_ids, add.tolist())
        self.adds_meter.update(obj_ids, adds.tolist())
        self.add_maybe_s_meter.update(obj_ids, add_ms.tolist())

    def update_no_det(self, obj_ids):
        inf = [np.inf] * len(obj_ids)
        self.add_meter.update(obj_ids, inf)
        self.adds_meter.update(obj_ids, inf)
        self.add_maybe_s_meter.update(obj_ids, inf)

    def result(self):
        return {
            "AUC of ADD": self.add_meter.average(),
            "AUC of ADD-S": self.adds_meter.average(),
            "AUC of ADD(-S)": self.add_maybe_s_meter.average(),
        }

    def pprint_objs_str(self, gt_obj_map):
        def pad(s, w=22):
            s = str(s)
            return s + " " * max(0, w - len(s))

        ret = ""
        result = self.result()
        keys = ["AUC of ADD", "AUC of ADD-S"]
        ret += pad("") + "& "
        for i, k in enumerate(keys):
            ret += pad(k, 15) + ("" if i == len(keys) - 1 else "& ")
        ret += "\\\\\n"
        for obj_id in sorted(gt_obj_map):
            ret += pad(gt_obj_map[obj_id]) + "& "
            for i, k in enumerate(keys):
                _, per_obj = result[k]
                ret += pad(f"{100 * per_obj.get(obj_id, 0):.1f}", 15) + (
                    "" if i == len(keys) - 1 else "& "
                )
            ret += "\\\\\n"
        ret += pad("Mean") + "& "
        for i, k in enumerate(keys):
            avg, _ = result[k]
            ret += pad(f"{100 * avg:.1f}", 15) + ("" if i == len(keys) - 1 else "& ")
        ret += "\n\n"
        ret += f'AUC of ADD(-S): {100 * result["AUC of ADD(-S)"][0]:.1f}\n'
        return ret

    def pprint(self):
        for k, v in self.result().items():
            print(f"{k}: {v[0]}")


def _to44_np(T):
    out = np.eye(4, dtype=np.float32)
    T = np.asarray(T)
    out[: T.shape[0], :] = T
    return out
