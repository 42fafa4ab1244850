"""ADD / ADD-S / ADD(-S) pose-error metrics with PoseCNN-style AUC.

Port of `suo_slam_tpu/eval/meter.py`. The point distances — the ADD-S
pairwise minimum is O(P^2) per object — run on the dense padded point clouds
of `data.mesh.MeshDb.points_padded()`, resident on the device, through kernel
K10 (`csrc/add_dists.cu`: one launch per `EvalMeter.update`, and the
evaluation scores a whole scene with one) on the card, or its plain version
on the CPU; the AUC bookkeeping stays in numpy.

AUC convention: mm errors, 0.1 m cutoff, monotone precision envelope
(`compute_auc_posecnn`); per-object AUC averaging.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

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


PLAIN_PAIRS = 1 << 24  # (pose, row, column) triples in one group of the plain version


def add_dists_plain(points, n_pts, T_pred, T_gt, per_point: bool = False, obj=None):
    """(mean ADD [B], mean ADD-S [B]) over padded point clouds.

    points [B, P, 3] f32; n_pts [B] valid counts; T_pred, T_gt [B, 4, 4].
    With `obj` [B] (row indices), points [n_obj, P, 3] and n_pts [n_obj] are
    a table that pose b reads at row obj[b].
    The ADD-S minimum runs over the [B, P, P] squared distances
    dx^2 + dy^2 + dz^2 with padded columns at +inf, then the square root;
    padded rows are left out of the mean, whose denominator is max(n, 1).
    Poses run in groups of max(1, PLAIN_PAIRS // P^2), so a [b, P, P]
    temporary stays within 64 MiB of f32 whatever B is; a pose's results
    are the same bits in any group. per_point also returns the per-point
    distances ([B, P] each, 0 on padded rows)."""
    if obj is not None:
        obj = obj.long()
        points, n_pts = points[obj], n_pts[obj]
    B, P = points.shape[:2]
    group = max(1, PLAIN_PAIRS // max(P * P, 1))
    parts = [_add_dists_group(points[i:i + group], n_pts[i:i + group], T_pred[i:i + group],
                              T_gt[i:i + group]) for i in range(0, B, group)]
    out = parts[0] if len(parts) == 1 else tuple(torch.cat(c) for c in zip(*parts))
    return out if per_point else out[:2]


def _add_dists_group(points, n_pts, T_pred, T_gt):
    """`add_dists_plain` on gathered clouds [b, P, 3], per-point distances included."""
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
    return add, adds, d_add, d_adds


# K10's launch geometry; mirrors the constants of `csrc/add_dists.cu`
ADD_THREADS = 256
ADD_ROWS_PER_THREAD = 4
ADD_ROWS_PER_BLOCK = 32 * ADD_ROWS_PER_THREAD  # every warp holds the same rows
ADD_MAX_COLS = 1024
ADD_MIN_COLS = 128  # 16 columns a warp: below, the rows' transforms weigh more than 10%
ADD_BLOCKS_PER_SM = 2  # 16 warps an SM: 4 ILP chains a thread keep the f32 pipes busy
ADD_WAVE_BLOCKS = 10   # two waves of the 5 blocks an SM holds
GRID_Y_MAX = 65535
INF_BITS = 0x7F800000  # +inf as int32: the scratch's resting value


class AddPlan(NamedTuple):
    row_tiles: int  # blocks of ADD_ROWS_PER_BLOCK ground-truth rows per pose
    chunks: int     # column chunks per pose
    cols: int       # predicted columns per chunk (the last may hold fewer)


def plan_add_dists(B: int, P: int, n_sm: int = 132) -> AddPlan:
    """K10's grid for B poses over P padded points on a card of n_sm SMs:
    (row_tiles x chunks, B) blocks. Column chunks hold at most ADD_MAX_COLS
    columns (the shared-memory stage), and there are at least enough of them
    for ADD_BLOCKS_PER_SM blocks on every SM, so B = 1 still fills the card,
    unless that would cut chunks below ADD_MIN_COLS columns. From there up
    to twice as many (while chunks keep ADD_MIN_COLS), the count that
    spreads the blocks most evenly over the SMs (the busiest SM sets the
    time), the fewest on a tie; where the grid holds two waves of blocks or
    more, the fewest (each block's staging and arrival cost more than the
    card's block scheduler loses to uneven clouds)."""
    if B < 1 or P < 1:
        raise ValueError(f"K10 needs poses and points, got B = {B}, P = {P}")
    if B > GRID_Y_MAX:
        raise ValueError(f"K10's grid holds at most {GRID_Y_MAX} poses a call, got {B}")
    row_tiles = -(-P // ADD_ROWS_PER_BLOCK)
    fill = -(-ADD_BLOCKS_PER_SM * n_sm // (B * row_tiles))
    lo = max(-(-P // ADD_MAX_COLS), min(fill, -(-P // ADD_MIN_COLS)))
    # from ADD_WAVE_BLOCKS blocks an SM on, the card's block scheduler evens the load
    hi = lo if B * row_tiles * lo >= ADD_WAVE_BLOCKS * n_sm else max(
        lo, min(2 * lo, -(-P // ADD_MIN_COLS)))
    best = None
    for want in range(lo, hi + 1):
        cols = -(-P // want)
        chunks = -(-P // cols)
        blocks = B * row_tiles * chunks
        key = (-(-blocks // n_sm) / blocks, chunks)  # busiest SM's share of the work
        if chunks >= lo and (best is None or key < best[0]):
            best = (key, AddPlan(row_tiles, chunks, cols))
    return best[1]


_work: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}
_work_lock = threading.Lock()
_n_sm: dict[int, int] = {}


def _workspace(dev: torch.device, stream: int, n_min: int, n_arrive: int, n_part: int):
    """K10's scratch on `stream`: (int32 [>= n_min] at +inf bits, int32
    [>= n_arrive] zeros, f64 [>= n_part]). Every launch leaves the words of
    the first two it used as it found them, so one set serves every call on
    the stream; it grows by fresh allocations (one fill launch each)."""
    key = (dev.index, stream)
    with _work_lock:
        w = _work.get(key)
        if w is None or w[0].numel() < n_min or w[1].numel() < n_arrive \
                or w[2].numel() < n_part:
            size = lambda i, k: max(k, 0 if w is None else w[i].numel())
            w = (torch.full((size(0, n_min),), INF_BITS, dtype=torch.int32, device=dev),
                 torch.zeros((size(1, n_arrive),), dtype=torch.int32, device=dev),
                 torch.empty((size(2, n_part),), dtype=torch.float64, device=dev))
            _work[key] = w
        return w


_ADD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)
_TWO_PASS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 6)


def _k10_inputs(points, n_pts, T_pred, T_gt, obj):
    B = T_pred.shape[0]
    n_rows, P = points.shape[:2]
    if obj is None and n_rows != B:
        raise ValueError("K10: without `obj`, points [B, P, 3] go with poses [B, 4, 4]")
    if points.shape != (n_rows, P, 3) or n_pts.shape != (n_rows,) \
            or (obj is not None and obj.shape != (B,)) \
            or T_pred.shape != (B, 4, 4) or T_gt.shape != (B, 4, 4):
        raise ValueError("K10: expected points [R, P, 3], n_pts [R], obj [B], poses [B, 4, 4]")
    fs = (points, T_pred, T_gt)
    if any(a.dtype != torch.float32 for a in fs):
        raise ValueError("K10 runs in f32")
    dev = points.device
    if any(a.device != dev for a in fs + (n_pts,) + (() if obj is None else (obj,))):
        raise ValueError("K10 inputs must lie on one CUDA device")
    if obj is not None:
        obj = obj.to(torch.int32).contiguous()
    return (*(a.contiguous() for a in fs), n_pts.to(torch.int32).contiguous(), obj, B, P, dev)


def _add_dists_cuda(points, n_pts, T_pred, T_gt, obj=None, per_point: bool = False,
                    two_pass: bool = False):
    """K10, one launch: the means as one [2, B] tensor (ADD, ADD-S), and with
    per_point the per-point distances as one [2, B, P] tensor beside it. See
    `add_dists_plain` for the arguments. `two_pass` launches the earlier
    design (two kernels; no `obj`), kept for comparisons."""
    if two_pass and obj is not None:
        raise ValueError("K10's two-kernel design reads gathered clouds, not table rows")
    pts, tp, tg, n, ob, B, P, dev = _k10_inputs(points, n_pts, T_pred, T_gt, obj)
    means = torch.empty((2, B), dtype=torch.float32, device=dev)
    d = torch.empty((2, B, P), dtype=torch.float32, device=dev)
    if two_pass:
        _add_dists_two_pass(pts, n, tp, tg, B, P, d, means)
    elif B > 0:
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in _n_sm:
            _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = plan_add_dists(B, P, _n_sm[idx])
        st = _build.stream(idx)
        tiles = B * plan.row_tiles
        mins, arrive, part = _workspace(dev, st, B * P, tiles + B, 2 * tiles)
        fn = _build.entry("add_dists", _ADD_ARGTYPES)
        err = fn(_build.ptr(pts), _build.ptr(n), None if ob is None else _build.ptr(ob),
                 _build.ptr(tp), _build.ptr(tg), B, P, plan.cols, plan.chunks, plan.row_tiles,
                 _build.ptr(mins), _build.ptr(arrive), _build.ptr(part), _build.ptr(d[0]),
                 _build.ptr(d[1]), _build.ptr(means[0]), _build.ptr(means[1]), st)
        _build.check(err, "K10 add_dists")
        kcount.count("add_dists")
    return (means, d) if per_point else means


def _add_dists_two_pass(pts, n, tp, tg, B, P, d, means):
    chunks = (P + 511) // 512 if P > 0 else 1
    part = torch.empty((B, chunks, P), dtype=torch.float32, device=pts.device)  # scratch
    fn = _build.entry("add_dists", _TWO_PASS_ARGTYPES, "suo_add_dists_two_pass")
    err = fn(_build.ptr(pts), _build.ptr(n), _build.ptr(tp), _build.ptr(tg), B, P,
             _build.ptr(part), _build.ptr(d[0]), _build.ptr(d[1]), _build.ptr(means[0]),
             _build.ptr(means[1]), _build.stream())
    _build.check(err, "K10 add_dists (two-pass design)")
    kcount.count("add_dists")


def add_dists(points, n_pts, T_pred, T_gt, obj=None):
    """Mean ADD and mean ADD-S as one [2, B] tensor, so that one copy brings
    both back (see `add_dists_plain`; `obj` reads a table of clouds): K10 on
    CUDA tensors, the plain version on CPU tensors."""
    if points.device.type == "cpu":
        return torch.stack(add_dists_plain(points, n_pts, T_pred, T_gt, obj=obj))
    if points.device.type != "cuda":
        raise ValueError(f"add_dists: unsupported device {points.device}")
    return _add_dists_cuda(points, n_pts, T_pred, T_gt, obj)


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
        """Score entries (object id, predicted pose, ground-truth pose) in
        order. An entry whose predicted pose is None is a missed detection
        (`update_no_det`). The others go to one `add_dists` call over the
        resident point table (on the card: K10's one launch, one copy of
        their poses and table rows in, one of the means out); the evaluation
        scores a whole scene with one call."""
        obj_ids = [int(o) for o in obj_ids]
        hit = [i for i, p in enumerate(poses_pred) if p is not None]
        add = adds = np.zeros((0,), np.float32)
        if hit:
            B = len(hit)
            buf = np.empty((33 * B,), np.float32)  # T_pred | T_gt | table rows (int32)
            buf[: 16 * B] = np.stack([_to44_np(poses_pred[i]) for i in hit]).reshape(-1)
            buf[16 * B: 32 * B] = np.stack([_to44_np(poses_gt[i]) for i in hit]).reshape(-1)
            buf[32 * B:].view(np.int32)[:] = [obj_ids[i] - 1 for i in hit]
            d = torch.from_numpy(buf).to(self.device)
            Tp, Tg = d[: 16 * B].view(B, 4, 4), d[16 * B: 32 * B].view(B, 4, 4)
            obj = d[32 * B:].view(torch.int32)
            add, adds = add_dists(self._points, self._counts, Tp, Tg, obj).cpu().numpy()
        is_sym = self.mesh_db.is_symmetric
        k = 0
        for i, o in enumerate(obj_ids):
            if poses_pred[i] is None:
                self.update_no_det([o])
                continue
            a, s = float(add[k]), float(adds[k])
            k += 1
            self.add_meter.update([o], [a])
            self.adds_meter.update([o], [s])
            self.add_maybe_s_meter.update([o], [s if is_sym[o - 1] else a])

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
