"""Drop-in for the reference's `g2o` pybind module (the consumed surface).

Port of `suo_slam_tpu/compat/g2o.py`: the same classes, methods and error
messages — SparseOptimizer, BlockSolverSE3 / LinearSolver{Dense,Cholmod,
Eigen}SE3, OptimizationAlgorithmLevenberg, SE3Quat, VertexSE3Expmap,
EdgeSE3ProjectFromObject, EdgeSE3ProjectFromFixedObject, RobustKernelHuber,
edge set_level / chi2 / compute_error — backed by `solvers/ba.lm_run` (K4
and K7 each LM iteration on the card, their plain versions on the CPU)
instead of the vendored g2o C++ library.

Semantics, as in the JAX shim:
  - `initialize_optimization(level)` + `optimize(n)` runs LM over the edges
    at that level only (the reference's inlier / outlier switch);
  - vertices with `set_fixed(True)` do not move (gauge fixing);
  - `chi2()` is the unweighted e^T Info e at the current vertex estimates
    (g2o's chi2() leaves out the robust kernel), so `compute_error()` has
    nothing to refresh;
  - a RobustKernelHuber on the edges turns on the Huber IRLS weighting of
    the LM run, with its delta.

The edge model is the reference's custom edges': r = uv_meas - pi(cam_k,
T_CW T_WO p_O), left-multiplicative se(3). Packing the graph into a
`BAProblem` pads views, objects and keypoints to power-of-two buckets, so
the solver sees a handful of shapes. `SparseOptimizer(device="cuda")` (the
default; `device="cpu"` for the plain versions) holds the problem on its
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..solvers import ba as ba_mod

# Test-only back-end swap: when set, each `optimize(n)` call hands the same
# packed problem to this function (a native g2o build, for one) instead of
# `ba.lm_run`, so the caller's control flow can be driven by another solver
# as a closed-loop oracle.
_native_lm = None


def set_native_lm(fn) -> None:
    """Install (or clear, fn=None) the native-g2o LM backend hook."""
    global _native_lm
    _native_lm = fn


def _bucket(n: int, lo: int = 4) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _to44(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    out = np.eye(4)
    out[: T.shape[0], :4] = T[:, :4]
    return out


class SE3Quat:
    """Minimal SE3 value type: `g2o.SE3Quat(R, t)` / `.matrix()`."""

    def __init__(self, R=None, t=None):
        self._T = np.eye(4)
        if R is not None:
            self._T[:3, :3] = np.asarray(R, np.float64)
        if t is not None:
            self._T[:3, 3] = np.asarray(t, np.float64).ravel()

    @classmethod
    def _from_matrix(cls, T):
        out = cls()
        out._T = _to44(T)
        return out

    def matrix(self) -> np.ndarray:
        return self._T.copy()

    def rotation(self):
        return self._T[:3, :3].copy()

    def translation(self):
        return self._T[:3, 3].copy()

    def map(self, p):
        p = np.asarray(p, np.float64)
        return p @ self._T[:3, :3].T + self._T[:3, 3]


class VertexSE3Expmap:
    def __init__(self):
        self._id = -1
        self._fixed = False
        self._T = np.eye(4)

    def set_id(self, i):
        self._id = int(i)

    def id(self):
        return self._id

    def set_fixed(self, fixed):
        self._fixed = bool(fixed)

    def fixed(self):
        return self._fixed

    def set_estimate(self, est: SE3Quat):
        self._T = _to44(est.matrix() if isinstance(est, SE3Quat) else est)

    def estimate(self) -> SE3Quat:
        return SE3Quat._from_matrix(self._T)


class RobustKernelHuber:
    def __init__(self, delta: float):
        self.delta = float(delta)


class LinearSolverDenseSE3:
    pass


class LinearSolverCholmodSE3:
    pass


class LinearSolverEigenSE3:
    pass


class BlockSolverSE3:
    def __init__(self, linear_solver):
        self.linear_solver = linear_solver


class OptimizationAlgorithmLevenberg:
    def __init__(self, block_solver):
        self.block_solver = block_solver


class _BaseEdge:
    """Shared measurement/bookkeeping for both object-SLAM edge types."""

    def __init__(self, cam_k):
        self.cam_k = np.asarray(cam_k, np.float64).ravel()  # (fx, fy, cx, cy)
        self._vertices = {}
        self._measurement = np.zeros(2)
        self._information = np.eye(2)
        self._robust_kernel = None
        self._level = 0

    def set_vertex(self, i, v):
        self._vertices[int(i)] = v

    def vertex(self, i):
        return self._vertices[int(i)]

    def set_measurement(self, uv):
        self._measurement = np.asarray(uv, np.float64).ravel()

    def measurement(self):
        return self._measurement.copy()

    def set_information(self, info):
        self._information = np.asarray(info, np.float64)

    def information(self):
        return self._information.copy()

    def set_robust_kernel(self, kernel):
        self._robust_kernel = kernel

    def robust_kernel(self):
        return self._robust_kernel

    def set_level(self, level):
        self._level = int(level)

    def level(self):
        return self._level

    def compute_error(self):
        # chi2() always evaluates at current vertex estimates, so there is
        # no cached-error state to refresh (see module docstring).
        return None

    def _p_in_cam(self) -> np.ndarray:
        raise NotImplementedError

    def error(self) -> np.ndarray:
        p_C = self._p_in_cam()
        z = p_C[2]
        uv_est = np.array(
            [
                self.cam_k[0] * p_C[0] / z + self.cam_k[2],
                self.cam_k[1] * p_C[1] / z + self.cam_k[3],
            ]
        )
        return self._measurement - uv_est

    def chi2(self) -> float:
        e = self.error()
        return float(e @ self._information @ e)

    def is_depth_positive(self) -> bool:
        return bool(self._p_in_cam()[2] > 0.0)


class EdgeSE3ProjectFromObject(_BaseEdge):
    """Binary edge: vertex 0 = object T_OtoG, vertex 1 = camera T_GtoC
    (`types_object_slam.cpp:45-60`)."""

    def __init__(self, cam_k, p_inO):
        super().__init__(cam_k)
        self.p_inO = np.asarray(p_inO, np.float64).ravel()

    def _p_in_cam(self):
        T_wo = self._vertices[0]._T
        T_cw = self._vertices[1]._T
        p_G = T_wo[:3, :3] @ self.p_inO + T_wo[:3, 3]
        return T_cw[:3, :3] @ p_G + T_cw[:3, 3]


class EdgeSE3ProjectFromFixedObject(_BaseEdge):
    """Unary edge: vertex 0 = camera; object pose baked in as a plain
    array exactly like the reference passes it (`lib/object_slam.py:750,
    816-818`; `types_object_slam.cpp:156-169`)."""

    def __init__(self, cam_k, p_inO, obj_pose):
        super().__init__(cam_k)
        self.p_inO = np.asarray(p_inO, np.float64).ravel()
        self.obj_pose = _to44(obj_pose)
        self.p_inG = self.obj_pose[:3, :3] @ self.p_inO + self.obj_pose[:3, 3]

    def _p_in_cam(self):
        T_cw = self._vertices[0]._T
        return T_cw[:3, :3] @ self.p_inG + T_cw[:3, 3]


class SparseOptimizer:
    def __init__(self, device="cuda"):
        self._vertices = []   # insertion order (g2o gauge = first camera added)
        self._edges = []
        self._level = 0
        self._verbose = False
        self._device = _device.resolve_device(device)

    # --- graph construction -------------------------------------------------
    def set_algorithm(self, algorithm):
        self._algorithm = algorithm

    def set_verbose(self, v):
        self._verbose = bool(v)

    def add_vertex(self, v):
        self._vertices.append(v)
        return True

    def add_edge(self, e):
        self._edges.append(e)
        return True

    def vertices(self):
        return {v.id(): v for v in self._vertices}

    def edges(self):
        return list(self._edges)

    def initialize_optimization(self, level=0):
        self._level = int(level)
        return True

    # --- solve ---------------------------------------------------------------
    def optimize(self, n_iters: int):
        """One LM run over the level-selected subgraph via `ba.lm_run`."""
        edges = [e for e in self._edges if e._level == self._level]
        if not edges:
            return 0
        unary = all(isinstance(e, EdgeSE3ProjectFromFixedObject) for e in edges)
        binary = all(isinstance(e, EdgeSE3ProjectFromObject) for e in edges)
        if not (unary or binary):
            raise NotImplementedError(
                "g2o shim: mixed unary/binary edge graphs are not used by the "
                "reference engine and are not supported"
            )

        # --- camera slots, graph insertion order ---
        cam_verts, cam_slot = [], {}
        for e in edges:
            cv = e._vertices[0] if unary else e._vertices[1]
            if id(cv) not in cam_slot:
                cam_slot[id(cv)] = len(cam_verts)
                cam_verts.append(cv)

        # --- object slots ---
        # binary: the object VertexSE3Expmap; unary: group edges by the baked
        # object pose (the reference shares one pose slice per object,
        # `lib/object_slam.py:750`).
        obj_entries, obj_slot = [], {}
        for e in edges:
            key = id(e._vertices[0]) if binary else e.obj_pose.tobytes()
            if key not in obj_slot:
                obj_slot[key] = len(obj_entries)
                obj_entries.append(e._vertices[0] if binary else e.obj_pose)

        V, O = len(cam_verts), len(obj_entries)
        Vc, Oc = _bucket(V), _bucket(O, lo=2)

        # --- keypoint slots per object: dedupe by exact model-point value
        # (views observing the same object share 3D points but may see
        # different subsets) ---
        kp_index = [dict() for _ in range(O)]  # point bytes -> k
        edge_vok = []
        for e in edges:
            if unary:
                v = cam_slot[id(e._vertices[0])]
                o = obj_slot[e.obj_pose.tobytes()]
            else:
                v = cam_slot[id(e._vertices[1])]
                o = obj_slot[id(e._vertices[0])]
            kmap = kp_index[o]
            pkey = e.p_inO.tobytes()
            if pkey not in kmap:
                kmap[pkey] = (len(kmap), e.p_inO)
            edge_vok.append((v, o, kmap[pkey][0]))
        Kmax = max(len(m) for m in kp_index)
        Kc = _bucket(Kmax, lo=8)

        # --- pack the padded problem ---
        f32 = np.float32
        cam_T = np.tile(np.eye(4, dtype=f32), (Vc, 1, 1))
        obj_T = np.tile(np.eye(4, dtype=f32), (Oc, 1, 1))
        uv = np.zeros((Vc, Oc, Kc, 2), f32)
        info = np.zeros((Vc, Oc, Kc, 2, 2), f32)
        model_kp = np.zeros((Oc, Kc, 3), f32)
        cam_k = np.zeros((Vc, Oc, 4), f32)
        cam_k[..., :2] = 1.0  # benign fx,fy for padded slots
        valid = np.zeros((Vc, Oc, Kc), bool)
        cam_active = np.zeros((Vc,), bool)
        obj_active = np.zeros((Oc,), bool)
        cam_frozen = np.zeros((Vc,), bool)

        for v, cv in enumerate(cam_verts):
            cam_T[v] = cv._T.astype(f32)
            cam_active[v] = True
            cam_frozen[v] = cv._fixed
        for o, entry in enumerate(obj_entries):
            T = entry._T if binary else entry
            obj_T[o] = _to44(T).astype(f32)
            obj_active[o] = True
            for k, p in kp_index[o].values():
                model_kp[o, k] = p
        # Duplicate (v,o,k) assignments SHOULD not occur — the reference adds
        # one edge per detected keypoint per (view, object)
        # (`object_slam.py:813`) — but keypoint slots here dedupe by exact
        # p_inO bytes, so a kp config with byte-identical duplicate model
        # points would silently collapse two real g2o edges into one. Raise
        # instead of corrupting the problem.
        for e, (v, o, k) in zip(edges, edge_vok):
            if valid[v, o, k]:
                raise ValueError(
                    f"duplicate keypoint edge for (view={v}, object={o}, "
                    f"kp_slot={k}): two edges in the same (view, object) "
                    "share byte-identical model points (duplicate keypoint "
                    "in the kp config?) — this packed-slot backend cannot "
                    "represent them as separate edges like native g2o"
                )
            uv[v, o, k] = e._measurement
            info[v, o, k] = e._information
            cam_k[v, o] = e.cam_k
            valid[v, o, k] = True

        use_huber = any(e._robust_kernel is not None for e in edges)
        obj_fixed = np.array(
            [bool(entry._fixed) if binary else False
             for entry in obj_entries], bool)
        delta = float(next((e._robust_kernel.delta for e in edges
                            if e._robust_kernel is not None),
                           ba_mod.HUBER_DELTA))
        if _native_lm is not None:
            cam_out, obj_out = _native_lm(
                cam_T[:V], obj_T[:O], cam_frozen[:V], obj_fixed,
                uv[:V, :O], info[:V, :O], model_kp[:O], cam_k[:V, :O],
                valid[:V, :O], int(n_iters), unary, use_huber, float(delta))
            for v, cv in enumerate(cam_verts):
                if not cv._fixed:
                    cv._T = np.asarray(cam_out[v], np.float64)
            if binary:
                for o, ov in enumerate(obj_entries):
                    if not ov._fixed:
                        ov._T = np.asarray(obj_out[o], np.float64)
            return int(n_iters)

        obj_frozen = np.zeros((Oc,), bool)
        obj_frozen[:O] = obj_fixed
        t = lambda a: torch.from_numpy(a).to(self._device)
        problem = ba_mod.BAProblem(
            cam_T=t(cam_T),
            obj_T=t(obj_T),
            uv=t(uv),
            info=t(info),
            model_kp=t(model_kp),
            cam_k=t(cam_k),
            valid=t(valid),
            inliers=t(valid),
            cam_active=t(cam_active),
            obj_active=t(obj_active),
            cam_frozen=t(cam_frozen),
            obj_frozen=t(obj_frozen),
        )
        cam_out, obj_out, _lam = ba_mod.lm_run(
            problem,
            n_iters=int(n_iters),
            use_huber=bool(use_huber),
            tracking_only=unary,
            fix_first_cam=False,
            huber_delta=delta,
        )
        cam_out = cam_out.cpu().numpy().astype(np.float64)
        obj_out = obj_out.cpu().numpy().astype(np.float64)

        # --- write back to the vertices (fixed ones did not move) ---
        for v, cv in enumerate(cam_verts):
            if not cv._fixed:
                cv._T = cam_out[v]
        if binary:
            for o, ov in enumerate(obj_entries):
                if not ov._fixed:
                    ov._T = obj_out[o]
        return int(n_iters)
