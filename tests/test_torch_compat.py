"""The compat shims and `ba.lm_run` of the port against the JAX package's,
on the CPU (`device="cpu"`: the plain versions of K4, K7 and K15):

- `ba.lm_run` against the JAX `lm_run` on one problem: Huber on and off,
  `tracking_only` both ways, a frozen camera and a frozen object; poses
  within 1e-4 (rotation entries absolute, translations relative to their
  scale), the final damping within a few of its steps;
- the four graphs of `tests/test_compat_g2o.py` (plain, a fixed object,
  a gross outlier under a small and under a huge Huber delta) through both
  g2o shims: every vertex estimate within 1e-4 (translations relative to
  the scene's depth, 600: its points lie 600 units ahead of the cameras, so
  a camera's translation is determined only to that scale — under the small
  delta both shims stop 0.05 units apart along that direction at costs
  equal to 3e-7, every edge's residual within 4e-6) and every edge's
  residual within 1e-4; the duplicate-edge refusal;
- `lambdatwist.pnp` of both shims on clean points within 1e-4 of the true
  pose; the identity under 4 points; ValueError on bad shapes.

Tolerance: both sides run f32 LM (or RANSAC + Gauss-Newton) on the same
problem; their sums differ in order, and 1e-4 is the f32 poses' scale of
that difference after tens of iterations (the port's BA tests hold its
eager schedule to JAX's at 1e-4 too). The card tests
(`tests/test_torch_cuda_parallel.py`, `cuda`) hold the same calls on CUDA
tensors to their CPU runs and count K4 / K7 / K15.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suo_slam_tpu.compat import g2o as jg2o
from suo_slam_tpu.compat import lambdatwist as jlt
from suo_slam_tpu.solvers import ba as jba
from suo_slam_tpu_torch import kernels
from suo_slam_tpu_torch.compat import g2o as tg2o
from suo_slam_tpu_torch.compat import lambdatwist as tlt
from suo_slam_tpu_torch.solvers import ba as tba
from tests.helpers.threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _pose_close(a, b, scale=None):
    """The larger of the rotation entries' largest difference and the
    translations' relative to `scale` (default: their own, at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rot = np.abs(a[..., :3, :3] - b[..., :3, :3]).max()
    sc = max(np.abs(b[..., :3, 3]).max(), 1.0) if scale is None else scale
    tr = np.abs(a[..., :3, 3] - b[..., :3, 3]).max() / sc
    return max(rot, tr)


def _rot(rng, s):
    w = rng.normal(size=3) * s
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _lm_problem(seed=0, V=4, O=2, K=8):
    """A small BA problem in NDC units: V cameras around O objects, noisy
    measurements, a few invalid edges, perturbed starting poses."""
    rng = np.random.default_rng(seed)
    obj_gt = np.tile(np.eye(4), (O, 1, 1))
    for o in range(O):
        obj_gt[o, :3, 3] = [0.15 * o - 0.1, 0.02 * o, 0.0]
    cam_gt = np.tile(np.eye(4), (V, 1, 1))
    for v in range(V):
        cam_gt[v, :3, :3] = _rot(rng, 0.1)
        cam_gt[v, :3, 3] = [0.05 * v, -0.02 * v, 1.0 + 0.05 * v]
    pts = rng.uniform(-0.05, 0.05, (O, K, 3))
    cam_k = np.tile(np.array([1.2, 1.2, 0.0, 0.0]), (V, O, 1))
    uv = np.zeros((V, O, K, 2))
    for v in range(V):
        for o in range(O):
            p = (cam_gt[v] @ obj_gt[o] @ np.c_[pts[o], np.ones(K)].T).T[:, :3]
            uv[v, o] = 1.2 * p[:, :2] / p[:, 2:3]
    uv += rng.normal(0, 2e-3, uv.shape)
    valid = rng.uniform(size=(V, O, K)) > 0.15
    info = np.tile(np.eye(2) * 100.0, (V, O, K, 1, 1))
    cam0, obj0 = cam_gt.copy(), obj_gt.copy()
    for v in range(1, V):
        cam0[v, :3, :3] = _rot(rng, 0.02) @ cam0[v, :3, :3]
        cam0[v, :3, 3] += rng.normal(0, 0.01, 3)
    for o in range(O):
        obj0[o, :3, 3] += rng.normal(0, 0.01, 3)
    f = np.float32
    return dict(cam_T=cam0.astype(f), obj_T=obj0.astype(f), uv=uv.astype(f), info=info.astype(f),
                model_kp=pts.astype(f), cam_k=cam_k.astype(f), valid=valid, inliers=valid,
                cam_active=np.ones(V, bool), obj_active=np.ones(O, bool),
                cam_frozen=np.arange(V) == 0, obj_frozen=np.arange(O) == 1)


LM_CASES = [(huber, track) for huber in (False, True) for track in (False, True)]


@pytest.mark.parametrize("huber,tracking", LM_CASES)
def test_lm_run_matches_jax(huber, tracking):
    p = _lm_problem()
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    jc, jo, jl = jba.lm_run(jp, 20, jnp.asarray(huber), tracking_only=tracking)
    tp = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in p.items()})
    kernels.reset_counts()
    tc, to, tl = tba.lm_run(tp, 20, huber, tracking_only=tracking)
    assert sum(kernels.counts().values()) == 0  # CPU tensors: the plain versions
    assert _pose_close(tc.numpy(), np.asarray(jc)) <= TOL
    assert _pose_close(to.numpy(), np.asarray(jo)) <= TOL
    # the final damping halves or quadruples a step: which iteration meets the
    # convergence test last is decided by f32 rounding once the gain is ~1e-6
    assert 1 / 16 <= float(tl) / float(jl) <= 16
    # the frozen object (every object when tracking) stays; so does the frozen
    # camera, except in tracking mode, which frees every camera with 3 edges
    np.testing.assert_allclose(to[1].numpy(), p["obj_T"][1], atol=1e-6)
    if tracking:
        np.testing.assert_allclose(to.numpy(), p["obj_T"], atol=1e-6)
    else:
        np.testing.assert_allclose(tc[0].numpy(), p["cam_T"][0], atol=1e-6)
    moved = np.abs(tc[1:].numpy() - p["cam_T"][1:]).max()
    assert moved > 1e-4  # the free cameras did move


def _build_graph(g2o, obj0_fixed=False, outlier=False, huber_delta=None, seed=0, **opt_kw):
    """`tests/test_compat_g2o.py`'s graph: 2 cameras x 2 objects x 12 points
    through the public g2o API of the shim `g2o`."""
    rng = np.random.default_rng(seed)
    k4 = np.array([1.2, 1.2, 0.0, 0.0])
    opt = g2o.SparseOptimizer(**opt_kw)
    opt.set_algorithm(g2o.OptimizationAlgorithmLevenberg(
        g2o.BlockSolverSE3(g2o.LinearSolverDenseSE3())))
    objs, obj_T_gt = [], []
    for j in range(2):
        T = np.eye(4)
        T[:3, 3] = [60.0 * j - 30.0, 0.0, 600.0]
        v = g2o.VertexSE3Expmap()
        v.set_id(j)
        v.set_estimate(g2o.SE3Quat(T[:3, :3], T[:3, 3]))
        v.set_fixed(obj0_fixed and j == 0)
        opt.add_vertex(v)
        objs.append(v)
        obj_T_gt.append(T)
    cams, cam_T_gt = [], []
    for i in range(2):
        T = np.eye(4)
        T[:3, 3] = [5.0 * i, 0.0, 0.0]
        v = g2o.VertexSE3Expmap()
        v.set_id(2 + i)
        T0 = T.copy()
        if i == 1:
            T0[:3, 3] += [3.0, -2.0, 4.0]
        v.set_estimate(g2o.SE3Quat(T0[:3, :3], T0[:3, 3]))
        v.set_fixed(i == 0)
        opt.add_vertex(v)
        cams.append(v)
        cam_T_gt.append(T)
    pts = rng.uniform(-40, 40, (2, 12, 3))
    for j in range(2):
        for i in range(2):
            for p in pts[j]:
                p_g = obj_T_gt[j][:3, :3] @ p + obj_T_gt[j][:3, 3]
                p_c = cam_T_gt[i][:3, :3] @ p_g + cam_T_gt[i][:3, 3]
                e = g2o.EdgeSE3ProjectFromObject(k4, p)
                e.set_vertex(0, objs[j])
                e.set_vertex(1, cams[i])
                e.set_measurement(1.2 * p_c[:2] / p_c[2] + rng.normal(0, 1e-3, 2))
                e.set_information(np.eye(2) * 1e4)
                if huber_delta is not None:
                    e.set_robust_kernel(g2o.RobustKernelHuber(huber_delta))
                opt.add_edge(e)
    if outlier:
        e = g2o.EdgeSE3ProjectFromObject(k4, np.array([17.0, -23.0, 11.0]))
        e.set_vertex(0, objs[1])
        e.set_vertex(1, cams[1])
        e.set_measurement(np.array([0.9, -0.9]))
        e.set_information(np.eye(2) * 1e4)
        if huber_delta is not None:
            e.set_robust_kernel(g2o.RobustKernelHuber(huber_delta))
        opt.add_edge(e)
    return opt, objs, cams


SCENE_DEPTH = 600.0  # the graphs' objects lie this far ahead of the cameras
GRAPHS = {"plain": dict(), "fixed_object": dict(obj0_fixed=True),
          "huber_small": dict(outlier=True, huber_delta=0.5, seed=1),
          "huber_large": dict(outlier=True, huber_delta=1e4, seed=1)}


@pytest.mark.parametrize("case", list(GRAPHS))
def test_g2o_shims_agree(case):
    kw = GRAPHS[case]
    n_iters = 20 if case in ("plain", "fixed_object") else 30
    got, res = [], []
    for g2o, extra in ((jg2o, {}), (tg2o, {"device": "cpu"})):
        opt, objs, cams = _build_graph(g2o, **kw, **extra)
        opt.initialize_optimization(0)
        assert opt.optimize(n_iters) == n_iters
        got.append([v.estimate().matrix() for v in objs + cams])
        res.append(np.asarray([e.error() for e in opt.edges()]))
    for a, b in zip(*got):
        assert _pose_close(b, a, scale=SCENE_DEPTH) <= TOL, case
    assert np.abs(res[1] - res[0]).max() <= TOL, case
    if kw.get("obj0_fixed"):
        T = np.eye(4)
        T[:3, 3] = [-30.0, 0.0, 600.0]
        np.testing.assert_array_equal(got[1][0], T)


def test_g2o_refuses_duplicate_edges_and_mixed_graphs():
    opt, objs, cams = _build_graph(tg2o, device="cpu")
    e = tg2o.EdgeSE3ProjectFromObject(np.array([1.2, 1.2, 0.0, 0.0]), opt.edges()[0].p_inO)
    e.set_vertex(0, objs[0])
    e.set_vertex(1, cams[0])
    e.set_measurement(np.array([0.1, 0.2]))
    e.set_information(np.eye(2))
    opt.add_edge(e)
    opt.initialize_optimization(0)
    with pytest.raises(ValueError, match="duplicate keypoint edge"):
        opt.optimize(5)
    opt2, _, cams2 = _build_graph(tg2o, device="cpu")
    u = tg2o.EdgeSE3ProjectFromFixedObject(np.array([1.2, 1.2, 0.0, 0.0]), np.zeros(3), np.eye(4))
    u.set_vertex(0, cams2[0])
    opt2.add_edge(u)
    opt2.initialize_optimization(0)
    with pytest.raises(NotImplementedError, match="mixed unary/binary"):
        opt2.optimize(5)
    assert opt2.optimize.__self__ is opt2 and tg2o.set_native_lm is not None


def test_g2o_unary_graph_and_native_hook():
    """Tracking graphs (unary edges against a baked object pose) agree; the
    test-only `set_native_lm` hook takes the packed problem instead."""
    rng = np.random.default_rng(3)
    k4 = np.array([1.2, 1.2, 0.0, 0.0])
    obj = np.eye(4)
    obj[:3, 3] = [0.0, 0.0, 600.0]
    pts = rng.uniform(-200, 200, (14, 3))  # a wide view: the pose is well determined
    noise = rng.normal(0, 1e-3, (14, 2))
    res = []
    for g2o, extra in ((jg2o, {}), (tg2o, {"device": "cpu"})):
        opt = g2o.SparseOptimizer(**extra)
        cam = g2o.VertexSE3Expmap()
        cam.set_id(0)
        T0 = np.eye(4)
        T0[:3, 3] = [2.0, -1.0, 3.0]
        cam.set_estimate(g2o.SE3Quat(T0[:3, :3], T0[:3, 3]))
        opt.add_vertex(cam)
        for p, dn in zip(pts, noise):
            pc = obj[:3, :3] @ p + obj[:3, 3]
            e = g2o.EdgeSE3ProjectFromFixedObject(k4, p, obj)
            e.set_vertex(0, cam)
            e.set_measurement(1.2 * pc[:2] / pc[2] + dn)
            e.set_information(np.eye(2) * 1e4)
            e.set_robust_kernel(g2o.RobustKernelHuber(np.sqrt(5.991)))
            opt.add_edge(e)
        opt.initialize_optimization(0)
        opt.optimize(10)
        res.append(cam.estimate().matrix())
    assert _pose_close(res[1], res[0], scale=SCENE_DEPTH) <= TOL
    calls = []
    tg2o.set_native_lm(lambda cam_T, obj_T, *a: calls.append(a[-3:]) or (cam_T, obj_T))
    try:
        opt, _, _ = _build_graph(tg2o, device="cpu")
        opt.initialize_optimization(0)
        assert opt.optimize(7) == 7
    finally:
        tg2o.set_native_lm(None)
    assert calls == [(False, False, tg2o.ba_mod.HUBER_DELTA)]


def _pnp_case(seed, n):
    rng = np.random.default_rng(seed)
    R = _rot(rng, 0.4)
    t = np.array([0.1, -0.05, 2.0])
    x = rng.uniform(-0.5, 0.5, (n, 3))
    pc = x @ R.T + t
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return x, pc[:, :2] / pc[:, 2:3], T


@pytest.mark.parametrize("n", [6, 41])
def test_lambdatwist_shims_find_the_pose(n):
    x, y, T = _pnp_case(n, n)
    for got in (jlt.pnp(x, y), tlt.pnp(x, y, device="cpu")):
        assert got.shape == (4, 4) and got.dtype == np.float64
        assert _pose_close(got, T) <= TOL


def test_lambdatwist_identity_and_bad_shapes():
    x, y, _ = _pnp_case(0, 3)
    np.testing.assert_array_equal(tlt.pnp(x, y, device="cpu"), np.eye(4))
    with pytest.raises(ValueError, match="bad shapes"):
        tlt.pnp(np.zeros((5, 2)), np.zeros((5, 2)), device="cpu")
    with pytest.raises(ValueError, match="bad shapes"):
        tlt.pnp(np.zeros((5, 3)), np.zeros((4, 2)), device="cpu")


def test_shims_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card contract is not testable")
    x, y, _ = _pnp_case(0, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tlt.pnp(x, y)
    with pytest.raises(RuntimeError, match="cuda"):
        tg2o.SparseOptimizer()
