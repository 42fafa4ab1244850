"""Port parity for bundle adjustment: kernel K4's plain version
(`_edge_planes_Hg`, `_edge_chi2`) at 1e-9 relative to the largest entry in
f64, kernel K7's plain version (`_solve_normal_eq_schur` on CPU tensors:
free, frozen and tracking masks, a non-PD block) at 1e-10 absolute + 1e-8
relative in f64, and `optimize` on `tests/test_ba.py`-style problems, global
and tracking: equal inlier sets, poses within 1e-8 in f64 and 1e-4 in f32
(rotation absolute, translation relative to its norm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.solvers import ba as jba
from suo_slam_tpu_torch.solvers import ba as tba
from tests.test_ba import make_problem


def _to_torch(prob, dtype):
    def t(a):
        if a is None:
            return None
        a = np.asarray(a)
        return torch.from_numpy(a.astype(dtype) if a.dtype.kind == "f" else a.copy())

    return tba.BAProblem(*[t(a) for a in prob])


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("use_huber", [True, False])
def test_edge_assembly_matches_jax_f64(use_huber):
    prob, *_ = make_problem(n_views=3, n_objs=3, V=4, O=4, K=12, noise=0.01,
                            outlier_frac=0.2, pose_noise=0.01, seed=3)
    tp = _to_torch(prob, np.float64)
    inl = np.asarray(prob.valid) & (np.random.default_rng(0).uniform(size=prob.valid.shape) < 0.8)
    H, g, c2, z = jba._edge_planes_Hg(prob.cam_T, prob.obj_T, prob.uv, prob.info,
                                      prob.model_kp, prob.cam_k, inl=jnp.asarray(inl),
                                      use_huber=use_huber,
                                      huber_d=jnp.asarray(jba.HUBER_DELTA))
    Ht, gt, c2t, zt = tba._edge_planes_Hg(tp.cam_T, tp.obj_T, tp.uv, tp.info, tp.model_kp,
                                          tp.cam_k, inl=torch.from_numpy(inl),
                                          use_huber=use_huber, huber_d=tba.HUBER_DELTA)
    assert _rel(H, Ht.numpy()) < 1e-9
    assert _rel(g, gt.numpy()) < 1e-9
    assert _rel(c2, c2t.numpy()) < 1e-9
    assert _rel(z, zt.numpy()) < 1e-12
    _, c2j = jba._edge_chi2(prob.cam_T, prob.obj_T, prob.uv, prob.info, prob.model_kp,
                            prob.cam_k)
    assert _rel(c2j, tba._edge_chi2(tp.cam_T, tp.obj_T, tp.uv, tp.info, tp.model_kp,
                                    tp.cam_k).numpy()) < 1e-9


def test_schur_solve_matches_jax_f64():
    prob, *_ = make_problem(n_views=4, n_objs=3, V=5, O=4, K=10, noise=0.005,
                            pose_noise=0.01, seed=4)
    tp = _to_torch(prob, np.float64)
    H, g, _, _ = tba._edge_planes_Hg(tp.cam_T, tp.obj_T, tp.uv, tp.info, tp.model_kp,
                                     tp.cam_k, inl=tp.valid, use_huber=False,
                                     huber_d=tba.HUBER_DELTA)
    Hcc, Hoo, Hco = H[..., :6, :6].sum(1), H[..., 6:, 6:].sum(0), H[..., :6, 6:]
    gc, go = g[..., :6].sum(1), g[..., 6:].sum(0)
    cam_free = np.array([False, True, True, True, False])
    obj_free = np.array([True, True, True, False])
    dj = jba._solve_normal_eq_schur(*(jnp.asarray(a.numpy()) for a in (Hcc, Hoo, Hco, gc, go)),
                                    jnp.asarray(cam_free), jnp.asarray(obj_free), 1e-3)
    dt = tba._solve_normal_eq_schur(Hcc, Hoo, Hco, gc, go, torch.from_numpy(cam_free),
                                    torch.from_numpy(obj_free),
                                    torch.tensor(1e-3, dtype=torch.float64))
    assert bool(dj[2]) and bool(dt[2])
    np.testing.assert_allclose(np.asarray(dj[0]), dt[0].numpy(), atol=1e-10, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dj[1]), dt[1].numpy(), atol=1e-10, rtol=1e-8)
    # a non-PD camera block: NaN factor -> zero step, ok False (no raise)
    bad = Hcc.clone()
    bad[1] = -torch.eye(6, dtype=torch.float64) * 1e6
    dcb, dob, okb = tba._solve_normal_eq_schur(bad, Hoo, Hco, gc, go,
                                               torch.from_numpy(cam_free),
                                               torch.from_numpy(obj_free),
                                               torch.tensor(0.0, dtype=torch.float64))
    assert not bool(okb) and not dcb.any() and not dob.any()


def _normal_eq(prob, seed=0):
    tp = _to_torch(prob, np.float64)
    inl = tp.valid & torch.from_numpy(np.random.default_rng(seed).uniform(
        size=tuple(tp.valid.shape)) < 0.9)
    H, g, _, _ = tba._edge_planes_Hg(tp.cam_T, tp.obj_T, tp.uv, tp.info, tp.model_kp,
                                     tp.cam_k, inl=inl, use_huber=True,
                                     huber_d=tba.HUBER_DELTA)
    return H[..., :6, :6].sum(1), H[..., 6:, 6:].sum(0), H[..., :6, 6:], g[..., :6].sum(1), \
        g[..., 6:].sum(0)


@pytest.mark.parametrize("cam_free,obj_free", [
    ([True] * 5, [False] * 4),                              # tracking: objects frozen
    ([False, False, False, False, False], [True, True, True, True]),  # cameras frozen
    ([False, True, False, True, True], [True, False, True, False]),
])
def test_schur_solve_masks_match_jax_f64(cam_free, obj_free):
    prob, *_ = make_problem(n_views=4, n_objs=3, V=5, O=4, K=10, noise=0.005,
                            pose_noise=0.01, seed=7)
    blocks = _normal_eq(prob)
    cf, of = np.array(cam_free), np.array(obj_free)
    dj = jba._solve_normal_eq_schur(*(jnp.asarray(a.numpy()) for a in blocks),
                                    jnp.asarray(cf), jnp.asarray(of), 1e-2)
    dt = tba._solve_normal_eq_schur(*blocks, torch.from_numpy(cf), torch.from_numpy(of),
                                    torch.tensor(1e-2, dtype=torch.float64),
                                    objects_frozen=not of.any())
    assert bool(dj[2]) and bool(dt[2])
    np.testing.assert_allclose(np.asarray(dj[0]), dt[0].numpy(), atol=1e-10, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dj[1]), dt[1].numpy(), atol=1e-10, rtol=1e-8)
    assert not dt[0][~torch.from_numpy(cf)].any() and not dt[1][~torch.from_numpy(of)].any()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 1e-4)])
def test_optimize_tracking_matches_jax(dtype, tol):
    """The tracking tail's call: one camera row, every object fixed, no
    gauge, rounds (10, 10, 10, 10), with and without init_with_outliers."""
    prob, *_ = make_problem(n_views=3, n_objs=4, V=3, O=4, K=12, noise=0.003,
                            outlier_frac=0.1, seed=8, dtype=dtype)
    row = lambda a: None if a is None else a[2:3]
    cam_T = np.array(prob.cam_T[2:3])
    cam_T[0, :3, 3] += np.array([3.0, -2.0, 4.0], dtype)  # the tracking BA's job
    prob = prob._replace(cam_T=cam_T, uv=row(prob.uv), info=row(prob.info),
                         cam_k=row(prob.cam_k), valid=row(prob.valid),
                         inliers=row(prob.inliers), cam_active=np.ones((1,), bool),
                         cam_frozen=None)
    for iwo in (False, True):
        kw = dict(iters_per_round=(10, 10, 10, 10), tracking_only=True, fix_first_cam=False,
                  init_with_outliers=iwo)
        r = jba.optimize(jba.BAProblem(*[None if a is None else jnp.asarray(a) for a in prob]),
                         **kw)
        rt = tba.optimize(_to_torch(prob, dtype), **kw)
        np.testing.assert_array_equal(np.asarray(r.inliers), rt.inliers.numpy())
        _assert_poses(r.cam_T, rt.cam_T.numpy(), tol)
        np.testing.assert_array_equal(np.asarray(r.obj_T), rt.obj_T.numpy())
        assert np.abs(rt.cam_T.numpy() - np.asarray(prob.cam_T)).max() > 1e-3  # it moved


def _assert_poses(Tj, Tt, tol):
    Tj = np.asarray(Tj)
    np.testing.assert_allclose(Tj[..., :3, :3], Tt[..., :3, :3], atol=tol, rtol=0)
    dt = np.abs(Tj[..., :3, 3] - Tt[..., :3, 3])
    scale = np.maximum(np.linalg.norm(Tj[..., :3, 3], axis=-1, keepdims=True), 1.0)
    np.testing.assert_array_less(dt, np.broadcast_to(tol * scale, dt.shape))


SINGLE_VIEW = dict(n_views=1, n_objs=4, V=16, O=8, K=12, noise=0.002, outlier_frac=0.1,
                   pose_noise=0.003)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8), (np.float32, 1e-4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_single_view_matches_jax(dtype, tol, seed):
    """The engine's single-view call: one camera (the fixed gauge), objects
    free, rounds (10, 10, 10, 10)."""
    prob, *_ = make_problem(**SINGLE_VIEW, seed=seed, dtype=dtype)
    r = jba.optimize(prob, iters_per_round=(10, 10, 10, 10))
    rt = tba.optimize(_to_torch(prob, dtype), iters_per_round=(10, 10, 10, 10))
    np.testing.assert_array_equal(np.asarray(r.inliers), rt.inliers.numpy())
    assert int(rt.num_inliers) > 20
    _assert_poses(r.cam_T, rt.cam_T.numpy(), tol)
    _assert_poses(r.obj_T, rt.obj_T.numpy(), tol)


def test_optimize_multi_view_matches_jax_f64():
    """The solver is general: several free cameras, Huber schedule over
    (10, 10, 40, 40), inlier reclassification."""
    prob, *_ = make_problem(n_views=4, n_objs=3, V=6, O=4, K=12, noise=0.003,
                            outlier_frac=0.15, pose_noise=0.01, seed=5)
    r = jba.optimize(prob)
    rt = tba.optimize(_to_torch(prob, np.float64))
    np.testing.assert_array_equal(np.asarray(r.inliers), rt.inliers.numpy())
    _assert_poses(r.cam_T, rt.cam_T.numpy(), 1e-8)
    _assert_poses(r.obj_T, rt.obj_T.numpy(), 1e-8)
    np.testing.assert_allclose(float(r.total_chi2), float(rt.total_chi2), rtol=1e-8)


def test_reorthonormalize():
    rng = np.random.default_rng(6)
    T = np.tile(np.eye(4), (5, 1, 1))
    T[:, :3, :3] += rng.normal(scale=1e-3, size=(5, 3, 3))
    np.testing.assert_allclose(np.asarray(jba._reorthonormalize(jnp.asarray(T))),
                               tba._reorthonormalize(torch.from_numpy(T)).numpy(),
                               atol=1e-12)


def test_k4_gate_holds_each_entry_to_its_own_scale():
    """chip_smoke's K4 gate on its main-path problem (plain H/g on the CPU):
    an error far below 1e-4 of max|H| but far above the object-translation
    entries' own size fails it, as does any value in an inactive block."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    p = cs._ba_problem("cpu", rng, cs.Objects(rng))
    d = tba.HUBER_DELTA
    H, g, chi2, _ = tba._edge_planes_Hg_plain(p.cam_T, p.obj_T, p.uv, p.info,
                                              p.model_kp, p.cam_k, p.valid, True, d)
    assert cs.k4_scaled_errors(H, g, H, g, chi2, p.valid, d) == (0.0, 0.0)
    big = H.abs().max()
    assert H[0, 0, 9, 9] < 1e-5 * big  # translation x translation
    Hb = H.clone()
    Hb[0, 0, 9, 9] += 1e-5 * big
    assert cs.k4_scaled_errors(Hb, g, H, g, chi2, p.valid, d)[0] > 1e-4
    gb = g.clone()
    gb[1, 0, 0] = 1e-6  # view 1 is inactive: its blocks are exactly 0
    assert cs.k4_scaled_errors(H, gb, H, g, chi2, p.valid, d)[1] == float("inf")


def test_k7_gate_scales_each_six_block():
    """chip_smoke's K7 gate: each entry of d_cam / d_obj over the largest
    |entry| of the plain version's 6-vector block; a block that is exactly 0
    must stay exactly 0, and a non-finite step fails."""
    import chip_smoke as cs

    p = (torch.tensor([[1.0, -2.0, 0.5, 0, 0, 0], [0.0] * 6]),
         torch.tensor([[1e-3, 0, 0, 0, 0, 2e-3]]))
    assert cs.k7_scaled_errors(p, p) == (0.0, 0.0)
    k = (p[0] + torch.tensor([[0, 1e-4, 0, 0, 0, 0], [0.0] * 6]), p[1] + 1e-7)
    sc, so = cs.k7_scaled_errors(k, p)
    assert sc == pytest.approx(5e-5, rel=0.01) and so == pytest.approx(5e-5, rel=0.01)
    k = (p[0] + torch.tensor([[0.0] * 6, [0, 0, 1e-9, 0, 0, 0]]), p[1])
    assert cs.k7_scaled_errors(k, p)[0] == float("inf")
    k = (p[0] * float("nan"), p[1])
    assert cs.k7_scaled_errors(k, p)[0] == float("inf")
