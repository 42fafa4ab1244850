"""Port parity for the SLAM front end's and tail's device programs (CPU
tensors: the plain version of K6 and of the BA kernels) against the JAX
`slam/kernels.py`, on one seeded synthetic frame: 8 mapped objects at ~10
units depth, 12 of 41 keypoints each, NDC intrinsics, sigma = 0.005 noise.

- chi2 counts, `camera_pose_ransac` and `reinit_counts`: counts EQUAL (no
  measurement is placed near the 5.991 threshold on purpose; both sides
  compute the same f32 chi2 in another order), argmax equal, the chosen
  camera pose within 1e-5;
- `frontend_step`'s slot branch (a padded slot = O is dropped): equal keep,
  pnp_ok, cam_ok and cam_count; information within 1e-6 relative; PnP poses
  within 1e-4 (the f32 PnP refine bound, tests/test_torch_pnp.py) and the
  camera built from them within 1e-3 absolute (translations ~10 units);
- `tracking_tail` with and without the symmetric group and the re-init
  vote, with `did_opt` true and false: equal mirrors, late, reinit_cond,
  did_opt and inlier row; obj_T and the tracked camera within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.slam import kernels as jk
from suo_slam_tpu.solvers import pnp as jpnp
from suo_slam_tpu_torch.slam import kernels as tk
from tests.helpers.synthetic_scene import NK

O, K, N_KP, SIGMA = 8, NK, 12, 0.005
K4 = np.array([3.0, 3.0, 0.0, 0.0], np.float32)


def _rot(rng, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(scale=scale, size=3)).as_matrix()


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


class Scene:
    """Map poses T_OtoG, model keypoints, and views T_GtoC with their noisy
    NDC detections (f32)."""

    def __init__(self, seed=0, n_views=4):
        rng = np.random.default_rng(seed)
        self.model_kp = np.zeros((O, K, 3), np.float32)
        self.mask = np.zeros((O, K), bool)
        self.T_obj = np.zeros((O, 4, 4))
        for o in range(O):
            ch = rng.choice(K, N_KP, replace=False)
            self.mask[o, ch] = True
            self.model_kp[o, ch] = rng.uniform(-0.5, 0.5, (N_KP, 3))
            self.T_obj[o] = _pose(_rot(rng, 0.5), [(o % 4) * 1.2 - 1.8, (o // 4) * 1.6 - 0.8,
                                                  10.0 + 0.3 * o])
        self.cams = np.stack([_pose(_rot(rng, 0.02), rng.normal(scale=0.2, size=3))
                              for _ in range(n_views)])
        self.uv = np.stack([self.project(T) + rng.normal(scale=SIGMA, size=(O, K, 2))
                            for T in self.cams]).astype(np.float32)
        self.rng = rng

    def project(self, T_GtoC, T_obj=None):
        T_obj = self.T_obj if T_obj is None else T_obj
        out = np.zeros((O, K, 2))
        for o in range(O):
            T = T_GtoC @ T_obj[o]
            p = self.model_kp[o] @ T[:3, :3].T + T[:3, 3]
            out[o] = K4[:2] * p[:, :2] / p[:, 2:] + K4[2:]
        return np.where(self.mask[..., None], out, 0.0)


def _info(shape):
    return np.broadcast_to(np.eye(2, dtype=np.float32) / SIGMA ** 2, shape + (2, 2)).copy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_chi2_counts_plain_matches_jax_per_set_and_per_object():
    sc = Scene(0)
    rng = np.random.default_rng(1)
    S = 6
    T = np.stack([sc.cams[0] @ sc.T_obj[o] for o in range(O)])
    T_sets = np.stack([T] * S).astype(np.float32)
    for s in range(1, S):  # perturbed pose sets score fewer inliers
        T_sets[s, :, :3, 3] += rng.normal(scale=0.01 * s, size=(O, 3))
    inl = sc.mask & (rng.uniform(size=(O, K)) < 0.9)
    uv, info = sc.uv[0], _info((O, K))
    k4 = np.broadcast_to(K4, (O, 4)).copy()
    cj = np.asarray(jk._chi2_counts(jnp.asarray(T_sets), sc.model_kp, uv[None], info[None],
                                    inl[None], k4[None], 5.991))
    ct = tk.chi2_counts_plain(_t(T_sets), _t(sc.model_kp), _t(uv[None]), _t(info[None]),
                              _t(inl[None]), _t(k4[None]))
    np.testing.assert_array_equal(cj, ct.numpy())
    assert len(set(cj.tolist())) > 2
    # per object over groups of M rows: the re-init form
    M = 3
    Tv = np.stack([np.stack([sc.cams[m] @ sc.T_obj[o] for o in range(O)]) for m in range(M)])
    Tv = np.concatenate([Tv, Tv + 0.02]).astype(np.float32)  # 2 groups of M sets
    uvm = sc.uv[:M]
    infom = _info((M, O, K))
    mk = np.broadcast_to(sc.mask, (M, O, K)).copy()
    k4m = np.broadcast_to(K4, (M, O, 4)).copy()
    ct = tk.chi2_counts_plain(_t(Tv), _t(sc.model_kp), _t(uvm), _t(infom), _t(mk), _t(k4m),
                              per_object=True)
    for g in range(2):
        cj = np.asarray(jk._chi2_counts(jnp.asarray(Tv[g * M:(g + 1) * M]), sc.model_kp,
                                        uvm, infom, mk, k4m, 5.991))  # [M] sums over (o, k)
        assert ct[g].sum() == cj.sum()
    assert ct[0].min() > 0 and ct[1].sum() < ct[0].sum()


def _ransac_inputs(seed):
    sc = Scene(seed)
    rng = np.random.default_rng(seed + 10)
    T_pnp = np.stack([sc.cams[1] @ sc.T_obj[o] for o in range(O)])
    T_pnp[:, :3, 3] += rng.normal(scale=0.01, size=(O, 3)) * np.arange(1, O + 1)[:, None]
    T_map = sc.T_obj.copy()
    T_map[:, :3, 3] += rng.normal(scale=0.005, size=(O, 3))
    pnp_ok = np.ones(O, bool)
    pnp_ok[5] = False
    obj_ok = np.ones(O, bool)
    obj_ok[6] = False
    inliers = sc.mask & (rng.uniform(size=(O, K)) < 0.9)
    inliers[3] = False  # an object with no inlier does not score
    k4 = np.broadcast_to(K4, (O, 4)).copy()
    return [a.astype(np.float32) if a.dtype.kind == "f" else a for a in
            (T_pnp, pnp_ok, T_map, obj_ok, sc.model_kp, sc.uv[1], _info((O, K)), inliers, k4)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_pose_ransac_matches_jax(seed):
    args = _ransac_inputs(seed)
    Tj, cj, okj = jk.camera_pose_ransac(*[jnp.asarray(a) for a in args])
    Tt, ct, okt = tk.camera_pose_ransac(*[_t(a) for a in args])
    assert int(cj) == int(ct) and bool(okj) == bool(okt) and bool(okt)
    np.testing.assert_allclose(np.asarray(Tj), Tt.numpy(), atol=1e-5, rtol=1e-5)
    # the argmax: the chosen hypothesis T_pnp[j] inv(T_map[j])
    T_pnp, T_map = args[0], args[2]
    hyps = [T_pnp[j] @ np.linalg.inv(T_map[j]) for j in range(O)]
    j = int(np.argmin([np.abs(h - Tt.numpy()).max() for h in hyps]))
    assert np.abs(hyps[j] - np.asarray(Tj)).max() < 1e-4
    # no candidate reaches min_num_inliers: identity, ok False
    Tn, cn, okn = tk.camera_pose_ransac(*[_t(a) for a in args], min_num_inliers=10_000)
    assert not bool(okn) and torch.equal(Tn, torch.eye(4)) and int(cn) == int(cj)


def test_reinit_counts_match_jax():
    sc = Scene(3, n_views=15)
    rng = np.random.default_rng(4)
    T_pnp = sc.T_obj.copy()
    T_est = sc.T_obj.copy()
    T_est[:3, :3, 3] += 0.3  # three objects whose map pose is off
    T_pnp[5, :3, 3] += 0.3   # one whose PnP pose is off
    cam_valid = np.ones(15, bool)
    cam_valid[12:] = False
    valid = np.broadcast_to(sc.mask, (15, O, K)) & (rng.uniform(size=(15, O, K)) < 0.85)
    args = [a.astype(np.float32) if a.dtype.kind == "f" else a for a in
            (T_pnp, T_est, sc.cams, cam_valid, sc.model_kp, sc.uv, _info((15, O, K)), valid,
             np.broadcast_to(K4, (15, O, 4)).copy())]
    pj, ej = jk.reinit_counts(*[jnp.asarray(a) for a in args])
    pt, et = tk.reinit_counts(*[_t(a) for a in args])
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    assert (et.numpy()[:3] < pt.numpy()[:3]).all() and et[5] > pt[5]


def _front_inputs(seed, of=3, ob=4):
    sc = Scene(seed)
    rng = np.random.default_rng(seed + 20)
    objs = [2, 5, 0]
    uv = np.zeros((ob, K, 2), np.float32)
    uv[:of] = sc.uv[1][objs]
    cov = np.zeros((ob, K, 2, 2), np.float32)
    cov[..., 0, 0] = cov[..., 1, 1] = SIGMA ** 2
    cov[..., 0, 1] = cov[..., 1, 0] = rng.uniform(-1, 1, (ob, K)) * 0.2 * SIGMA ** 2
    mask_prob = rng.uniform(0.2, 1.0, (ob, K)).astype(np.float32)
    mk = np.zeros((ob, K, 3), np.float32)
    mk[:of] = sc.model_kp[objs]
    mm = np.zeros((ob, K), bool)
    mm[:of] = sc.mask[objs]
    k4 = np.broadcast_to(K4, (ob, 4)).copy()
    diams = np.full((ob,), 1.0, np.float32)
    diams[of:] = np.inf
    slots = np.array(objs + [O] * (ob - of))
    obj_active = np.ones(O, bool)
    obj_active[0] = False
    T_map = sc.T_obj.astype(np.float32)
    return sc, (uv, cov, mask_prob, mk, mm, k4, diams), slots, T_map, obj_active


def test_frontend_step_slot_branch_matches_jax():
    sc, (uv, cov, mp, mk, mm, k4, diams), slots, T_map, obj_active = _front_inputs(0)
    key = jax.random.PRNGKey(5)
    thr = (np.float32(0.005), np.float32(0.9), np.float32(0.2), np.float32(0.3))
    dj = jk.frontend_step(jnp.asarray(uv), jnp.asarray(cov), jnp.asarray(mp), None,
                          jnp.asarray(mk), jnp.asarray(mm), jnp.asarray(k4), jnp.asarray(diams),
                          key, *thr, n_hyp=64, slots=jnp.asarray(slots, jnp.int32),
                          obj_T=jnp.asarray(T_map), obj_active=jnp.asarray(obj_active),
                          model_kp_full=jnp.asarray(sc.model_kp))

    def sampler(keep, n_hyp):
        keys = jax.random.split(key, keep.shape[0])
        return torch.from_numpy(np.stack([np.asarray(jpnp._sample_hypothesis_indices(
            keys[o], jnp.asarray(keep[o].numpy()), n_hyp)) for o in range(keep.shape[0])]))

    dt = tk.frontend_step(_t(uv), _t(cov), _t(mp), _t(mk), _t(mm), _t(k4), _t(diams), sampler,
                          0.005, 0.9, 0.2, 0.3, n_hyp=64, slots=_t(slots), obj_T=_t(T_map),
                          obj_active=_t(obj_active), model_kp_full=_t(sc.model_kp))
    for name in ("keep", "pnp_ok", "cam_ok", "cam_count", "std_cnt"):
        np.testing.assert_array_equal(np.asarray(dj[name]), dt[name].numpy(), err_msg=name)
    np.testing.assert_allclose(np.asarray(dj["info"]), dt["info"].numpy(), rtol=1e-6)
    assert bool(dt["cam_ok"]) and dt["pnp_ok"][:3].all() and not dt["pnp_ok"][3]
    ok = dt["pnp_ok"].numpy()
    Tj, Tt = np.asarray(dj["T_pnp"])[ok], dt["T_pnp"].numpy()[ok]
    np.testing.assert_allclose(Tj[:, :3, :3], Tt[:, :3, :3], atol=1e-4, rtol=0)
    assert np.abs(Tj[:, :3, 3] - Tt[:, :3, 3]).max() < 1e-4 * 10.0
    Cj, Ct = np.asarray(dj["T_cam"]), dt["T_cam"].numpy()
    np.testing.assert_allclose(Cj, Ct, atol=1e-3, rtol=0)


def _tail_inputs(seed, with_sym, with_reinit, n_row_inliers=None):
    sc = Scene(seed)
    rng = np.random.default_rng(seed + 30)
    V, v = 4, 2
    uv_m = sc.uv.copy()
    info_m = _info((V, O, K))
    valid_m = np.broadcast_to(sc.mask, (V, O, K)).copy()
    valid_m[v, 6:] = False  # objects 6, 7 not yet in this row
    inl_m = valid_m.copy()
    if n_row_inliers is not None:  # the < 3-edge gate
        inl_m[v] = False
        inl_m[v, 0, np.flatnonzero(sc.mask[0])[:n_row_inliers]] = True
    k4_m = np.broadcast_to(K4, (V, O, 4)).copy()
    cam_T_v = sc.cams[v].copy()
    cam_T_v[:3, 3] += rng.normal(scale=0.02, size=3)  # the tracking BA's job
    obj_T = sc.T_obj.copy()
    obj_active = np.ones(O, bool)
    obj_active[7] = False  # late init through the symmetric group
    f = lambda a: a.astype(np.float32)
    base = dict(uv_m=f(uv_m), info_m=info_m, valid_m=valid_m, inliers_m=inl_m, cam_k4_m=k4_m,
                model_kp_m=sc.model_kp, cam_T_v=f(cam_T_v), obj_T=f(obj_T),
                obj_active=obj_active)
    sym = None
    if with_sym:
        ob, objs = 4, [6, 7]
        uv = np.zeros((ob, K, 2), np.float32)
        uv[:2] = sc.uv[v][objs]
        keep = np.zeros((ob, K), bool)
        keep[:2] = sc.mask[objs]
        T_pnp = np.tile(np.eye(4, dtype=np.float32), (ob, 1, 1))
        T_pnp[:2] = np.stack([sc.cams[v] @ sc.T_obj[o] for o in objs])
        pnp_ok = np.array([True, True, False, False])
        sym = dict(slots=np.array(objs + [O, O]), uv=uv, info=_info((ob, K)), keep=keep,
                   T_pnp=T_pnp, pnp_ok=pnp_ok, cam_k4=np.broadcast_to(K4, (ob, 4)).copy())
    reinit = None
    if with_reinit:
        # object 1's map pose is off by 0.3 units; its PnP pose is right
        base["obj_T"][1, :3, 3] += 0.3
        cand = np.zeros(O, bool)
        cand[[0, 1, 2]] = True
        T_pnp_G = np.tile(np.eye(4, dtype=np.float32), (O, 1, 1))
        T_pnp_G[[0, 1, 2]] = sc.T_obj[[0, 1, 2]]
        n = 15
        cs = np.zeros(n, np.int64)
        cs[:3] = [2, 1, 0]
        cam_valid = np.zeros(n, bool)
        cam_valid[:3] = True
        reinit = dict(cand_sel=cand, T_pnp_G=T_pnp_G, cs=cs, cam_valid=cam_valid,
                      cam_T_w=f(sc.cams[cs]))
    return base, v, sym, reinit


@pytest.mark.parametrize("with_sym,with_reinit,n_row_inliers",
                         [(False, False, None), (True, True, None), (True, False, None),
                          (False, True, None), (False, False, 2)])
def test_tracking_tail_matches_jax(with_sym, with_reinit, n_row_inliers):
    base, v, sym, reinit = _tail_inputs(0, with_sym, with_reinit, n_row_inliers)
    jx = lambda d: None if d is None else {k: jnp.asarray(a) for k, a in d.items()}
    tt = lambda d: None if d is None else {k: _t(a) for k, a in d.items()}
    names = ("uv_m", "info_m", "valid_m", "inliers_m", "cam_k4_m", "model_kp_m")
    mj, oj = jk.tracking_tail(*[jnp.asarray(base[n]) for n in names], jnp.int32(v),
                              jnp.asarray(base["cam_T_v"]), jnp.asarray(base["obj_T"]),
                              jnp.asarray(base["obj_active"]), jx(sym), jx(reinit),
                              np.float32(1.0), False)
    mt, ot = tk.tracking_tail(*[_t(base[n].copy()) for n in names], v, _t(base["cam_T_v"]),
                              _t(base["obj_T"]), _t(base["obj_active"]), tt(sym), tt(reinit),
                              1.0, False)
    for a, b, n in zip(mj, mt, names):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=n)
    for n in ("late", "reinit_cond", "did_opt", "inliers_row"):
        np.testing.assert_array_equal(np.asarray(oj[n]), ot[n].numpy(), err_msg=n)
    np.testing.assert_allclose(np.asarray(oj["obj_T"]), ot["obj_T"].numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj["cam_T_v"]), ot["cam_T_v"].numpy(), atol=1e-4)
    assert bool(ot["did_opt"]) == (n_row_inliers is None)
    if with_sym:
        assert bool(ot["late"][7]) and not ot["late"][6]
    if with_reinit:
        assert bool(ot["reinit_cond"][1]) and int(ot["reinit_cond"].sum()) == 1
    if n_row_inliers is None:  # the tracking BA reduced the row's residuals
        sc, m = Scene(0), base["valid_m"][v]
        obj_T = ot["obj_T"].numpy().astype(np.float64)
        rms = lambda T: np.sqrt(np.mean(((sc.project(T.astype(np.float64), obj_T)
                                          - base["uv_m"][v]) ** 2)[m]))
        assert rms(ot["cam_T_v"].numpy()) < min(0.7 * rms(base["cam_T_v"]),
                                                1.05 * rms(sc.cams[v]))
