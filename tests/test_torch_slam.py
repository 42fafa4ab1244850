"""SLAM and SfM modes end to end: the port's `ObjectSlam` (`device="cpu"`,
the plain versions of K1-K7) against the JAX engine on
`tests/helpers/synthetic_scene.py` scenes, frame by frame.

The frame inference is injected: each group's projected ground-truth
keypoints plus seeded N(0, 0.005) NDC noise, cov sigma^2 I, validity 1, and
it records the prior keypoints the engine hands it. The hypothesis sampler
replays the JAX engine's key chain (`tests/test_torch_slice.jax_key_chain`),
which follows the JAX key order within a frame: the backup pose when a later
frame has no non-symmetric object, the non-symmetric group, the backup pose
when RANSAC gave no camera, the symmetric group.

Equal after every frame: `view_ids`, `valid`, `inliers`, `cam_active`,
`obj_active`, which calls got a prior and `prior_valid`. Poses — the
collect_results T_OtoC (rotation absolute, translation relative to its norm,
~600-800 mm here) and the cameras (rotation absolute, translation relative to
the scene depth DEPTH; the first camera's own translation is ~0.1 mm, so a
bound relative to it measures nothing) — within TOL = 1e-4 after a global
BA (every frame in SfM and single view, every `global_opt_every` views and
at `collect_results(final=True)` in SLAM mode), and within TOL_FRAME = 5e-4
after a tracked frame. The gap of a tracked frame is that of the raw f32 PnP
poses of its newly initialized objects (12 keypoints spanning ~80 pixels):
measured up to 1.4e-4 in rotation under the tier-1 XLA options, 4e-5 with
full optimization; the global BA brings both engines back within ~2e-5.
The projected prior keypoints inherit that map gap — a 1e-5 relative pose
gap at 600 mm moves a keypoint ~1e-4 NDC of a 100-pixel box — so they agree
within PRIOR_TOL = 1e-3 NDC in the closed loop; with the map copied from the
JAX engine the prior projection itself agrees within 1e-5
(`test_prior_projection_matches_jax_on_the_same_map`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.slam import ObjectSlam as JaxSlam
from suo_slam_tpu.slam import SlamConfig as JaxConfig
from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig
from tests.helpers.synthetic_scene import NK, StubMeshDb, make_scene, project_frame, rot_err_deg
from tests.test_torch_slice import jax_key_chain

TOL = 1e-4
TOL_FRAME = 5e-4
PRIOR_TOL = 1e-3
DEPTH = 600.0  # the synthetic scene's nearest object depth (mm)


class GtInfer:
    """Injected frame inference: the group's projected ground-truth
    keypoints plus seeded noise (sigma NDC), cov sigma^2 I (or None),
    validity 1; records (prior_uv, prior_valid, has_prior) of every call."""

    supports_no_prior = True

    def __init__(self, to_device, sigma=0.005, seed=0, with_cov=True):
        self.to_device = to_device
        self.sigma = sigma
        self.with_cov = with_cov
        self.rng = np.random.default_rng(seed)
        self.calls = []

    def set_frame(self, bboxes, uvs):
        self.boxes = np.asarray(bboxes)
        self.uv = (uvs + self.rng.normal(scale=self.sigma, size=uvs.shape)).astype(np.float32)

    def __call__(self, img, boxes, obj_valid, prior_uv, prior_valid, has_prior=True):
        bx = np.asarray(boxes.cpu() if isinstance(boxes, torch.Tensor) else boxes)
        ob = bx.shape[0]
        uv = np.zeros((ob, NK, 2), np.float32)
        for i in range(ob):
            hit = np.flatnonzero(np.all(np.abs(self.boxes - bx[i]) < 1e-3, axis=1))
            if hit.size:
                uv[i] = self.uv[hit[0]]
        pu = prior_uv.cpu() if isinstance(prior_uv, torch.Tensor) else prior_uv
        pv = prior_valid.cpu() if isinstance(prior_valid, torch.Tensor) else prior_valid
        self.calls.append((np.asarray(pu), np.asarray(pv), has_prior))
        cov = None
        if self.with_cov:
            cov = self.to_device(np.broadcast_to(
                np.eye(2, dtype=np.float32) * self.sigma ** 2, (ob, NK, 2, 2)).copy())
        return self.to_device(uv), cov, self.to_device(np.ones((ob, NK), np.float32))


def _engines(mesh, seed=0, with_cov=True, **kw):
    inf_j = GtInfer(jnp.asarray, seed=seed, with_cov=with_cov)
    inf_t = GtInfer(torch.from_numpy, seed=seed, with_cov=with_cov)
    eng_j = JaxSlam(JaxConfig(**kw), mesh_db=mesh, infer_fn=inf_j)
    eng_t = ObjectSlam(SlamConfig(**kw), mesh_db=mesh, infer_fn=inf_t,
                       hyp_sampler=jax_key_chain, device="cpu")
    return (eng_j, inf_j), (eng_t, inf_t)


def _assert_pose(Tj, Tt, scale, what, tol):
    np.testing.assert_allclose(Tj[:3, :3], Tt[:3, :3], atol=tol, rtol=0, err_msg=what)
    dt = np.abs(Tj[:3, 3] - Tt[:3, 3]).max()
    assert dt < tol * scale, (what, dt, scale)


def _compare_state(eng_j, eng_t, inf_j, inf_t, frame, tol=TOL):
    assert eng_j.view_ids == eng_t.view_ids, frame
    for name in ("valid", "inliers", "cam_active", "obj_active"):
        np.testing.assert_array_equal(getattr(eng_j, name), getattr(eng_t, name),
                                      err_msg=f"{name}, frame {frame}")
    assert len(inf_j.calls) == len(inf_t.calls), frame
    gap = 0.0
    for (uj, vj, hj), (ut, vt, ht) in zip(inf_j.calls, inf_t.calls):
        np.testing.assert_array_equal(vj, vt, err_msg=f"prior_valid, frame {frame}")
        assert hj == ht, frame
        gap = max(gap, float(np.abs(np.where(vj[..., None], uj - ut, 0.0)).max()))
    assert gap < PRIOR_TOL, (frame, gap)
    for view in eng_j.view_ids:
        Tj = eng_j.cam_T[eng_j.view_slot[view]]
        Tt = eng_t.cam_T[eng_t.view_slot[view]]
        _assert_pose(Tj, Tt, DEPTH, f"camera of view {view}, frame {frame}", tol)
    rj, rt = eng_j.collect_results(), eng_t.collect_results()
    assert rj.keys() == rt.keys()
    n_posed = 0
    for view in rj:
        pj, pt = rj[view]["poses"], rt[view]["poses"]
        assert pj.keys() == pt.keys(), (view, frame)
        for obj_id in pj:
            assert pj[obj_id]["score"] == pt[obj_id]["score"], (view, obj_id, frame)
            Tj, Tt = pj[obj_id]["T_OtoC"], pt[obj_id]["T_OtoC"]
            assert (Tj is None) == (Tt is None), (view, obj_id, frame)
            if Tj is not None:
                n_posed += 1
                _assert_pose(Tj, Tt, np.linalg.norm(Tj[:3, 3]),
                             f"object {obj_id} in view {view}, frame {frame}", tol)
    return n_posed, gap


def _run(pair_j, pair_t, scene, cam_pose=False, final=True):
    (eng_j, inf_j), (eng_t, inf_t) = pair_j, pair_t
    K, hw, kp, T_obj, cams = scene
    img = np.zeros(hw + (3,), np.float32)
    gaps = []
    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        for inf in (inf_j, inf_t):
            inf.set_frame(bboxes, uvs)
        n_opt = len(eng_t.opt_times)
        for eng in (eng_j, eng_t):
            eng.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms,
                             cam_pose=T if cam_pose else None)
        # a frame whose global BA ran compares at TOL, a tracked frame at
        # TOL_FRAME (its new objects are raw PnP poses)
        tol = TOL if len(eng_t.opt_times) > n_opt else TOL_FRAME
        gaps.append(_compare_state(eng_j, eng_t, inf_j, inf_t, i, tol)[1])
    if final:
        eng_j.collect_results(final=True)
        eng_t.collect_results(final=True)
        _compare_state(eng_j, eng_t, inf_j, inf_t, "final")
    return gaps


def _recovers(eng, scene, rot_deg=2.0, trans=15.0):
    K, hw, kp, T_obj, cams = scene
    res = eng.collect_results()
    n = 0
    for i, T_GtoC in enumerate(cams):
        for obj_id, p in res.get(i, {"poses": {}})["poses"].items():
            if p["T_OtoC"] is None:
                continue
            T_gt = T_GtoC @ T_obj[obj_id]
            assert rot_err_deg(p["T_OtoC"][:3, :3], T_gt[:3, :3]) < rot_deg
            assert np.linalg.norm(p["T_OtoC"][:3, 3] - T_gt[:3, 3]) < trans
            n += 1
    return n


def test_slam_default_with_symmetric_objects_matches_jax():
    """SLAM mode: 2 of 4 objects symmetric (prior feedback, late init, the
    symmetric scatter of the tracking tail), global BA every 3 views."""
    mesh = StubMeshDb(8, symmetric=(2, 4))
    pj, pt = _engines(mesh, global_opt_every=3)
    scene = make_scene(n_obj=4, n_views=6, seed=0)
    _run(pj, pt, scene)
    # the symmetric group really got priors from the map
    assert sum(int(v.any()) for _, v, _ in pt[1].calls) >= 4
    assert _recovers(pt[0], scene) >= 20


def test_sfm_mode_matches_jax():
    pj, pt = _engines(StubMeshDb(8), sfm_mode=True)
    scene = make_scene(n_obj=3, n_views=4, seed=1)
    _run(pj, pt, scene, final=False)
    assert _recovers(pt[0], scene) >= 10


def test_given_camera_poses_match_jax():
    """External camera poses: every object takes the prior path."""
    pj, pt = _engines(StubMeshDb(8))
    scene = make_scene(n_obj=3, n_views=4, seed=2)
    _run(pj, pt, scene, cam_pose=True)
    assert all(h for _, _, h in pt[1].calls[3:])


def test_symmetric_only_frames_take_the_backup_pose():
    """Every object symmetric: from the second frame on there is no
    non-symmetric group, so the camera comes from the backup pose (bbox
    centroid PnP over >= 4 mapped objects, the sampler's single-set call)."""
    mesh = StubMeshDb(8, symmetric=(1, 2, 3, 4))
    pj, pt = _engines(mesh)
    scene = make_scene(n_obj=4, n_views=4, seed=3)
    calls = []
    single = jax_key_chain.single

    def spy(self, mask, n_hyp):
        calls.append(n_hyp)
        return single(self, mask, n_hyp)

    jax_key_chain.single = spy
    try:
        _run(pj, pt, scene)
    finally:
        jax_key_chain.single = single
    assert calls and set(calls) == {128}


def test_capacity_growth_matches_jax():
    pj, pt = _engines(StubMeshDb(8), view_capacity=4, obj_capacity=4)
    scene = make_scene(n_obj=5, n_views=5, seed=4)
    _run(pj, pt, scene)
    assert pt[0].V == 8 and pt[0].O == 8


def test_max_active_views_matches_jax():
    pj, pt = _engines(StubMeshDb(8), global_opt_every=2, max_active_views=2)
    scene = make_scene(n_obj=3, n_views=5, seed=5)
    _run(pj, pt, scene)


def test_ref_manual_info_reads_the_runs_information_source():
    """ref_manual_info rescales the BA information of a run whose
    information is manual — the front end got cov None — whatever
    no_network_cov says. Single view, inference without covariance, a few
    corrupted keypoints that the 1/sigma^2 gate would reject and the
    rescaled (identity) gate keeps: equal inlier masks and poses."""
    mesh = StubMeshDb(8)
    kw = dict(single_view_mode=True, ref_manual_info=True)
    (eng_j, inf_j), (eng_t, inf_t) = _engines(mesh, with_cov=False, **kw)
    K, hw, kp, T_obj, cams = make_scene(n_obj=3, n_views=2, seed=6)
    img = np.zeros(hw + (3,), np.float32)
    rng = np.random.default_rng(1)
    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        uvs[:, :2] += rng.uniform(0.05, 0.1, (len(obj_ids), 2, 2))
        for inf in (inf_j, inf_t):
            inf.set_frame(bboxes, uvs)
        for eng in (eng_j, eng_t):
            eng.reset()
            eng.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms)
        _compare_state(eng_j, eng_t, inf_j, inf_t, i)
        # the corrupted edges stayed inliers under the identity information
        v = eng_t.view_slot[i]
        assert eng_t.inliers[v].sum() == eng_t.valid[v].sum()
        assert eng_t._manual_info_run and not eng_t.cfg.no_network_cov


def test_mixed_information_sources_raise_as_in_jax():
    """A run whose information switches between network and manual raises
    (ValueError), as the JAX engine does."""
    mesh = StubMeshDb(8)
    (_, _), (eng_t, inf_t) = _engines(mesh)
    K, hw, kp, T_obj, cams = make_scene(n_obj=3, n_views=2, seed=7)
    img = np.zeros(hw + (3,), np.float32)
    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        inf_t.set_frame(bboxes, uvs)
        inf_t.with_cov = i == 0
        if i == 0:
            eng_t.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms)
        else:
            with pytest.raises(ValueError, match="mixed manual/network"):
                eng_t.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms)


def test_prior_projection_matches_jax_on_the_same_map():
    """The prior keypoints the symmetric group hands the network, with the
    port's map state copied from the JAX engine before the frame: equal
    prior_valid and prior_uv within 1e-5 NDC (both project in f64 on the
    host)."""
    mesh = StubMeshDb(8, symmetric=(1, 3))
    (eng_j, inf_j), (eng_t, inf_t) = _engines(mesh)
    K, hw, kp, T_obj, cams = make_scene(n_obj=3, n_views=3, seed=8)
    img = np.zeros(hw + (3,), np.float32)
    n_prior = 0
    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        for inf in (inf_j, inf_t):
            inf.set_frame(bboxes, uvs)
        eng_t.cam_T[:] = eng_j.cam_T
        eng_t.obj_T[:] = eng_j.obj_T
        for eng in (eng_j, eng_t):
            eng.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms, cam_pose=T)
        (uj, vj, _), (ut, vt, _) = inf_j.calls[-1], inf_t.calls[-1]
        np.testing.assert_array_equal(vj, vt)
        np.testing.assert_allclose(uj[vj], ut[vt], atol=1e-5, rtol=0)
        n_prior += int(vj.any())
    assert n_prior >= 2


@pytest.mark.parametrize("capacity", [16, 2])
def test_device_mirrors_stay_consistent(capacity):
    """The port's device mirrors of the measurement buffers equal the host
    buffers after every frame and after the final global BA, also across
    capacity growth (which drops and rebuilds them)."""
    mesh = StubMeshDb(8, symmetric=(2,))
    (_, _), (eng, inf) = _engines(mesh, global_opt_every=3, view_capacity=capacity,
                                  obj_capacity=capacity)
    K, hw, kp, T_obj, cams = make_scene(n_obj=3, n_views=5, seed=10)
    img = np.zeros(hw + (3,), np.float32)

    def check():
        for name in eng._MIRRORED:
            if name in eng._dev:
                np.testing.assert_array_equal(eng._dev[name].numpy(), getattr(eng, name),
                                              err_msg=name)

    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        inf.set_frame(bboxes, uvs)
        eng.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms)
        check()
    eng.collect_results(final=True)
    check()
    assert set(eng._dev) == set(eng._MIRRORED)  # every mirror was exercised
    assert eng.V == (16 if capacity == 16 else 8)
