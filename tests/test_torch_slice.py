"""The single-view SUO-SLAM slice end to end: the port's `ObjectSlam`
(`device="cpu"`, plain versions of K1-K4) against the JAX engine on
`tests/helpers/synthetic_scene.py` scenes, one `reset()` per view as
`evaluate.py --nviews 1` drives it.

(a) a small PkpNet whose flax weights are carried across, with a hypothesis
    sampler that replays the JAX engine's key chain (reset -> PRNGKey(seed),
    one split per frame, `jax.random.split(key, O)` per object);
(b) an injected ground-truth `infer_fn` (projected keypoints + seeded noise,
    cov sigma^2 I, validity 1), so that PnP and BA really move the poses.

collect_results poses agree within 1e-4 (rotation absolute, translation
relative to its norm — the f32 bound of the PnP refine, see
test_torch_pnp.py) with equal inlier counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from suo_slam_tpu.models import PkpNet as JaxPkpNet
from suo_slam_tpu.slam import ObjectSlam as JaxSlam
from suo_slam_tpu.slam import SlamConfig as JaxConfig
from suo_slam_tpu.solvers import pnp as jpnp
from suo_slam_tpu_torch.models.convert import backbone_config, from_jax_variables
from suo_slam_tpu_torch.models.pkpnet import PkpNet
from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig
from tests.helpers.synthetic_scene import NK, StubMeshDb, make_scene, project_frame, rot_err_deg

TOL = 1e-4


class jax_key_chain:
    """hyp_sampler factory replaying the JAX engine's RANSAC key stream
    (reset -> PRNGKey(seed), one split per call): a group call splits its
    key per object (`pnp_ransac_batch`), the backup camera pose's single-set
    call uses its key whole (`pnp_ransac`)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def __call__(self, keep, n_hyp):
        keys = jax.random.split(self._next(), keep.shape[0])
        m = keep.cpu().numpy()
        return torch.from_numpy(np.stack([
            np.asarray(jpnp._sample_hypothesis_indices(keys[o], jnp.asarray(m[o]), n_hyp))
            for o in range(m.shape[0])
        ]))

    def single(self, mask, n_hyp):
        m = jnp.asarray(mask.cpu().numpy())
        return torch.from_numpy(np.asarray(
            jpnp._sample_hypothesis_indices(self._next(), m, n_hyp)))


def _compare(eng_j, eng_t, res_j, res_t):
    assert res_j.keys() == res_t.keys()
    n_posed = 0
    for view in res_j:
        pj, pt = res_j[view]["poses"], res_t[view]["poses"]
        assert pj.keys() == pt.keys()
        for obj_id in pj:
            assert pj[obj_id]["score"] == pt[obj_id]["score"], obj_id
            Tj, Tt = pj[obj_id]["T_OtoC"], pt[obj_id]["T_OtoC"]
            assert (Tj is None) == (Tt is None), obj_id
            if Tj is None:
                continue
            n_posed += 1
            np.testing.assert_allclose(Tj[:3, :3], Tt[:3, :3], atol=TOL, rtol=0)
            assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() < TOL * np.linalg.norm(Tj[:3, 3])
    np.testing.assert_array_equal(eng_j.inliers, eng_t.inliers)
    np.testing.assert_array_equal(eng_j.valid, eng_t.valid)
    return n_posed


def _run(engines, scene, frame_fn=None):
    K, hw, kp, T_obj, cams = scene
    img = np.random.default_rng(11).uniform(0, 1, hw + (3,)).astype(np.float32)
    out = []
    for i, T in enumerate(cams):
        obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K, hw, kp, T_obj, T)
        if frame_fn is not None:
            frame_fn(i, obj_ids, uvs)
        res = []
        for eng in engines:
            eng.reset()
            eng.process_view(i, img, K, obj_ids, bboxes, mks, mms, kms)
            res.append(eng.collect_results())
        out.append(res)
    return out


def test_slice_with_converted_network_matches_jax():
    jnet = JaxPkpNet(n_stack=2, n_modules=1, features=16)
    v = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tnet = PkpNet(**backbone_config(v))
    tnet.load_state_dict(from_jax_variables(v))
    kw = dict(single_view_mode=True, input_hw=(64, 64), mask_thresh=-1.0,
              kp_var_thresh=10.0, bbox_thresh=1.5)
    mesh = StubMeshDb(8)
    eng_j = JaxSlam(JaxConfig(**kw), mesh_db=mesh, net=jnet, params=v)
    eng_t = ObjectSlam(SlamConfig(**kw), mesh_db=mesh, net=tnet,
                       hyp_sampler=jax_key_chain, device="cpu")
    for (rj, rt) in _run([eng_j, eng_t], make_scene(n_obj=3, n_views=2, seed=1)):
        _compare(eng_j, eng_t, rj, rt)
        np.testing.assert_allclose(eng_j.uv, eng_t.uv, atol=2e-4)
    assert eng_t.avg_std_n == eng_j.avg_std_n > 0
    np.testing.assert_allclose(eng_t.avg_kp_std(), eng_j.avg_kp_std(), rtol=1e-4)


class GtInfer:
    """Injected frame inference: the current frame's projected GT keypoints
    plus seeded noise (sigma NDC), cov sigma^2 I, validity 1."""

    def __init__(self, to_device, sigma=0.005, seed=0):
        self.to_device = to_device
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.uv = None

    def set_frame(self, uvs):
        self.uv = (uvs + self.rng.normal(scale=self.sigma, size=uvs.shape)).astype(np.float32)

    def __call__(self, img, boxes, obj_valid, prior_uv=None, prior_valid=None):
        ob, of = boxes.shape[0], self.uv.shape[0]
        uv = np.zeros((ob, NK, 2), np.float32)
        uv[:of] = self.uv
        cov = np.broadcast_to(np.eye(2, dtype=np.float32) * self.sigma ** 2,
                              (ob, NK, 2, 2)).copy()
        return self.to_device(uv), self.to_device(cov), self.to_device(np.ones((ob, NK),
                                                                              np.float32))


def test_slice_with_ground_truth_keypoints_matches_jax_and_recovers_poses():
    inf_j = GtInfer(jnp.asarray)
    inf_t = GtInfer(torch.from_numpy)
    kw = dict(single_view_mode=True)
    mesh = StubMeshDb(8, diameter=100.0)
    eng_j = JaxSlam(JaxConfig(**kw), mesh_db=mesh, infer_fn=inf_j)
    eng_t = ObjectSlam(SlamConfig(**kw), mesh_db=mesh, infer_fn=inf_t,
                       hyp_sampler=jax_key_chain, device="cpu")
    scene = make_scene(n_obj=4, n_views=3, seed=0)
    K, hw, kp, T_obj, cams = scene

    def frame(i, obj_ids, uvs):
        inf_j.set_frame(uvs)
        inf_t.set_frame(uvs)

    n_posed = 0
    for i, (rj, rt) in enumerate(_run([eng_j, eng_t], scene, frame)):
        n_posed += _compare(eng_j, eng_t, rj, rt)
        for obj_id, p in rt[i]["poses"].items():
            T_gt = cams[i] @ T_obj[obj_id]
            assert rot_err_deg(p["T_OtoC"][:3, :3], T_gt[:3, :3]) < 3.0
            assert np.linalg.norm(p["T_OtoC"][:3, 3] - T_gt[:3, 3]) < 20.0
    assert n_posed >= 10
    # BA moved the objects off their PnP poses
    dets = eng_t.detections[2]
    moved = [np.abs(dets[o].pose_pnp - rt[2]["poses"][o]["T_OtoC"]).max() for o in dets]
    assert max(moved) > 1e-3
