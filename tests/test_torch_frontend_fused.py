"""The fused front end and tail on the CPU: the plain twins of K6's
camera-RANSAC and re-init modes (`slam/kernels.py` `camera_ransac_plain`,
`reinit_votes_plain`), K15's draws mode (`pnp.Draws`: the sampler's
`torch.rand` ranked inside the PnP) and the front end's freedom from hidden
host syncs.

- camera RANSAC over a group's compact rows read through their map slots:
  equal to the [O] scatter + `camera_pose_ransac` (pose, count, ok
  exactly) and to the earlier chain's counts (the best slot their first
  maximum, its hypothesis the pose), and to JAX's
  `camera_pose_ransac` on the scattered rows (count and ok exactly, pose
  within 1e-5), over seeds, a padded group, a tie (the first maximum in slot
  order, not group-row order), a row with no inlier, no candidate and an
  unmet `min_num_inliers`; large maps take fewer hypotheses a round (a
  128-slot map, one a round), past one a round the wrapper raises;
- the re-init vote over the views cs of the engine's mirrors: counts equal
  to JAX's `reinit_counts` on the gathered views, invalid cameras included;
- draws: `pnp_ransac_batch` on `Draws` equals the plain PnP on
  `hypothesis_indices_plain`'s indices of the same draws exactly, at the
  front end's [8, 64, 41] (a row with 2 valid points) and the backup pose's
  [1, 128, 8]; a SLAM run with the default sampler equals, bit for bit, one
  whose sampler ranks the same generator's draws into indices;
- no host sync inside the front end's camera-RANSAC branch or the tracking
  tail with the symmetric group and the re-init vote: a `TorchDispatchMode`
  that fails on `aten._local_scalar_dense` (`.item()`, `bool()`, a 0-d
  tensor index), on boolean-mask indexing (a `nonzero`) and on tensors made
  of host data (`aten.lift_fresh`: `torch.tensor`, a Python scalar
  assigned into a tensor), which sync on the card. Only `ba.optimize` may read the host: on CPU tensors it is the
  eager schedule, which leaves its loop by a host read; on the card it is
  one K14 launch (chip_smoke runs both chains under
  `torch.cuda.set_sync_debug_mode("error")`).

The JAX oracles are computed once per module (module-scoped fixtures).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from suo_slam_tpu.slam import kernels as jk
from suo_slam_tpu_torch.slam import kernels as tk
from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig, TorchGumbelSampler
from suo_slam_tpu_torch.solvers import ba
from suo_slam_tpu_torch.solvers import pnp
from tests.helpers.synthetic_scene import StubMeshDb, make_scene, project_frame
from tests.test_torch_slam import GtInfer
from tests.test_torch_slam_kernels import K, O, Scene, _front_inputs, _info, _ransac_inputs, \
    _tail_inputs

CASES = ("seed0", "seed1", "seed2", "padded", "tie", "no inlier", "no candidate", "unmet")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _camera_case(case):
    """A group's compact rows, their slots and the map (`camera_ransac`'s
    arguments as numpy) and min_num_inliers. The dense [O] rows of
    `_ransac_inputs` (slot 5's PnP failed, slot 6 inactive, slot 3 without
    inliers) go to a shuffled group; "padded" leaves slots 4 and 7 without a
    row and pads the group with 2 rows of slot O; "tie" gives slots 1 and 2
    one exact pose (the best) with slot 2's row first; "no inlier" takes the
    best slot's inliers away."""
    seed = int(case[-1]) if case.startswith("seed") else 0
    T_pnp, pnp_ok, T_map, obj_ok, model_kp, uv, info, inl, k4 = _ransac_inputs(seed)
    rng = np.random.default_rng(seed + 40)
    slots = rng.permutation(O)
    min_inl = 4
    if case == "tie":
        sc = Scene(seed)
        for j in (1, 2):
            T_map[j] = sc.T_obj[1]
            T_pnp[j] = sc.cams[1] @ sc.T_obj[1]
        T_pnp[0, :3, 3] += 0.05
        slots = np.array([2, 1] + [s for s in slots if s not in (1, 2)])
    elif case == "padded":
        slots = np.array([s for s in slots if s not in (4, 7)] + [O, O])
    elif case == "no inlier":
        inl[0] = False
    elif case == "no candidate":
        pnp_ok[:] = False
    elif case == "unmet":
        min_inl = 10_000
    src = np.where(slots < O, slots, 0)
    rows = [a[src].copy() for a in (T_pnp, pnp_ok, uv, info, inl, k4)]
    return (*rows, slots.astype(np.int64), T_map, obj_ok, model_kp), min_inl


def _scattered(args):
    """The earlier chain: the rows scattered into slot-indexed [O] rows
    (identity / False / zeros where a slot has none)."""
    T_pnp, pnp_ok, uv, info, keep, k4, slots, T_map, active, model_kp = args
    row = {int(s): i for i, s in enumerate(slots) if s < O}
    pick = lambda a, fill: np.stack([a[row[j]] if j in row else fill for j in range(O)])
    ok_row = pick(pnp_ok, False)
    return (pick(T_pnp, np.eye(4, dtype=np.float32)), ok_row, T_map, active & ok_row, model_kp,
            pick(uv, np.zeros((K, 2), np.float32)), pick(info, np.zeros((K, 2, 2), np.float32)),
            pick(keep, np.zeros(K, bool)), pick(k4, np.zeros(4, np.float32)))


@pytest.fixture(scope="module")
def camera_oracles():
    """case -> (args, min_inl, JAX's (T, count, ok) on the scattered rows)."""
    out = {}
    for case in CASES:
        args, mi = _camera_case(case)
        Tj, cj, okj = jk.camera_pose_ransac(*[jnp.asarray(a) for a in _scattered(args)],
                                            min_num_inliers=mi)
        out[case] = args, mi, (np.asarray(Tj), int(cj), bool(okj))
    return out


@pytest.mark.parametrize("case", CASES)
def test_camera_ransac_twin_equals_scatter_and_jax(camera_oracles, case):
    args, mi, (Tj, cj, okj) = camera_oracles[case]
    T, count, ok, best = tk.camera_ransac(*[_t(a) for a in args], mi)  # CPU: the twin
    assert count.dtype == torch.int32 and ok.dtype == torch.bool and best.dtype == torch.int64
    Te, ce, oke = tk.camera_pose_ransac(*[_t(a) for a in _scattered(args)], min_num_inliers=mi)
    assert torch.equal(T, Te) and torch.equal(count, ce) and torch.equal(ok, oke)
    assert int(count) == cj and bool(ok) == okj
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-5, rtol=1e-5)
    # the best slot: its hypothesis T_row[best] inv(T_map[best]) is the pose,
    # the first maximum of the earlier chain's counts
    T_row = _t(_scattered(args)[0])
    T_hyp = tk.compose_plain(T_row, tk.invert_se3_plain(_t(args[7])))
    b = int(best)
    counts = _hyp_counts(args)
    assert int(count) == counts.max() and b == counts.argmax()
    if bool(ok):
        assert torch.equal(T, T_hyp[b])
    else:
        assert torch.equal(T, torch.eye(4))
    if case == "tie":
        assert b == 1 and bool(ok) and torch.equal(T_hyp[1], T_hyp[2])
        counts = _hyp_counts(args)
        assert counts[1] == counts[2] == counts.max() and counts.argmax() == 1
    if case == "no candidate":
        assert (b, int(count), bool(ok)) == (0, -1, False)
    if case == "unmet":
        assert not bool(ok) and int(count) > 0
    if case.startswith("seed") or case == "padded":
        assert bool(ok) and int(count) >= 24  # the best of 12-keypoint objects


def _hyp_counts(args):
    """Each hypothesis's count on the scattered rows (-1: no candidate)."""
    T_row, ok_row, T_map, cand, model_kp, uv, info, keep, k4 = [_t(a) for a in _scattered(args)]
    T_hyp = tk.compose_plain(T_row, tk.invert_se3_plain(T_map))
    c = tk.chi2_counts_plain(tk.compose_plain(T_hyp[:, None], T_map[None]), model_kp, uv[None],
                             info[None], (keep & cand[:, None])[None], k4[None])
    return torch.where(cand, c, -1).numpy()


def _reinit_case():
    """The re-init vote over n = 16 view slots of V = 20 mirror rows: 15
    views of a scene (12 valid cameras) in a shuffled order, 3 objects'
    map poses and one PnP pose off by 0.3 units."""
    sc = Scene(3, n_views=15)
    rng = np.random.default_rng(4)
    V, n = 20, 16
    cs = rng.choice(V, n, replace=False)
    T_pnp, T_est = sc.T_obj.copy(), sc.T_obj.copy()
    T_est[:3, :3, 3] += 0.3
    T_pnp[5, :3, 3] += 0.3
    cams = np.concatenate([sc.cams, sc.cams[:1]])
    cam_valid = np.ones(n, bool)
    cam_valid[[4, 12, 15]] = False
    uv_m = np.zeros((V, O, K, 2), np.float32)
    uv_m[cs] = np.concatenate([sc.uv, sc.uv[:1]])
    valid_m = np.zeros((V, O, K), bool)
    valid_m[cs] = np.broadcast_to(sc.mask, (n, O, K)) & (rng.uniform(size=(n, O, K)) < 0.85)
    k4_m = np.broadcast_to(np.array([3.0, 3.0, 0.0, 0.0], np.float32), (V, O, 4)).copy()
    f = lambda a: a.astype(np.float32)
    return (f(T_pnp), f(T_est), f(cams), cam_valid, sc.model_kp, uv_m, _info((V, O, K)),
            valid_m, k4_m, cs.astype(np.int64))


@pytest.fixture(scope="module")
def reinit_oracle():
    a = _reinit_case()
    cs = a[9]
    pj, ej = jk.reinit_counts(*[jnp.asarray(x) for x in
                                (a[0], a[1], a[2], a[3], a[4], a[5][cs], a[6][cs], a[7][cs],
                                 a[8][cs])])
    return a, (np.asarray(pj), np.asarray(ej))


def test_reinit_votes_twin_equals_jax(reinit_oracle):
    args, (pj, ej) = reinit_oracle
    pt, et = tk.reinit_votes(*[_t(a) for a in args])  # CPU: the twin
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(et.numpy(), ej)
    assert (et.numpy()[:3] < pt.numpy()[:3]).all() and et[5] > pt[5]
    # an invalid view counts nothing: all invalid, no counts
    none = list(args)
    none[3] = np.zeros_like(args[3])
    p0, e0 = tk.reinit_votes(*[_t(a) for a in none])
    assert int(p0.sum()) == int(e0.sum()) == 0


def _pnp_case(shape):
    import chip_smoke as cs

    rng = np.random.default_rng(11)
    if shape == "backup":
        return cs.backup_inputs("cpu", rng, draws=True)
    x, y, mask, d = cs.pnp_inputs("cpu", rng, draws=True)
    mask[1] = False
    mask[1, [5, 17]] = True  # a row of 2 valid points: exhausted picks
    return x, y, mask, d


@pytest.mark.parametrize("shape", ["front end", "backup"])
def test_draws_equal_the_plain_ranking_then_the_plain_pnp(shape):
    x, y, mask, d = _pnp_case(shape)
    idx = pnp.hypothesis_indices_plain(d.u, mask)
    if shape == "front end":
        assert d.u.shape == (8, 64, 41) and (idx[1, :, 2:] == 0).all()
    else:
        assert d.u.shape == (1, 128, 8)
    r = pnp.pnp_ransac_batch(x, y, mask, d)
    p = pnp.pnp_ransac_batch_plain(x, y, mask, idx)
    for a, b in zip(r, p):
        assert torch.equal(a, b)
    assert bool(r.success[0]) and (shape == "backup" or not bool(r.success[1]))
    one = pnp.pnp_ransac(x[0], y[0], mask[0], pnp.Draws(d.u[0]))
    assert torch.equal(one.T, r.T[0]) and torch.equal(one.inliers, r.inliers[0])


class _RankingSampler(TorchGumbelSampler):
    """The default sampler's draws on the same generator, ranked into
    indices here (what an injected index sampler hands the engine)."""

    def __call__(self, mask, n_hyp):
        return pnp.hypothesis_indices_plain(super().__call__(mask, n_hyp).u, mask)

    def single(self, mask, n_hyp):
        return pnp.hypothesis_indices_plain(super().single(mask, n_hyp).u[None], mask[None])[0]


@pytest.mark.parametrize("symmetric", [(2, 4), (1, 2, 3, 4, 5)])
def test_slam_run_with_draws_equals_one_with_ranked_indices(symmetric):
    """A short SLAM run (camera RANSAC, re-init, the symmetric group; with
    every object symmetric, the backup camera pose) with the default
    sampler equals, bit for bit, the run whose sampler ranks the same draws
    into indices."""
    scene = make_scene(n_obj=5, n_views=4, seed=0)
    K_, hw, kp, T_obj, cams = scene
    img = np.zeros(hw + (3,), np.float32)
    runs = []
    for sampler in (None, lambda seed: _RankingSampler(seed, torch.device("cpu"))):
        inf = GtInfer(torch.from_numpy)
        eng = ObjectSlam(SlamConfig(global_opt_every=3), mesh_db=StubMeshDb(8, symmetric=symmetric),
                         infer_fn=inf, hyp_sampler=sampler, device="cpu")
        for i, T in enumerate(cams):
            obj_ids, bboxes, mks, mms, kms, uvs = project_frame(K_, hw, kp, T_obj, T)
            inf.set_frame(bboxes, uvs)
            eng.process_view(i, img, K_, obj_ids, bboxes, mks, mms, kms)
        runs.append((eng, eng.collect_results(final=True)))
    (ea, ra), (eb, rb) = runs
    for name in ("cam_T", "obj_T", "inliers", "valid", "cam_active", "obj_active"):
        np.testing.assert_array_equal(getattr(ea, name), getattr(eb, name), err_msg=name)
    n = 0
    for view in ra:
        for obj_id, p in ra[view]["poses"].items():
            q = rb[view]["poses"][obj_id]["T_OtoC"]
            assert (p["T_OtoC"] is None) == (q is None)
            if q is not None:
                np.testing.assert_array_equal(p["T_OtoC"], q)
                n += 1
    assert n >= 10


class NoHostSync(TorchDispatchMode):
    """Fails on an operation that reads a value to the host
    (`_local_scalar_dense`), indexes by a boolean mask (a `nonzero`) or
    makes a tensor of host data (`lift_fresh`: `torch.tensor`, a Python
    scalar assigned into a tensor; on the card a blocking upload): each
    synchronizes on the card. `allow` lifts the check (ba.optimize's eager
    CPU schedule)."""

    INDEXING = ("aten::index.Tensor", "aten::index_put", "aten::index_put_",
                "aten::_index_put_impl_")

    def __init__(self):
        super().__init__()
        self.allow = False
        self.seen = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        self.seen += 1
        if not self.allow:
            if name in ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select"):
                raise AssertionError(f"host sync: {name}")
            if name == "aten::lift_fresh":  # a constant made on the host: a blocking upload
                raise AssertionError(f"host-made tensor: {name}")
            if name in self.INDEXING and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                             for i in (args[1] or ())):
                raise AssertionError(f"boolean-mask indexing: {name}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_sync(monkeypatch):
    mode = NoHostSync()
    optimize = ba.optimize

    def eager_optimize(*a, **kw):  # the CPU's eager BA reads the host by design
        mode.allow = True
        try:
            return optimize(*a, **kw)
        finally:
            mode.allow = False

    monkeypatch.setattr(ba, "optimize", eager_optimize)
    return mode


def test_sync_detector_catches_a_zero_dim_index(no_host_sync):
    """The earlier camera-RANSAC selection, `counts[best]` with a 0-d
    `best`, reads the host: the detector fails on it (and on a mask index)."""
    counts = torch.tensor([3, 7, 7, -1], dtype=torch.int32)
    with pytest.raises(AssertionError, match="host sync"), no_host_sync:
        counts[torch.argmax(counts)]
    with pytest.raises(AssertionError, match="boolean-mask"), no_host_sync:
        counts[counts > 3]
    with pytest.raises(AssertionError, match="host-made"), no_host_sync:
        counts[0] = 1  # the earlier `lie.make_T` set its last row so


def test_frontend_camera_ransac_branch_reads_no_host_value(no_host_sync):
    sc, (uv, cov, mp, mk, mm, k4, diams), slots, T_map, obj_active = _front_inputs(0)
    gen = TorchGumbelSampler(3, torch.device("cpu"))
    args = [_t(a) for a in (uv, cov, mp, mk, mm, k4, diams)]
    kw = dict(slots=_t(slots), obj_T=_t(T_map), obj_active=_t(obj_active),
              model_kp_full=_t(sc.model_kp))
    with no_host_sync:
        out = tk.frontend_step(*args, gen, 0.005, 0.9, 0.2, 0.3, n_hyp=64, **kw)
    assert no_host_sync.seen > 100
    assert bool(out["cam_ok"]) and out["T_cam"].shape == (4, 4)


def test_tracking_tail_reads_no_host_value_but_in_the_ba(no_host_sync):
    base, v, sym, reinit = _tail_inputs(0, True, True)
    tt = lambda d: {k: _t(a) for k, a in d.items()}
    names = ("uv_m", "info_m", "valid_m", "inliers_m", "cam_k4_m", "model_kp_m")
    args = ([_t(base[n].copy()) for n in names] + [v]
            + [_t(base[n]) for n in ("cam_T_v", "obj_T", "obj_active")] + [tt(sym), tt(reinit)])
    with no_host_sync:
        _, out = tk.tracking_tail(*args, 1.0, False)
    assert bool(out["reinit_cond"][1]) and bool(out["late"][7]) and bool(out["did_opt"])


def test_k6_constants_and_shared_memory_mirror_the_source():
    """The wrappers' block sizes and re-init chunk are the source's; the
    SLAM path's shapes need no shared-memory opt-in, and a T-LESS-sized map
    (O = 32, a group of 32 rows) fits one block with a full round of
    hypotheses."""
    import re
    from pathlib import Path

    src = (Path(tk.__file__).parents[1] / "csrc" / "chi2_counts.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kThreads"], c["kCamThreads"], c["kCamHyps"], c["kReinitThreads"],
            c["kReinitChunk"]) == (tk.K6_THREADS, tk.K6_CAM_THREADS, tk.K6_CAM_HYPS,
                                   tk.K6_REINIT_THREADS, tk.K6_REINIT_CHUNK)
    assert tk.camera_ransac_smem(8, 8, K) <= 48 * 1024 and tk.reinit_smem(K) <= 48 * 1024
    assert tk.camera_ransac_smem(32, 32, K) <= pnp.SMEM_PER_BLOCK
    assert tk.camera_ransac_hyps(32, 32, K) == tk.K6_CAM_HYPS
    assert tk.camera_ransac_hyps(8, 8, K) == 8  # at most a round of O


@pytest.mark.parametrize("O, ob, hr", [(64, 64, 16), (128, 32, 16), (128, 64, 12), (128, 128, 1),
                                       (256, 32, 2), (256, 64, 0), (512, 4, 0)])
def test_camera_ransac_rounds_shrink_to_fit_large_maps(O, ob, hr):
    """Large maps (the engine doubles its object capacity) take fewer
    hypotheses a round, the most whose shared memory fits a block (41
    keypoints); past one a round the wrapper raises naming the bytes."""
    assert tk.camera_ransac_hyps(O, ob, K) == hr
    if hr:
        assert tk.camera_ransac_smem(O, ob, K, hr) <= pnp.SMEM_PER_BLOCK
        assert hr == min(O, tk.K6_CAM_HYPS) or (
            tk.camera_ransac_smem(O, ob, K, hr + 1) > pnp.SMEM_PER_BLOCK)
        return
    f = lambda *shape: torch.zeros(shape)
    args = (f(ob, 4, 4), torch.zeros(ob, dtype=torch.bool), f(ob, K, 2), f(ob, K, 2, 2),
            torch.zeros(ob, K, dtype=torch.bool), f(ob, 4), torch.arange(ob), f(O, 4, 4),
            torch.zeros(O, dtype=torch.bool), f(O, K, 3))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tk._camera_ransac_cuda(*args)


def test_camera_pose_ransac_is_the_fused_twin_on_a_large_map():
    """`camera_pose_ransac` (JAX's signature, row j in slot j) and the fused
    twin on a 128-slot map (chip_smoke's "map 128" case: 16 copies of the
    SLAM objects in a shuffled group) give the earlier chain's selection."""
    import chip_smoke as cs

    objs = cs.Objects(np.random.default_rng(0))
    args, mi = cs.camera_ransac_inputs("cpu", np.random.default_rng(7), objs, "map 128")
    T, count, ok, best = tk.camera_ransac(*args, mi)
    T_pnp, pnp_ok, uv, info, keep, k4, slots, obj_T, active, model_kp = args
    O = obj_T.shape[0]
    assert (O, slots.shape[0]) == (128, 128) and bool(ok)
    order = torch.argsort(slots)  # every slot has a row: the rows in slot order
    j = tk.camera_pose_ransac(T_pnp[order], pnp_ok[order], obj_T, active & pnp_ok[order],
                              model_kp, uv[order], info[order], keep[order], k4[order], mi)
    assert torch.equal(j[0], T) and torch.equal(j[1], count) and torch.equal(j[2], ok)
    cand = pnp_ok[order] & active
    T_hyp = tk.compose_plain(T_pnp[order], tk.invert_se3_plain(obj_T))
    c = tk.chi2_counts_plain(tk.compose_plain(T_hyp[:, None], obj_T[None]), model_kp,
                             uv[order][None], info[order][None],
                             (keep[order] & cand[:, None])[None], k4[order][None])
    c = torch.where(cand, c, -1)
    assert int(count) == int(c.max()) and int(best) == int(torch.argmax(c))
    assert torch.equal(T, T_hyp[int(best)])


def test_k6_wrappers_refuse_what_the_kernels_do_not_take():
    args, mi = _camera_case("seed0")
    t = [_t(a) for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        tk._camera_ransac_cuda(*t, mi)
    with pytest.raises(ValueError, match="shapes"):
        tk._camera_ransac_cuda(*t[:2], t[2][:, :5], *t[3:], mi)
    with pytest.raises(ValueError, match="f32"):
        tk._camera_ransac_cuda(t[0].double(), *t[1:], mi)
    r = [_t(a) for a in _reinit_case()]
    with pytest.raises(ValueError, match="CUDA device"):
        tk._reinit_votes_cuda(*r)
    with pytest.raises(ValueError, match="shapes"):
        tk._reinit_votes_cuda(*r[:2], r[2][:3], *r[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        tk.camera_ransac(*[a.to("meta") for a in t], mi)
