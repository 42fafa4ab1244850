"""PnP RANSAC as kernel K15 runs it: `pnp_ransac_batch_plain` (K15's plain
version) against the JAX `pnp_ransac` on the cases a front end meets, the
device dispatch of `pnp_ransac_batch`, and the CUDA sources' shared pieces.

The JAX side runs its own jitted `pnp_ransac` (vmapped, as
`pnp_ransac_batch`) with its hypothesis sampler replaced by the very indices
the port is given: JAX's own draws (`_sample_hypothesis_indices` under
`jax.random.split(key, O)`) except where a case needs chosen ones. f32 at the
engine's shapes (O = 8, N = 41, n_hyp = 64): success, inlier masks and counts
equal, poses within 1e-4 (rotation absolute, translation relative to its
norm), the f32 precision of the damped Gauss-Newton refine
(tests/test_torch_pnp.py). The kernel itself is held to this plain version on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from suo_slam_tpu.solvers import pnp as jpnp
from suo_slam_tpu_torch import kernels
from suo_slam_tpu_torch.solvers import p3p as tp3p
from suo_slam_tpu_torch.solvers import pnp as tpnp
from tests.test_torch_pnp import _assert_pose_close, _jax_indices

CSRC = Path(__file__).resolve().parents[1] / "suo_slam_tpu_torch" / "csrc"
O, N, H = 8, 41, 64
GATE = 5        # the object whose refinement the keep gate rejects
BEHIND = (6, 20)  # a valid point behind the camera


def _project(x, R, t):
    p = x @ R.T + t
    return p[:, :2] / p[:, 2:]


def _scene():
    """Eight objects: 0-2 ordinary (5 gross outliers each), 3 exactly 4
    valid points, 4 every point at one place (every hypothesis fails), 5 the
    keep gate (4 exact points on a tetrahedron, every hypothesis theirs, and
    23 more biased by 0.95 of the threshold in u, 3 of them the other way:
    the least-squares fit over all 27 pushes those 3 out), 6 one valid
    point behind the camera, 7 three valid points."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-40, 40, (O, N, 3))
    y = np.zeros((O, N, 2))
    for o in range(O):
        R = Rotation.random(random_state=rng).as_matrix()
        t = np.array([rng.uniform(-50, 50), rng.uniform(-50, 50), rng.uniform(250, 500)])
        if o == BEHIND[0]:
            x[o, BEHIND[1]] = (np.array([0.0, 0.0, -100.0]) - t) @ R
        y[o] = _project(x[o], R, t) + rng.normal(scale=2e-4, size=(N, 2))
    y[:, :5] += rng.uniform(0.05, 0.2, (O, 5, 2))
    mask = rng.uniform(size=(O, N)) < 0.8
    mask[3] = False
    mask[3, 10:14] = True
    x[4] = x[4, :1]
    mask[7] = False
    mask[7, 10:13] = True
    mask[BEHIND] = True
    R = Rotation.random(random_state=rng).as_matrix()
    x[GATE] = rng.uniform(-40, 40, (N, 3))
    x[GATE, :4] = [[40, 40, 40], [-40, -40, 40], [40, -40, -40], [-40, 40, -40]]
    y[GATE] = _project(x[GATE], R, np.array([10.0, -20.0, 400.0]))
    y[GATE, 4:24, 0] += 0.95e-3
    y[GATE, 24:27, 0] -= 0.95e-3
    mask[GATE] = False
    mask[GATE, :27] = True
    idx = _jax_indices(jax.random.PRNGKey(21), mask, H)
    idx[GATE] = np.arange(4)  # every hypothesis the 4 exact points
    return x.astype(np.float32), y.astype(np.float32), mask, idx


def _jax_ransac(x, y, mask, idx, refine):
    """The jitted JAX `pnp_ransac`, vmapped over objects, each object's
    sampler returning its rows of idx."""
    body = jpnp.pnp_ransac.__wrapped__
    f = jax.jit(jax.vmap(lambda xi, yi, mi, ii: body(xi, yi, mi, ii, n_hyp=H, refine=refine)))
    with mock.patch.object(jpnp, "_sample_hypothesis_indices", lambda key, m, n: key):
        r = f(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(idx))
    return jax.tree_util.tree_map(np.asarray, r)


@pytest.fixture(scope="module")
def runs():
    x, y, mask, idx = _scene()
    args = [torch.from_numpy(a) for a in (x, y, mask, idx)]
    out = {}
    for refine in (True, False):
        out[refine] = (_jax_ransac(x, y, mask, idx, refine),
                       tpnp.pnp_ransac_batch_plain(*args, refine=refine))
    return (x, y, mask, idx), out


@pytest.mark.parametrize("refine", [True, False])
def test_plain_matches_jax_on_every_case(runs, refine):
    _, out = runs
    rj, rt = out[refine]
    np.testing.assert_array_equal(rj.success, rt.success.numpy())
    np.testing.assert_array_equal(rj.inliers, rt.inliers.numpy())
    np.testing.assert_array_equal(rj.num_inliers, rt.num_inliers.numpy())
    _assert_pose_close(rj.T, rt.T.numpy(), 1e-4)
    assert rt.success.tolist() == [True, True, True, True, False, True, True, False]
    assert rt.T.dtype == torch.float32 and rt.num_inliers.dtype == torch.int64


def test_exactly_four_valid_points(runs):
    (_, _, mask, _), out = runs
    rj, rt = out[True]
    assert mask[3].sum() == 4 and bool(rt.success[3]) and int(rt.num_inliers[3]) == 4
    assert mask[7].sum() == 3 and not rt.success[7] and int(rt.num_inliers[7]) == 0
    assert torch.equal(rt.T[7], torch.eye(4)) and not rt.inliers[7].any()


def test_every_hypothesis_fails(runs):
    (x, y, mask, idx), out = runs
    xp, _, _ = tpnp._precondition(torch.from_numpy(x), torch.from_numpy(mask))
    _, ok, counts = tpnp.pnp_hypotheses_plain(xp, torch.from_numpy(y), torch.from_numpy(mask),
                                              torch.from_numpy(idx), tpnp.DEFAULT_THRESHOLD ** 2)
    assert not ok[4].any() and (counts[4] == -1).all() and ok[0].any()
    rj, rt = out[True]
    assert not rj.success[4] and not rt.success[4] and torch.equal(rt.T[4], torch.eye(4))


def test_keep_gate_rejects_a_refine_that_loses_inliers(runs):
    (x, y, mask, idx), out = runs
    (rj, rt), (rj0, rt0) = out[True], out[False]
    # the refined pose would lose the 3 points biased the other way ...
    xt, yt, mt = (torch.from_numpy(a) for a in (x, y, mask))
    xp, _, _ = tpnp._precondition(xt, mt)
    Ts, _, counts = tpnp.pnp_hypotheses_plain(xp, yt, mt, torch.from_numpy(idx),
                                              tpnp.DEFAULT_THRESHOLD ** 2)
    T = Ts[GATE, :1]
    for _ in range(2):
        err, _ = tpnp._reproj_sq_err(T, xp[GATE:GATE + 1], yt[GATE:GATE + 1])
        w = ((err < tpnp.DEFAULT_THRESHOLD ** 2) & mt[GATE:GATE + 1]).float()
        T = tpnp._gn_refine(T, xp[GATE:GATE + 1], yt[GATE:GATE + 1], w)
    err, _ = tpnp._reproj_sq_err(T, xp[GATE:GATE + 1], yt[GATE:GATE + 1])
    assert int(((err < tpnp.DEFAULT_THRESHOLD ** 2) & mt[GATE]).sum()) < int(counts[GATE, 0]) == 27
    # ... so both keep the hypothesis's pose, while refining moves the others
    assert torch.equal(rt.T[GATE], rt0.T[GATE]) and np.array_equal(rj.T[GATE], rj0.T[GATE])
    assert int(rt.num_inliers[GATE]) == 27
    assert not torch.equal(rt.T[0], rt0.T[0])


def test_point_behind_the_camera(runs):
    _, out = runs
    rj, rt = out[True]
    assert bool(rt.success[BEHIND[0]]) and not rt.inliers[BEHIND] and not rj.inliers[BEHIND]


def test_single_set_at_the_backup_pose_shape():
    """`pnp_ransac` of one point set as the engine's backup camera pose calls
    it: 8 object centres, their bbox centroids, 128 hypotheses from one key."""
    rng = np.random.default_rng(5)
    R = Rotation.random(random_state=rng).as_matrix()
    t = np.array([30.0, -40.0, 1000.0])
    x = np.concatenate([rng.uniform(-300, 300, (8, 2)), rng.uniform(-100, 100, (8, 1))], -1)
    y = _project(x, R, t) + rng.normal(scale=2e-4, size=(8, 2))
    y[6] += 0.05  # one centroid far off
    x, y = x.astype(np.float32), y.astype(np.float32)
    mask = np.ones(8, bool)
    key = jax.random.PRNGKey(3)
    rj = jpnp.pnp_ransac(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), key)
    idx = np.asarray(jpnp._sample_hypothesis_indices(key, jnp.asarray(mask),
                                                     tpnp.DEFAULT_HYPOTHESES))
    rt = tpnp.pnp_ransac(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
                         torch.from_numpy(idx))
    assert bool(rj.success) and bool(rt.success) and rt.T.shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert int(rj.num_inliers) == int(rt.num_inliers) == 7
    _assert_pose_close(np.asarray(rj.T), rt.T.numpy(), 1e-4)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(runs):
    (x, y, mask, idx), out = runs
    kernels.reset_counts()
    r = tpnp.pnp_ransac_batch(*(torch.from_numpy(a) for a in (x, y, mask, idx)))
    assert not any(kernels.counts().values())
    for a, b in zip(r, out[True][1]):
        assert torch.equal(a, b)


def test_other_devices_and_inputs_k15_does_not_take_raise():
    x, y = torch.zeros(2, 9, 3), torch.zeros(2, 9, 2)
    mask, idx = torch.ones(2, 9, dtype=torch.bool), torch.zeros(2, 4, 4, dtype=torch.int64)
    meta = [a.to("meta") for a in (x, y, mask, idx)]
    with pytest.raises(ValueError, match="unsupported device"):
        tpnp.pnp_ransac_batch(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tpnp.pnp_ransac(*(a[0] for a in meta))
    # the wrapper's checks come before any build or launch
    with pytest.raises(ValueError, match="f32"):
        tpnp._pnp_ransac_cuda(x.double(), y.double(), mask, idx)
    big = tpnp.K15_MAX_POINTS + 1
    with pytest.raises(ValueError, match="at most"):
        tpnp._pnp_ransac_cuda(torch.zeros(1, big, 3), torch.zeros(1, big, 2),
                              torch.ones(1, big, dtype=torch.bool), idx[:1])
    with pytest.raises(ValueError, match="CUDA device"):
        tpnp._pnp_ransac_cuda(x, y, mask, idx)
    with pytest.raises(ValueError, match="shapes"):
        tpnp._pnp_ransac_cuda(x, y, mask, idx[:, :0])


def _functions(src):
    return set(re.findall(r"__device__\s+(?:__forceinline__\s+|inline\s+)?\w+\s+(\w+)\(", src))


def test_k3_and_k15_share_one_hypothesis_body():
    """K3 and K15 compile the same P3P / P4P / count code: the device
    functions live in `pnp_common.cuh` alone, K3 and K15 include it and call
    its parts of a hypothesis (K3 `solve_pose` and `count_inliers`; K15 the
    candidates one by one and the per-point `is_inlier`); `exp_compose`
    lives in `ba_common.cuh` alone, shared by K14 and K15 (K15 in its fused
    form); the trip counts and constants mirror Python's."""
    common = (CSRC / "pnp_common.cuh").read_text()
    k3 = (CSRC / "pnp_hypotheses.cu").read_text()
    k15 = (CSRC / "pnp_ransac.cu").read_text()
    ba_common = (CSRC / "ba_common.cuh").read_text()
    k14 = (CSRC / "ba_lm.cu").read_text()
    shared = {"nz", "clamp0", "dot3", "cross3", "root2real", "cubick", "residuals",
              "refine_L", "eigvec", "fourth_point_err", "p3p_prefix", "p3p_candidate", "p4p",
              "gather_rows", "solve_pose", "is_inlier", "count_inliers"}
    assert shared <= _functions(common)
    assert not shared & (_functions(k3) | _functions(k15))
    assert '#include "pnp_common.cuh"' in k3 and '#include "pnp_common.cuh"' in k15
    assert "suo_pnp::solve_pose(" in k3 and "suo_pnp::count_inliers(" in k3
    # K15's current design splits P3P's candidates over lanes; its serial design calls p4p
    for call in ("gather_rows(", "p3p_prefix(", "p3p_candidate(", "is_inlier(", "solve_pose("):
        assert f"suo_pnp::{call}" in k15
    assert "exp_compose" in _functions(ba_common)
    assert "exp_compose" not in _functions(k14) | _functions(k15)
    assert '#include "ba_common.cuh"' in k15 and "suo_ba::exp_compose<true>(" in k15
    consts = dict(re.findall(r"constexpr (?:int|float) (k\w+) = ([\w.\-+]+?)f?;", common + k15))
    assert int(consts["kCubicIters"]) == tp3p.CUBIC_ITERS
    assert int(consts["kRefineIters"]) == tp3p.REFINE_ITERS
    assert int(consts["kGnIters"]) == tpnp.REFINE_GN_ITERS
    assert float(consts["kLambda0"]) == 1e-4 and float(consts["kTiny"]) == tp3p.TINY
    # the wrapper's point limit is what the kernel's 64-bit lane masks hold
    assert tpnp.K15_MAX_POINTS == 64 * 32
