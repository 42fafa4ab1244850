"""Port parity for PnP: `p4p` (the plain version of kernel K3's solver) at
1e-9 in f64, and `pnp_ransac_batch` fed the hypothesis indices JAX itself
draws (`jax.random.split(key, O)` -> `_sample_hypothesis_indices`): equal
inlier sets, and T within 1e-8 in f64 (the same algorithm) and 1e-4 in f32
(rotation absolute, translation relative to its norm). The f32 bound is the
precision of the damped Gauss-Newton refine itself: its accept/reject
decisions compare f32 costs, so two correct f32 implementations that round
differently settle ~1e-5..1e-4 apart on objects at 250-500 units depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from suo_slam_tpu.solvers import p3p as jp3p
from suo_slam_tpu.solvers import pnp as jpnp
from suo_slam_tpu_torch.solvers import p3p as tp3p
from suo_slam_tpu_torch.solvers import pnp as tpnp
from tests.test_pnp_golden import POSE, XS, YS


def _scene(rng, O, N, dtype, noise=1e-3, outliers=5, valid_p=0.8):
    x = rng.uniform(-40, 40, (O, N, 3))
    y = np.zeros((O, N, 2))
    for o in range(O):
        R = Rotation.random(random_state=rng).as_matrix()
        t = np.array([rng.uniform(-50, 50), rng.uniform(-50, 50), rng.uniform(250, 500)])
        p = x[o] @ R.T + t
        y[o] = p[:, :2] / p[:, 2:] + rng.normal(scale=noise, size=(N, 2))
    y[:, :outliers] += rng.uniform(0.05, 0.2, (O, outliers, 2))
    mask = rng.uniform(size=(O, N)) < valid_p
    return x.astype(dtype), y.astype(dtype), mask


def _jax_indices(key, mask, n_hyp):
    keys = jax.random.split(key, mask.shape[0])
    return np.stack([np.asarray(jpnp._sample_hypothesis_indices(keys[o], jnp.asarray(m),
                                                                n_hyp))
                     for o, m in enumerate(mask)])


def _assert_pose_close(Tj, Tt, tol):
    np.testing.assert_allclose(Tj[..., :3, :3], Tt[..., :3, :3], atol=tol, rtol=0)
    tn = np.linalg.norm(Tj[..., :3, 3], axis=-1, keepdims=True)
    dt = np.abs(Tj[..., :3, 3] - Tt[..., :3, 3])
    np.testing.assert_array_less(dt, np.broadcast_to(tol * np.maximum(tn, 1.0), dt.shape))


@pytest.mark.parametrize("seed", [0, 1])
def test_p4p_f64(seed):
    rng = np.random.default_rng(seed)
    y4 = rng.uniform(-0.5, 0.5, (256, 4, 2))
    x4 = rng.uniform(-1, 1, (256, 4, 3))
    x4[0, 3] = x4[0, 0]  # degenerate sample: a repeated point
    Tj, ej, okj = jax.vmap(jp3p.p4p)(jnp.asarray(y4), jnp.asarray(x4))
    Tt, et, okt = tp3p.p4p(torch.from_numpy(y4), torch.from_numpy(x4))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    assert okt.numpy().mean() > 0.5
    np.testing.assert_allclose(np.asarray(Tj), Tt.numpy(), atol=1e-9, rtol=0)
    ej, et = np.asarray(ej), et.numpy()
    fin = np.isfinite(ej)
    np.testing.assert_array_equal(fin, np.isfinite(et))
    np.testing.assert_allclose(ej[fin], et[fin], atol=1e-9, rtol=1e-9)


def test_p3p_recovers_a_known_pose_f64():
    rng = np.random.default_rng(2)
    R = Rotation.random(random_state=rng).as_matrix()
    t = np.array([0.1, -0.2, 5.0])
    x = rng.uniform(-1, 1, (3, 3))
    p = x @ R.T + t
    Rs, ts, ok = tp3p.p3p(torch.from_numpy(p / p[:, 2:]), torch.from_numpy(x))
    errs = [np.abs(Rs[i].numpy() - R).max() + np.abs(ts[i].numpy() - t).max()
            for i in range(4) if ok[i]]
    assert min(errs) < 1e-9


@pytest.mark.parametrize("seed,dtype,tol", [(0, np.float32, 1e-4), (1, np.float32, 1e-4),
                                            (2, np.float32, 1e-4), (0, np.float64, 1e-8)])
def test_ransac_batch_matches_jax_with_jax_indices(seed, dtype, tol):
    rng = np.random.default_rng(seed)
    O, N, H = 8, 41, 64
    x, y, mask = _scene(rng, O, N, dtype)
    mask[O - 1, 3:] = False  # < 4 valid points: the feasibility gate
    key = jax.random.PRNGKey(seed)
    idx = _jax_indices(key, mask, H)
    rj = jpnp.pnp_ransac_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), key,
                               n_hyp=H)
    rt = tpnp.pnp_ransac_batch(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(mask), torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(rj.success), rt.success.numpy())
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    np.testing.assert_array_equal(np.asarray(rj.num_inliers), rt.num_inliers.numpy())
    assert rt.success.numpy()[: O - 1].all() and not rt.success.numpy()[O - 1]
    _assert_pose_close(np.asarray(rj.T), rt.T.numpy(), tol)


def test_hypotheses_plain_matches_jax_counts():
    """The plain K3 stage alone: every hypothesis's P4P pose, ok flag and
    inlier count against the JAX vmapped p4p + count_inliers (f64)."""
    rng = np.random.default_rng(5)
    x, y, mask = _scene(rng, 3, 41, np.float64)
    idx = _jax_indices(jax.random.PRNGKey(7), mask, 32)
    xp, _, _ = tpnp._precondition(torch.from_numpy(x), torch.from_numpy(mask))
    thr_sq = tpnp.DEFAULT_THRESHOLD ** 2
    T, ok, counts = tpnp.pnp_hypotheses(xp, torch.from_numpy(y), torch.from_numpy(mask),
                                        torch.from_numpy(idx), thr_sq)
    for o in range(3):
        xo = xp[o].numpy()
        Ts, _, okj = jax.vmap(jp3p.p4p)(jnp.asarray(y[o][idx[o]]), jnp.asarray(xo[idx[o]]))
        np.testing.assert_array_equal(np.asarray(okj), ok[o].numpy())
        np.testing.assert_allclose(np.asarray(Ts), T[o].numpy(), atol=1e-9, rtol=0)
        for h in range(32):
            err, _ = jpnp._reproj_sq_err(Ts[h], jnp.asarray(xo), jnp.asarray(y[o]))
            cnt = int(np.sum((np.asarray(err) < thr_sq) & mask[o])) if okj[h] else -1
            assert cnt == int(counts[o, h]), (o, h)


def test_golden_ten_point_fixture():
    """The reference's 10-point LambdaTwist fixture through the port."""
    mask = np.ones((1, 10), bool)
    idx = tpnp.sample_hypothesis_indices(torch.from_numpy(mask), 128,
                                         torch.Generator().manual_seed(0))
    res = tpnp.pnp_ransac_batch(torch.from_numpy(XS[None]), torch.from_numpy(YS[None]),
                                torch.from_numpy(mask), idx)
    assert bool(res.success[0]) and int(res.num_inliers[0]) == 10
    T = res.T[0].numpy()
    ang = np.degrees(np.arccos(np.clip((np.trace(T[:3, :3].T @ POSE[:3, :3]) - 1) / 2,
                                       -1, 1)))
    assert ang < 0.5, ang
    np.testing.assert_allclose(T[:3, 3], POSE[:3, 3], atol=0.02)


def test_sampler_contract():
    """Distinct valid indices while >= 4 points are valid; index-0 rows when
    exhausted (the JAX sampler's documented contract)."""
    mask = np.zeros((2, 12), bool)
    mask[0, [1, 4, 5, 8, 11]] = True
    mask[1, [2, 7]] = True
    idx = tpnp.sample_hypothesis_indices(torch.from_numpy(mask), 50,
                                         torch.Generator().manual_seed(1)).numpy()
    assert idx.shape == (2, 50, 4)
    assert all(len(set(r)) == 4 and mask[0, r].all() for r in idx[0])
    assert (idx[1, :, 2:] == 0).all() and mask[1, idx[1, :, :2]].all()
