"""The port's evaluation meter (`suo_slam_tpu_torch/eval/meter.py`) against
the JAX package's on the CPU: the ADD / ADD-S distances (the plain version of
kernel K10 against `_add_dists_kernel`) on the same numpy-seeded padded point
clouds and poses, then the AUC meters and their printed table.

Tolerance: the per-object means within 1e-5 relative (f32 transforms and
distances whose sums run in another order); AUCs within 1e-6 and the printed
table equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.eval import meter as jmeter
from suo_slam_tpu_torch.eval import meter as tmeter


def _rot(rng, scale):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _poses(rng, B, noise):
    Tg = np.tile(np.eye(4), (B, 1, 1))
    Tp = Tg.copy()
    for b in range(B):
        Tg[b, :3, :3] = _rot(rng, 1.0)
        Tg[b, :3, 3] = rng.uniform(-100, 100, 3) + [0, 0, 800]
        Tp[b, :3, :3] = _rot(rng, noise) @ Tg[b, :3, :3]
        Tp[b, :3, 3] = Tg[b, :3, 3] + rng.normal(size=3) * 200 * noise
    return Tp.astype(np.float32), Tg.astype(np.float32)


@pytest.mark.parametrize("P", [7, 100, 512])
def test_add_dists_plain_matches_jax(P):
    rng = np.random.default_rng(P)
    B = 5
    pts = rng.uniform(-60, 60, (B, P, 3)).astype(np.float32)
    n = rng.integers(1, P + 1, B).astype(np.int32)
    n[0], n[1] = P, 0  # one full cloud, one empty
    Tp, Tg = _poses(rng, B, 0.02)
    aj, sj = (np.asarray(a) for a in jmeter._add_dists_kernel(
        jnp.asarray(pts), jnp.asarray(n), jnp.asarray(Tp), jnp.asarray(Tg)))
    at, st, d_add, d_adds = (a.numpy() for a in tmeter.add_dists_plain(
        torch.from_numpy(pts), torch.from_numpy(n), torch.from_numpy(Tp),
        torch.from_numpy(Tg), per_point=True))
    np.testing.assert_allclose(at, aj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=0)
    assert at[1] == st[1] == 0.0  # n = 0: empty sums over max(n, 1)
    assert (st <= at + 1e-6).all()  # the closest point is never farther
    assert not d_add[2, n[2]:].any() and not d_adds[2, n[2]:].any()
    # the dispatcher takes the plain version for CPU tensors
    a2, s2 = tmeter.add_dists(*(torch.from_numpy(x) for x in (pts, n, Tp, Tg)))
    assert np.array_equal(a2.numpy(), at) and np.array_equal(s2.numpy(), st)


class _Mesh:
    def __init__(self, rng, n_obj=4, P=60):
        self.pts = [rng.uniform(-50, 50, (P - 10 * o, 3)).astype(np.float32)
                    for o in range(n_obj)]
        self.is_symmetric = np.array([False, True, False, True])[:n_obj]

    def points_padded(self):
        pmax = max(p.shape[0] for p in self.pts)
        out = np.zeros((len(self.pts), pmax, 3), np.float32)
        cnt = np.zeros((len(self.pts),), np.int32)
        for o, p in enumerate(self.pts):
            out[o, : p.shape[0]] = p
            cnt[o] = p.shape[0]
        return out, cnt


def test_eval_meter_aucs_and_table_match_jax():
    rng = np.random.default_rng(3)
    mesh = _Mesh(rng)
    mj = jmeter.EvalMeter(mesh)
    mt = tmeter.EvalMeter(mesh, device="cpu")
    for _ in range(12):
        o = int(rng.integers(1, 5))
        Tp, Tg = _poses(rng, 1, float(rng.uniform(0.001, 0.05)))
        for m in (mj, mt):
            m.update([o], [Tp[0][:3]], [Tg[0][:3]])
    for m in (mj, mt):
        m.update_no_det([2, 4])
    rj, rt = mj.result(), mt.result()
    assert rj.keys() == rt.keys()
    for k in rj:
        assert abs(rj[k][0] - rt[k][0]) <= 1e-6, k
        assert rj[k][1].keys() == rt[k][1].keys()
        for o in rj[k][1]:
            assert abs(rj[k][1][o] - rt[k][1][o]) <= 1e-6, (k, o)
    names = {1: "a", 2: "b", 3: "c", 4: "d", 5: "e"}
    assert mt.pprint_objs_str(names) == mj.pprint_objs_str(names)


def test_auc_and_average_meter_match_jax():
    rng = np.random.default_rng(4)
    for errs in (rng.uniform(0, 150, 40), [np.inf] * 3, [5.0], rng.uniform(0, 20, 7)):
        assert tmeter.compute_auc_posecnn(errs) == jmeter.compute_auc_posecnn(errs)
    a, b = tmeter.AverageMeter(), jmeter.AverageMeter()
    for x in rng.uniform(0, 1, 9):
        a.update(x, 2)
        b.update(x, 2)
    assert a.average() == b.average()
