"""The per-scene meter update and the launch plans of kernels K10 and K2, on
the CPU (no card needed).

`EvalMeter.update` scores a batch of (object, predicted pose, ground-truth
pose) entries with one `add_dists` call (K10's one launch on the card)
over the resident point table; an entry without a predicted pose is a missed
detection. The evaluation scores each scene with one such update. Checked
here: the batched update gives the same error lists (order included) and
AUCs as one update per object, and as the JAX package's `EvalMeter` fed the
same poses one object at a time (a module-scoped oracle); `Evaluator` makes
one `add_dists` call per scored scene, and its entries replayed one
object at a time give the same error lists.

Tolerances: the port's batched and per-object updates equal (the plain
version's per-pose result does not depend on the batch); against JAX the
errors within 1e-5 relative (f32 transforms and distances whose sums run in
another order) and the AUCs within 1e-6. The plain version runs the poses in groups whose
[b, P, P] temporaries stay within `PLAIN_PAIRS`, and a pose's results are
the same bits in any group.

Plans: `meter.plan_add_dists` (K10's grid) covers every valid (row, column)
pair of every pose exactly once, walked with the kernel's index math, and
fills the card at B = 1; `heatmap.plan_readout` (K2's dense-path predicate
and strip rows) takes the head's channels-last logits in both
`transpose_heatmaps` orders and sends every other layout to the strided
path; a numpy mirror of the dense path's decomposition at the plan's own
geometry (strips per CTA, empty CTAs where the outer extent is short,
threads per channel, moments factored by storage row, the final mapping to
u and v) reads every logit once and reproduces the plain readout in f64.
The plans' constants are read from the CUDA sources.
"""

import os
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from suo_slam_tpu.eval import meter as jmeter
from suo_slam_tpu_torch.eval import meter as tmeter
from suo_slam_tpu_torch.ops import heatmap as hm

CSRC = Path(__file__).resolve().parents[1] / "suo_slam_tpu_torch" / "csrc"


def _consts(name):
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


# ------------------------------------------------------------------ the meter --
class _Mesh:
    """Four objects of 37-60 points (two symmetric), padded to 60."""

    def __init__(self, rng, n_obj=4, P=60):
        self.pts = [rng.uniform(-50, 50, (P - 7 * o, 3)).astype(np.float32)
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


def _rot(rng, scale):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _scene_entries(rng, n_views=6, n_obj=4):
    """A scene's meter entries in the evaluation's order: per view, per
    ground-truth object, (obj_id, predicted 3x4 or None, ground truth 3x4);
    about a quarter missed, one whole view missed."""
    out = []
    for v in range(n_views):
        for o in rng.permutation(n_obj) + 1:
            Tg = np.eye(4)
            Tg[:3, :3] = _rot(rng, 1.0)
            Tg[:3, 3] = rng.uniform(-100, 100, 3) + [0, 0, 800]
            noise = float(rng.uniform(0.001, 0.05))
            Tp = Tg.copy()
            Tp[:3, :3] = _rot(rng, noise) @ Tg[:3, :3]
            Tp[:3, 3] += rng.normal(size=3) * 200 * noise
            missed = v == 2 or rng.uniform() < 0.25
            out.append((int(o), None if missed else Tp[:3].astype(np.float32),
                        Tg[:3].astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(12)
    mesh = _Mesh(rng)
    entries = _scene_entries(rng)
    jm = jmeter.EvalMeter(mesh)  # the JAX oracle, one object at a time
    for o, tp, tg in entries:
        if tp is None:
            jm.update_no_det([o])
        else:
            jm.update([o], [tp], [tg])
    return SimpleNamespace(mesh=mesh, entries=entries, jax=jm)


def _per_object(mesh, entries):
    m = tmeter.EvalMeter(mesh, device="cpu")
    for o, tp, tg in entries:
        if tp is None:
            m.update_no_det([o])
        else:
            m.update([o], [tp], [tg])
    return m


def _meters(m):
    return (m.add_meter, m.adds_meter, m.add_maybe_s_meter)


def test_batched_update_matches_per_object_and_jax(scene, monkeypatch):
    calls = []
    real = tmeter.add_dists
    monkeypatch.setattr(tmeter, "add_dists",
                        lambda *a, **kw: calls.append(a[2].shape[0]) or real(*a, **kw))
    batched = tmeter.EvalMeter(scene.mesh, device="cpu")
    batched.update(*zip(*scene.entries))
    n_hit = sum(tp is not None for _, tp, _ in scene.entries)
    assert calls == [n_hit] and 0 < n_hit < len(scene.entries)
    single = _per_object(scene.mesh, scene.entries)
    for b, s, j in zip(_meters(batched), _meters(single), _meters(scene.jax)):
        assert list(b.err_map) == list(s.err_map) == list(j.err_map)  # first-seen order
        for o in b.err_map:
            assert b.err_map[o] == s.err_map[o]
            np.testing.assert_allclose(b.err_map[o], j.err_map[o], rtol=1e-5, atol=0)
            assert np.isinf(b.err_map[o]).tolist() == np.isinf(j.err_map[o]).tolist()
    rb, rj = batched.result(), scene.jax.result()
    for k in rj:
        assert abs(rb[k][0] - rj[k][0]) <= 1e-6, k
        assert max(abs(rb[k][1][o] - rj[k][1][o]) for o in rj[k][1]) <= 1e-6, k
    names = {1: "a", 2: "b", 3: "c", 4: "d"}
    assert batched.pprint_objs_str(names) == scene.jax.pprint_objs_str(names)


def test_update_with_no_detection_only_calls_nothing(scene, monkeypatch):
    monkeypatch.setattr(tmeter, "add_dists", lambda *a, **kw: pytest.fail("called"))
    m = tmeter.EvalMeter(scene.mesh, device="cpu")
    m.update([3, 1, 3], [None] * 3, [None] * 3)
    assert m.add_meter.err_map == {3: [np.inf, np.inf], 1: [np.inf]}


def test_table_rows_equal_gathered_clouds(scene):
    """`obj` reads rows of the resident table: the same bits as the gathered
    clouds, through `add_dists_plain` and the dispatcher `add_dists`."""
    pts, cnt = (torch.from_numpy(a) for a in scene.mesh.points_padded())
    hits = [(o, tp, tg) for o, tp, tg in scene.entries if tp is not None]
    obj = torch.tensor([o - 1 for o, _, _ in hits], dtype=torch.int32)
    Tp, Tg = (torch.from_numpy(np.stack([tmeter._to44_np(e[i]) for e in hits]))
              for i in (1, 2))
    g = tmeter.add_dists_plain(pts[obj.long()], cnt[obj.long()], Tp, Tg, per_point=True)
    t = tmeter.add_dists_plain(pts, cnt, Tp, Tg, per_point=True, obj=obj)
    assert all(torch.equal(a, b) for a, b in zip(g, t))
    m = tmeter.add_dists(pts, cnt, Tp, Tg, obj)
    assert m.shape == (2, len(hits)) and torch.equal(m[0], g[0]) and torch.equal(m[1], g[1])


def test_plain_version_runs_poses_in_bounded_groups(scene, monkeypatch):
    """`add_dists_plain` splits B poses into groups of max(1, PLAIN_PAIRS //
    P^2) (at the MeshDb's P = 4096: one pose, 64 MiB a [1, P, P] f32
    temporary), and a pose's results are the same bits as in one group of
    all; an `EvalMeter.update` of 24 poses goes through such groups."""
    assert max(1, tmeter.PLAIN_PAIRS // 4096 ** 2) == 1
    pts, cnt = (torch.from_numpy(a) for a in scene.mesh.points_padded())
    P = pts.shape[1]
    B = 24
    rng = np.random.default_rng(5)
    obj = torch.from_numpy(rng.integers(0, len(cnt), B).astype(np.int32))
    Tg = torch.from_numpy(np.stack([np.eye(4)] * B).astype(np.float32))
    Tg[:, :3, :3] = torch.from_numpy(np.stack([_rot(rng, 1.0) for _ in range(B)]))
    Tg[:, 2, 3] = 800.0
    Tp = Tg.clone()
    Tp[:, :3, 3] += torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    whole = tmeter.add_dists_plain(pts, cnt, Tp, Tg, per_point=True, obj=obj)
    sizes = []
    real = tmeter._add_dists_group
    monkeypatch.setattr(tmeter, "_add_dists_group",
                        lambda p, *a: sizes.append(p.shape[0]) or real(p, *a))
    monkeypatch.setattr(tmeter, "PLAIN_PAIRS", 5 * P * P + 1)
    grouped = tmeter.add_dists_plain(pts, cnt, Tp, Tg, per_point=True, obj=obj)
    assert sizes == [5, 5, 5, 5, 4]
    assert all(torch.equal(a, b) for a, b in zip(whole, grouped))
    sizes.clear()
    m = tmeter.EvalMeter(scene.mesh, device="cpu")
    m.update([int(o) + 1 for o in obj], list(Tp[:, :3].numpy()), list(Tg[:, :3].numpy()))
    assert sizes == [5, 5, 5, 5, 4]
    add = {}
    for o, a in zip(obj.tolist(), whole[0].tolist()):
        add.setdefault(o + 1, []).append(a)
    assert m.add_meter.err_map == add


def test_evaluator_scores_each_scene_with_one_call(tmp_path, monkeypatch):
    """`Evaluator` (SLAM and single-view legs, ground-truth keypoints, the
    CPU) calls `add_dists` once per scored scene, over every scored
    pose of it; its meter entries replayed one object at a time give the
    same error lists."""
    from suo_slam_tpu_torch import evaluate as port_evaluate
    from tests.helpers.synthetic_bop import write_synthetic_bop

    root = tmp_path / "bop_datasets" / "ycbv"
    write_synthetic_bop(str(root), n_scenes=2, n_views=3, seed=3, splits=("test",))
    os.symlink(root / "models_bop-compat", root / "models_bop-compat_eval",
               target_is_directory=True)
    calls, updates = [], []
    real_means, real_update = tmeter.add_dists, tmeter.EvalMeter.update
    monkeypatch.setattr(tmeter, "add_dists",
                        lambda *a, **kw: calls.append(a[2].shape[0]) or real_means(*a, **kw))

    def update(self, *args):
        updates.append((self, [list(a) for a in args]))
        return real_update(self, *args)

    monkeypatch.setattr(tmeter.EvalMeter, "update", update)
    for nviews in (-1, 1):
        calls.clear(), updates.clear()
        ev = port_evaluate.Evaluator("ycbv", str(root), "", nviews=nviews, detection_type="gt",
                                     debug_gt_kp=True, no_viz=True, device="cpu",
                                     kp_config_root=str(root / "kp_configs"))
        ev.model_path = str(tmp_path / f"out{nviews}")
        assert ev.run() is not None
        assert len(updates) == 2 and len(calls) == 2, (nviews, calls)  # one per scene
        assert calls == [sum(p is not None for p in u[1][1]) for u in updates]
        replay = tmeter.EvalMeter(ev.mesh_db, device="cpu")
        for _, (ids, preds, gts) in updates:
            for o, tp, tg in zip(ids, preds, gts):
                if tp is None:
                    replay.update_no_det([o])
                else:
                    real_update(replay, [o], [tp], [tg])
        for a, b in zip(_meters(ev.meter), _meters(replay)):
            assert a.err_map == b.err_map and list(a.err_map) == list(b.err_map)


# -------------------------------------------------------------- K10's plan --
def test_add_plan_mirrors_the_source():
    c = _consts("add_dists.cu")
    assert (c["kThreads"], c["kRowsPerThread"], c["kMaxCols"]) == (
        tmeter.ADD_THREADS, tmeter.ADD_ROWS_PER_THREAD, tmeter.ADD_MAX_COLS)
    assert tmeter.ADD_ROWS_PER_BLOCK == 32 * c["kRowsPerThread"]


@pytest.mark.parametrize("B,P", [(1, 4096), (8, 4096), (96, 4096), (1, 700), (5, 700),
                                 (128, 700), (3, 7), (1, 1), (2, 1025)])
def test_add_plan_covers_every_pair_once(B, P):
    """Walk the grid as `add_dists_kernel` does: block (x, b) is row tile
    x // chunks and column chunk x % chunks of pose b; lane l of warp w owns
    rows tile * 128 + r * 32 + l (r < 4) against the w-th eighth of the
    chunk's columns [c0, c0 + cols)."""
    plan = tmeter.plan_add_dists(B, P)
    assert 1 <= plan.cols <= tmeter.ADD_MAX_COLS
    assert (plan.chunks - 1) * plan.cols < P <= plan.chunks * plan.cols
    blocks = B * plan.row_tiles * plan.chunks
    fill = tmeter.ADD_BLOCKS_PER_SM * 132
    if -(-P // tmeter.ADD_MIN_COLS) * B * plan.row_tiles >= fill:
        assert blocks >= fill  # B = 1 fills the card where chunks stay wide enough
    else:  # no narrower than half the least width
        assert 2 * plan.cols >= min(P, tmeter.ADD_MIN_COLS)
    W = tmeter.ADD_THREADS // 32
    lanes = (np.arange(tmeter.ADD_ROWS_PER_THREAD)[:, None] * 32 + np.arange(32)[None, :]).ravel()
    hits = np.zeros((P, P), np.int64)
    for tile in range(plan.row_tiles):
        r = tile * tmeter.ADD_ROWS_PER_BLOCK + lanes
        r = r[r < P]
        for chunk in range(plan.chunks):
            c0 = chunk * plan.cols
            nc = min(c0 + plan.cols, P) - c0
            for w in range(W):  # the warp's eighth of the chunk
                c = c0 + np.arange(nc * w // W, nc * (w + 1) // W)
                hits[np.ix_(r, c)] += 1
    assert (hits == 1).all()


def test_add_plan_refuses_what_the_grid_cannot_hold():
    for B, P in ((0, 10), (1, 0), (tmeter.GRID_Y_MAX + 1, 10)):
        with pytest.raises(ValueError):
            tmeter.plan_add_dists(B, P)


# --------------------------------------------------------------- K2's plan --
def test_readout_plan_mirrors_the_source():
    c = _consts("heatmap_readout.cu")
    assert (c["kMaxDenseThreads"], c["kMaxStripRows"], c["kMaxK"], c["kCluster"], c["kPer"]) == (
        hm.READOUT_MAX_THREADS, hm.READOUT_MAX_ROWS, hm.READOUT_MAX_K, hm.READOUT_CLUSTER,
        hm.READOUT_PER)


def _head(n, k=41, h=64, w=64, dtype=torch.float32):
    """The head's layout: an NHWC view of a channels_last NCHW tensor."""
    return torch.zeros(n, k, h, w, dtype=dtype).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _plan(x, **kw):
    return hm.plan_readout(x.shape, x.stride(), x.element_size(), x.data_ptr(), **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3, 8, 128])
def test_readout_plan_takes_the_head_dense(n, dtype):
    x = _head(n, dtype=dtype)
    for view, transposed in ((x, False), (x.transpose(1, 2), True)):
        p = _plan(view)
        assert (p.path, p.transposed, p.A, p.Bd) == (hm.DENSE, transposed, 64, 64)
        assert p.rows == 8  # 64 rows over the cluster's 8 CTAs
        assert p.threads == 352  # 8 threads a channel, 11 warps
        strip = p.rows * 64 * 41 * x.element_size()
        assert strip <= hm.READOUT_STRIP_BYTES
        assert p.smem == max(strip, 6 * p.threads * 4) + hm.READOUT_CLUSTER * 41 * 8 * 4
    assert _plan(x, path=hm.STRIDED).path == hm.STRIDED  # the earlier design on demand


def test_readout_plan_sends_other_layouts_to_the_strided_path():
    x = _head(4)
    nchw = torch.zeros(4, 41, 64, 64).permute(0, 2, 3, 1)  # K strided
    odd = torch.zeros(1 + 2 * 64 * 64 * 41)[1:].view(2, 64, 64, 41)  # 4 bytes off 16
    cases = [nchw, x[:, ::2], x[:, :, :63], odd, _head(2, k=65), _head(1, h=64, w=4096),
             _head(1, h=300, w=8), _head(1, k=3, h=8, w=2),  # 24-byte rows
             _head(1, k=41, h=8, w=63), _head(1, k=41, h=8, w=12),  # no multiple of 8
             _head(1, k=41, h=8, w=8)]  # 64 threads a CTA, fewer than the moments' 6 K
    for v in cases:
        assert _plan(v).path == hm.STRIDED, v.shape
        with pytest.raises(ValueError):
            _plan(v, path=hm.DENSE)
    with pytest.raises(ValueError):
        _plan(x, path=7)
    # a crop of a larger batch keeps the dense path: its crops stay aligned
    assert _plan(x[1:3]).path == hm.DENSE


def _dense_mirror(x, plan):
    """K2's dense path on [N, H, W, K] logits in f64, walked as the kernel
    does: per crop READOUT_CLUSTER CTAs of `rows` storage rows, thread t the
    channel t % K over inner positions t // K, + J, ...; the moments factored
    by storage row, summed per thread, then over threads, then over CTAs.
    Returns (uv, cov, pooled, reads per logit)."""
    st = x.transpose(0, 2, 1, 3) if plan.transposed else x  # storage [N, A, Bd, K]
    N, A, Bd, K = st.shape
    J = Bd // hm.READOUT_PER
    assert plan.threads >= J * K
    hb, ha = 0.5 * Bd, 0.5 * A
    b = np.arange(Bd)
    cb = 1 - (b + 0.5) / hb if plan.transposed else (b + 0.5) / hb - 1
    reads = np.zeros(st.shape, np.int64)
    mom = np.zeros((N, K, 6))
    total = np.zeros((N, K))
    for n in range(N):
        gmax = np.full(K, -np.inf)
        for rank in range(hm.READOUT_CLUSTER):  # pass 1
            a0 = rank * plan.rows
            for t in range(J * K):
                j, k = divmod(t, K)
                for a in range(a0, min(a0 + plan.rows, A)):
                    v = st[n, a, j::J, k]
                    reads[n, a, j::J, k] += 1
                    gmax[k] = max(gmax[k], v.max()) if v.size else gmax[k]
                    total[n, k] += v.sum()
        for rank in range(hm.READOUT_CLUSTER):  # pass 2
            a0 = rank * plan.rows
            for t in range(J * K):
                j, k = divmod(t, K)
                for a in range(a0, min(a0 + plan.rows, A)):
                    x_ = (a + 0.5) / ha
                    ca = x_ - 1 if plan.transposed else 1 - x_
                    e = np.exp(st[n, a, j::J, k] - gmax[k])
                    s0, s1, s2 = e.sum(), (e * cb[j::J]).sum(), (e * cb[j::J] ** 2).sum()
                    mom[n, k] += [s0, ca * s0, s1, ca * ca * s0, s2, ca * s1]
    m0, a1, b1, aa, bb, ab = np.moveaxis(mom, -1, 0)
    su, sv = (a1, b1) if plan.transposed else (b1, a1)
    suu, svv = (aa, bb) if plan.transposed else (bb, aa)
    eu, ev, euu, evv, euv = su / m0, sv / m0, suu / m0, svv / m0, ab / m0
    cuv = euv - eu * ev
    uv = np.stack([eu, ev], -1)
    cov = np.stack([np.stack([euu - eu * eu + 1e-6, cuv], -1),
                    np.stack([cuv, evv - ev * ev + 1e-6], -1)], -2)
    return uv, cov, total / (A * Bd), reads


@pytest.mark.parametrize("transposed", [False, True])  # storage [H, W, K] either way
@pytest.mark.parametrize("N,K,H,W", [
    (2, 5, 12, 16),  # 12 storage rows: 6 CTAs of 2, 2 empty
    (1, 5, 5, 8),    # 5 rows: 5 CTAs of 1, 3 empty
    (2, 5, 16, 24),  # 16 rows: every CTA 2
    (1, 3, 32, 16),  # 32 rows: every CTA 4
])
def test_dense_mirror_reads_each_logit_once_and_matches_plain(N, K, H, W, transposed):
    rng = np.random.default_rng(H + 10 * W + 100 * transposed)
    x = torch.from_numpy(rng.normal(size=(N, K, H, W)) * 3).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)  # f64, the head's layout
    view = x.transpose(1, 2) if transposed else x
    plan = _plan(view)
    assert plan.path == hm.DENSE and plan.transposed == transposed
    uv, cov, pooled, reads = _dense_mirror(view.numpy(), plan)
    assert (reads == 1).all()
    pu, pc, pp = (t.numpy() for t in hm.heatmap_readout_plain(view, 1e-6))
    np.testing.assert_allclose(uv, pu, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cov, pc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pooled, pp, rtol=0, atol=1e-12)
