"""K20 / K21's cluster design off the card: its plan, its walks, and a numpy
model of its summation order.

- `hourglass.plan_gn` against the constants of `csrc/group_norm.cu`, and
  its choices at the GroupNorm net's norm shapes (a cluster of up to 16
  CTAs for the large samples, one CTA and several samples for the 4 x 4
  norm, a ring of more than a slice where the blocks outnumber a wave);
- the kernels' walks mirrored in Python: every value of every sample is
  added once in phase one (the tail, then the kept pixels), written once by
  the second pass (the tail walked back with its clamped loads, then the
  kept pixels), every block of samples taken by one CTA row whatever the
  rows launched; each thread's ring holds a pixel only while its slot is
  free, every wait finds its group issued and every read the pixel copied
  there;
- the cluster design's order of summation modelled in numpy (f64 per
  value, each thread's tail then kept pixels in its order, the warp's
  shuffle tree, the rows in order, a group's channels in order, the ranks
  in order; K21's rows of blocks summed by lanes then in lane order) against
  the plain versions at mean / std ratios 0 to 10, within the gates of the
  card: statistics 1e-6 relative, y and dx within 1e-5 of their largest
  magnitude in f32 (2^-8 in bf16), dscale / dbias within 1e-5 of their scale.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from suo_slam_tpu_torch.models import hourglass as hg

SRC = (Path(hg.__file__).resolve().parent.parent / "csrc" / "group_norm.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def test_constants_mirror_the_source():
    assert _const("kGThreads") == hg.GN_THREADS
    assert _const("kGMaxCluster") == hg.GN_MAX_CLUSTER
    assert _const("kGMaxTeams") == hg.GN_MAX_TEAMS
    assert _const("kTailUnroll") == hg.GN_TAIL_UNROLL
    assert _const("kKeepBatch") == hg.GN_KEEP_BATCH
    assert _const("kGSmemBudget") == hg.GN_SMEM_BUDGET
    names = [p.strip()[2:].lower() for p in
             re.search(r"enum GPhase \{([^}]*)\}", SRC).group(1).split(",")]
    assert names[:4] == list(hg.GN_FWD_PHASES[:4]) == list(hg.GN_BWD_PHASES[:4])
    assert names[4] == "pass" and hg.GN_FWD_PHASES[4] == "apply" and hg.GN_BWD_PHASES[4] == "dx"
    assert names[5:] == list(hg.GN_BWD_PHASES[5:])
    m = re.search(r"constexpr int kGFwdPhases = (\d+), kGBwdPhases = (\d+);", SRC)
    assert (int(m.group(1)), int(m.group(2))) == (len(hg.GN_FWD_PHASES), len(hg.GN_BWD_PHASES))
    # the layout's terms, in the source's order
    layout = SRC[SRC.index("inline GLayout g_layout("):]
    layout = layout[:layout.index("return L;")]
    for term in ("16 * (pairs > kGThreads ? pairs : kGThreads)", "32LL * spp * C",
                 "32LL * spp * G", "spp * slots * g.lanes_p * C * itemsize", "8LL * spp * G"):
        assert term in layout, term


# the GroupNorm net's norm shapes at the train step's 32 rows (C, H), and odd ones
NET_SHAPES = [(32, 64, 128), (32, 128, 64), (32, 64, 64), (32, 256, 64), (32, 256, 32),
              (32, 128, 32), (32, 256, 16), (32, 128, 16), (32, 256, 8), (32, 128, 8),
              (32, 256, 4), (32, 128, 4), (8, 256, 64), (16, 128, 128), (3, 36, 5), (2, 600, 3)]


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("itemsize,vec", [(2, True), (4, True), (4, False)])
@pytest.mark.parametrize("N,C,H", NET_SHAPES)
def test_plan_gn_geometry(kind, itemsize, vec, N, C, H):
    HW = H * H
    V = 16 // itemsize if vec else 1
    if C % V:
        with pytest.raises(ValueError):
            hg.plan_gn(kind, N, HW, C, itemsize, vec, 132, 16)
        return
    if C // V > hg.GN_THREADS:  # the split design's shapes
        assert hg.plan_gn(kind, N, HW, C, itemsize, vec, 132, 16) is None
        return
    p = hg.plan_gn(kind, N, HW, C, itemsize, vec, 132, 16)
    G = hg.num_groups(C)
    assert p.V == V and p.cv == C // V
    cv, tt, lanes_p, q, rows = hg.gn_geom(C, V, p.spp)
    assert (lanes_p, q, rows) == (p.lanes_p, p.q, p.rows) and cv <= tt and tt % 32 == 0
    if q > 1:  # a warp's lanes hold q whole pixel lanes
        assert q * cv == 32 and lanes_p * cv == tt
    assert p.k in (1, 2, 4, 8, 16) and (p.k == 1 or p.spp == 1)
    assert p.spp in (1, 2, 4, 8) and p.blocks == -(-N // p.spp)
    assert p.iters == -(-(-(-HW // p.k)) // lanes_p)
    assert 0 <= p.keep <= p.iters and p.keep <= p.slots <= 2 * p.iters
    assert (p.keep == 0) == (not vec) or p.iters == 0
    assert p.smem == hg.gn_smem(p.spp, rows, lanes_p, C, G, itemsize, p.slots, kind == "bwd")
    assert p.smem <= hg.GN_SMEM_BUDGET
    if vec and p.keep < p.iters:  # only where the largest cluster leaves too large a slice
        assert p.k == 16


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("itemsize,vec", [(2, True), (4, True), (2, False), (4, False)])
@pytest.mark.parametrize("HW", [1, 16, 4096])
def test_plan_gn_route_boundary(kind, itemsize, vec, HW):
    """The cluster design plans every pixel of up to GN_THREADS channel
    vectors, in shared memory within the budget; one vector more takes the
    split design (no plan)."""
    V = 16 // itemsize if vec else 1
    widest = hg.plan_gn(kind, 8, HW, hg.GN_THREADS * V, itemsize, vec, 132, 16)
    assert widest is not None and widest.cv == hg.GN_THREADS
    assert widest.smem <= hg.GN_SMEM_BUDGET
    assert hg.plan_gn(kind, 8, HW, (hg.GN_THREADS + 1) * V, itemsize, vec, 132, 16) is None


def test_plan_gn_choices_at_the_net_shapes():
    plan = lambda kind, N, C, H, it=2: hg.plan_gn(kind, N, H * H, C, it, True, 132, 16)
    big = plan("fwd", 32, 256, 64)  # 2 MB a sample: 16 CTAs of 128 KB, a ring beyond it
    assert (big.k, big.keep, big.iters) == (16, 32, 32) and big.slots > big.keep
    bwd = plan("bwd", 32, 256, 64)  # x and dy: 4 MB a sample, part read again
    assert bwd.k == 16 and 0 < bwd.keep < bwd.iters and bwd.slots == bwd.keep
    small = plan("fwd", 32, 128, 4)  # a 4 x 4 norm: one CTA, two samples, no cluster
    assert (small.k, small.spp, small.blocks) == (1, 2, 16)
    assert plan("fwd", 8, 256, 64).slots == plan("fwd", 8, 256, 64).keep  # one wave
    with pytest.raises(ValueError, match="unknown kind"):
        hg.plan_gn("stats", 1, 1, 8, 4, True, 132, 16)


# the kernels' walks ---------------------------------------------------------
def _slice(HW, k, rank):
    s = -(-HW // k)
    p0 = min(rank * s, HW)
    return p0, min(p0 + s, HW)


def _threads(p):
    """(team, sub) of every thread that owns pixel lanes (jl is free)."""
    cv, tt, lanes_p, _, _ = hg.gn_geom(p.cv * p.V, p.V, p.spp)
    return [(team, sub) for team in range(p.spp) for sub in range(lanes_p)]


def _n_it(HW, k, rank, sub, lanes_p):
    p0, p1 = _slice(HW, k, rank)
    return 0 if p0 + sub >= p1 else -(-(p1 - p0 - sub) // lanes_p)


def _pass_order(n_it, nk):
    """The second pass: the tail walked back kTailUnroll at a time (a load
    past the tail's start is clamped and its value not written), then the
    kept pixels."""
    out = []
    U = hg.GN_TAIL_UNROLL
    for i0 in range(n_it - 1, nk - 1, -U):
        out += [i0 - u for u in range(U) if i0 - u >= nk]
    return out + list(range(nk))


def _phase_one_order(n_it, nk):
    U = hg.GN_TAIL_UNROLL
    out = []
    for i0 in range(nk, n_it, U):
        out += [i0 + u for u in range(U) if i0 + u < n_it]
    return out + list(range(nk))


WALKS = [("fwd", 5, 37, 64, 2, 8), ("bwd", 3, 256, 64, 2, 3), ("fwd", 32, 16, 128, 2, 16),
         ("bwd", 4, 1000, 256, 4, 2), ("fwd", 7, 9, 36, 4, 5), ("fwd", 2, 4096, 256, 2, 1)]


@pytest.mark.parametrize("kind,N,HW,C,itemsize,rows", WALKS)
def test_walks_cover_every_value_once(kind, N, HW, C, itemsize, rows):
    p = hg.plan_gn(kind, N, HW, C, itemsize, C % (16 // itemsize) == 0, 132, 16)
    rows = min(rows, p.blocks)
    taken = sorted(b for r in range(rows) for b in range(r, p.blocks, rows))
    assert taken == list(range(p.blocks))  # each block by one CTA row
    seen1, seen2 = [], []
    for blk in range(p.blocks):
        for rank in range(p.k):
            p0, _ = _slice(HW, p.k, rank)
            for team, sub in _threads(p):
                n = blk * p.spp + team
                if n >= N:
                    continue
                n_it = _n_it(HW, p.k, rank, sub, p.lanes_p)
                nk = min(n_it, p.keep)
                one, two = _phase_one_order(n_it, nk), _pass_order(n_it, nk)
                assert sorted(one) == sorted(two) == list(range(n_it))
                seen1 += [(n, p0 + sub + i * p.lanes_p) for i in one]
                seen2 += [(n, p0 + sub + i * p.lanes_p) for i in two]
    want = [(n, q) for n in range(N) for q in range(HW)]
    assert sorted(seen1) == want and sorted(seen2) == want


def _ring(nk, R, n_rows):
    """One thread's ring over its n_rows blocks in `gn_cluster_body`'s
    schedule (issue / pump / freed; a block's phase one, then its second
    pass, which frees slots for the next blocks' copies): every copy lands
    in a free slot, every wait finds its group issued, every read finds its
    pixel."""
    B = hg.GN_KEEP_BATCH
    nbs = -(-nk // B)
    total = n_rows * nbs
    state = {"issued": 0, "freed": 0}
    slot_of = {}  # slot -> (j, i) it holds
    live = set()  # (j, i) copied, not yet consumed by the second pass

    def issue():
        j, b0 = divmod(state["issued"], nbs)
        b0 *= B
        for i in range(b0, min(b0 + B, nk)):
            s = (j * nk + i) % R
            assert slot_of.get(s) not in live, (nk, R, j, i)  # the slot is free
            slot_of[s] = (j, i)
            live.add((j, i))
        state["issued"] += 1

    def pump():
        while state["issued"] < total:
            j, b = divmod(state["issued"], nbs)
            if j * nk + min((b + 1) * B, nk) > state["freed"] + R:
                break
            issue()

    def add(j, i):  # phase one's read of kept pixel i of block j
        if i % B == 0:
            assert state["issued"] > j * nbs + i // B  # the wait's group is in flight
        assert slot_of[(j * nk + i) % R] == (j, i)

    pump()
    for j in range(n_rows):
        for i in range(nk):
            add(j, i)
        for i in range(nk):
            assert slot_of[(j * nk + i) % R] == (j, i)  # the second pass's read
            live.discard((j, i))
            if (i + 1) % B == 0:
                state["freed"] = j * nk + i + 1
                pump()
        state["freed"] = (j + 1) * nk
        pump()
    assert state["issued"] == total and not live


@pytest.mark.parametrize("nk,R", [(32, 32), (32, 46), (23, 23), (16, 25), (8, 8), (2, 2),
                                  (5, 9), (7, 7), (3, 6), (13, 20)])
@pytest.mark.parametrize("n_rows", [1, 2, 5])
def test_ring_slots(nk, R, n_rows):
    _ring(nk, R, n_rows)


def test_ring_slots_of_the_plans():
    for kind in ("fwd", "bwd"):
        for N, C, H in NET_SHAPES[:12]:
            p = hg.plan_gn(kind, N, H * H, C, 2, True, 132, 16)
            if p.keep:
                _ring(p.keep, p.slots, 3)


# a numpy model of the summation order ----------------------------------------
def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _cta_rows(vals, p, HW, C, rank):
    """One rank's per-channel sums of one sample: vals [HW, 2, C] f64
    terms; each thread's pixels in its phase-one order, its warp's shuffle
    tree over the q pixel lanes, then the rows in order."""
    acc = np.zeros((p.lanes_p, 2, C))
    p0, _ = _slice(HW, p.k, rank)
    for sub in range(p.lanes_p):
        n_it = _n_it(HW, p.k, rank, sub, p.lanes_p)
        for i in _phase_one_order(n_it, min(n_it, p.keep)):
            acc[sub] = acc[sub] + vals[p0 + sub + i * p.lanes_p]
    if p.q > 1:
        acc = acc.reshape(p.rows, p.q, 2, C)
        o = p.q // 2
        while o >= 1:
            acc[:, :o] = acc[:, :o] + acc[:, o:2 * o]
            o //= 2
        acc = acc[:, 0]
    out = np.zeros((2, C))
    for r in range(acc.shape[0]):
        out = out + acc[r]
    return out


def _groups(crow, G, w=None):
    """[2, C] per-channel sums -> [2, G], a group's channels in order (K21:
    each weighted by scale)."""
    C = crow.shape[1]
    cpg = C // G
    out = np.zeros((2, G))
    for c in range(C):
        out[:, c // cpg] = out[:, c // cpg] + (crow[:, c] if w is None else w[c] * crow[:, c])
    return out


def _model(x, dy, scale, bias, p, dt, stats):
    """The cluster design on x, dy [N, HW, C] (values of dt in f32): K20's
    mean, rstd [N, G] and y; K21's dx, dscale, dbias through `stats` (the
    mean and rstd it is handed)."""
    N, HW, C = x.shape
    G = hg.num_groups(C)
    cpg = C // G
    M = HW * cpg
    cast = _bf16 if dt == "bf16" else (lambda a: np.asarray(a, np.float32))
    f = np.float32
    mean, rstd = np.zeros((N, G), f), np.zeros((N, G), f)
    for n in range(N):
        xd = x[n].astype(np.float64)
        parts = [_groups(_cta_rows(np.stack([xd, xd * xd], 1), p, HW, C, r), G)
                 for r in range(p.k)]
        A = np.zeros((2, G))
        for gp in parts:  # the ranks in order
            A = A + gp
        m = A[0] / M
        v = np.maximum(A[1] / M - m * m, 0.0)
        mean[n], rstd[n] = m.astype(f), (1.0 / np.sqrt(v + hg.GN_EPS)).astype(f)
    stats_fwd = mean, rstd
    def pre(mean, rstd):
        mc, rc = np.repeat(mean, cpg, 1)[:, None], np.repeat(rstd, cpg, 1)[:, None]
        xc = (x - mc).astype(f)
        return xc, rc, cast(((xc * (rc * scale).astype(f)).astype(f) + bias).astype(f))

    z = pre(mean, rstd)[2]
    y = np.where(z > 0, z, f(0))
    mean, rstd = stats
    xc, rc, z = pre(mean, rstd)
    g = np.where(z > 0, dy, f(0)).astype(f)
    rows = np.zeros((p.blocks, 2, C))
    hbar, Q = np.zeros((N, G), f), np.zeros((N, G), f)
    for n in range(N):
        gd, gxc = g[n].astype(np.float64), g[n].astype(np.float64) * xc[n].astype(np.float64)
        crows = [_cta_rows(np.stack([gd, gxc], 1), p, HW, C, r) for r in range(p.k)]
        A, tot = np.zeros((2, G)), np.zeros((2, C))
        for cr in crows:
            A = A + _groups(cr, G, scale.astype(np.float64))
            tot = tot + cr
        r64 = rstd[n].astype(np.float64)
        hbar[n], Q[n] = (A[0] / M).astype(f), (r64 * r64 * r64 * A[1] / M).astype(f)
        rows[n // p.spp, 0] = rows[n // p.spp, 0] + tot[0]
        rows[n // p.spp, 1] = rows[n // p.spp, 1] + np.repeat(r64, cpg) * tot[1]
    dbias, dscale = np.zeros(C, f), np.zeros(C, f)
    cb = -(-C // p.k)
    for rank in range(p.k):  # the last CTA of channel block `rank`
        c0, c1 = min(rank * cb, C), min(rank * cb + cb, C)
        for cc in range(c0, c1, hg.GN_THREADS):
            nc = min(c1 - cc, hg.GN_THREADS)
            lanes = hg.GN_THREADS // nc
            part = np.zeros((lanes, 2, nc))
            for b in range(p.blocks):
                part[b % lanes] = part[b % lanes] + rows[b, :, cc:cc + nc]
            acc = np.zeros((2, nc))
            for lane in range(lanes):
                acc = acc + part[lane]
            dbias[cc:cc + nc], dscale[cc:cc + nc] = acc[0].astype(f), acc[1].astype(f)
    hb, qc = np.repeat(hbar, cpg, 1)[:, None], np.repeat(Q, cpg, 1)[:, None]
    u = ((scale * g).astype(f) - hb).astype(f)
    dx = cast(((rc * u).astype(f) - (xc * qc).astype(f)).astype(f))
    return stats_fwd, y, dx, dscale, dbias


def _torch(a, dt):
    N, HW, C = a.shape
    H = int(round(HW ** 0.5))
    t = torch.from_numpy(np.ascontiguousarray(a)).reshape(N, H, HW // H, C).permute(0, 3, 1, 2)
    return t.to(torch.bfloat16 if dt == "bf16" else torch.float32).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    N, C = t.shape[:2]
    return t.float().permute(0, 2, 3, 1).reshape(N, -1, C).numpy()


MODELS = [(3, 64, 64, 8, 1, 2), (2, 100, 32, 4, 1, 2), (4, 16, 64, 1, 2, 2),
          (3, 256, 32, 16, 1, 3), (2, 36, 16, 2, 1, 1)]


@pytest.mark.parametrize("ratio", [0.0, 1.0, 10.0])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,HW,C,k,spp,keep", MODELS)
def test_summation_order_model_within_the_gates(ratio, dt, N, HW, C, k, spp, keep):
    rng = np.random.default_rng(int(ratio * 7) + C + HW)
    V = 8 if dt == "bf16" else 4
    _, _, lanes_p, q, rows = hg.gn_geom(C, V, spp)
    iters = -(-(-(-HW // k)) // lanes_p)
    p = hg.GnPlan(V, k, spp, C // V, lanes_p, q, rows, iters, min(keep, iters),
                  min(keep, iters), -(-N // spp), 0)
    std = 1.5
    mu_c = ratio * std * rng.choice([-1.0, 1.0], (N, 1, C))
    x = (rng.normal(size=(N, HW, C)) * std + mu_c).astype(np.float32)
    dy = rng.normal(size=(N, HW, C)).astype(np.float32)
    if dt == "bf16":
        x, dy = _bf16(x), _bf16(dy)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.normal(size=C) * 0.2).astype(np.float32)
    G = hg.num_groups(C)
    xt, dyt = _torch(x, dt), _torch(dy, dt)
    sc, bs = torch.from_numpy(scale), torch.from_numpy(bias)
    yp, mp, rp = hg.group_norm_relu_plain(xt, sc, bs, G)
    dxp, dsp, dbp = hg.group_norm_relu_bwd_plain(xt, dyt, sc, bs, mp, rp)
    (mean, rstd), y, dx, dscale, dbias = _model(x, dy, scale, bias, p, dt,
                                                (mp.numpy(), rp.numpy()))
    rel = lambda a, b: np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
    assert rel(mean, mp.numpy()) <= 1e-6 and rel(rstd, rp.numpy()) <= 1e-6
    tol = 1e-5 if dt == "f32" else 2.0 ** -8
    ypn, dxpn = _nhwc(yp), _nhwc(dxp)
    assert np.abs(y - ypn).max() <= tol * np.abs(ypn).max()
    # dx through the plain statistics, as the card's check feeds K21
    assert np.abs(dx - dxpn).max() <= tol * np.abs(dxpn).max()
    for a, b in ((dscale, dsp.numpy()), (dbias, dbp.numpy())):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)
