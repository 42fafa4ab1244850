"""K16 / K17's fused design off the card: its plan, the plain twins' fused
outputs, and a numpy model of its summation order.

- `hourglass.plan_bn` / `plan_split` against the constants of
  `csrc/bn_train.cu` and `csrc/channel_vec.cuh`, and the kernels' walks
  mirrored in Python: every CTA slab, every thread's pixels (K16's over the
  real rows only, K17's dx pass walked back) cover each pixel exactly once;
- the plain twins' new outputs (`bn_train_stats_plain`'s rstd / inv / shift
  and running averages, `norm_relu_bwd_plain`'s dscale) equal to the eager
  expressions `MaskedBatchNorm` and its backward ran before they were folded
  into the kernels, in f32, bf16 and f64; the net hands every norm one uint8
  row mask a forward;
- the fused kernels' order of summation modelled in numpy (f64 per value,
  each thread's pixels in its order, each CTA's pixel lanes by the shuffle
  tree and its rows in order, the grid's rows by lanes and a shuffle tree)
  against f64 sums in numpy's order, at mean / std ratios 0 to 10: the f32
  statistics and dx coefficients equal in all but a few channels (the
  rounding the ill-conditioned bf16 train step needs), the statistics
  within 1e-6 relative, K17's sums within 1e-5 of their scale and dx within
  1e-5 of its largest magnitude in f32 (1 bf16 ulp in bf16).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from suo_slam_tpu_torch.models import hourglass as hg

CSRC = Path(hg.__file__).resolve().parent.parent / "csrc"


def _const(text: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


def test_constants_mirror_the_sources():
    bn = (CSRC / "bn_train.cu").read_text()
    cv = (CSRC / "channel_vec.cuh").read_text()
    assert _const(bn, "kFThreads") == hg.FUSED_THREADS
    assert _const(bn, "kStatsUnroll") == hg.STATS_UNROLL
    assert _const(bn, "kBwdUnroll") == hg.BWD_UNROLL
    assert _const(cv, "kThreads") == hg.SPLIT_THREADS
    assert _const(cv, "kIters") == hg.SPLIT_ITERS
    phases = re.search(r"enum Phase \{([^}]*)\}", bn).group(1)
    names = [p.strip() for p in phases.split(",")]
    assert len(names) == len(hg.BN_BWD_PHASES)
    assert [n[1:].lower() for n in names] == [p.replace("2", "") + ("2" if "2" in p else "")
                                              for p in hg.BN_BWD_PHASES]
    m = re.search(r"constexpr int kStatsPhases = (\d+), kBwdPhases = (\d+);", bn)
    assert (int(m.group(1)), int(m.group(2))) == (len(hg.BN_STATS_PHASES), len(hg.BN_BWD_PHASES))


PLANS = [(32, 4096, 256, 2, True), (32, 4096, 256, 4, True), (32, 16384, 64, 2, True),
         (32, 16, 128, 2, True), (32, 64, 256, 4, True), (5, 256, 64, 4, True),
         (4, 15, 96, 2, False), (2, 16, 300, 4, False), (2, 9, 600, 4, False),
         (3, 7, 8, 2, True), (1, 1, 1, 4, False), (6, 1024, 4104, 2, True)]


@pytest.mark.parametrize("kind", ["stats", "bwd"])
@pytest.mark.parametrize("N,HW,C,itemsize,vec", PLANS)
def test_plan_bn_geometry(kind, N, HW, C, itemsize, vec):
    n_sm = 132
    p = hg.plan_bn(kind, N, HW, C, itemsize, vec, n_sm)
    assert p.V == (16 // itemsize if vec else 1)
    cv = C // p.V
    assert p.lanes_c == min(max(cv, 1), hg.FUSED_THREADS)
    assert p.lanes_c * p.lanes_p <= hg.FUSED_THREADS and p.lanes_p >= 1
    if p.q > 1:
        assert p.q * p.lanes_c == 32 and p.rows == hg.FUSED_THREADS // 32
    assert p.rows * p.q == p.lanes_p
    unroll = hg.STATS_UNROLL if kind == "stats" else hg.BWD_UNROLL
    step = p.lanes_p * unroll
    assert 1 <= p.grid <= n_sm
    if p.grid < n_sm and p.grid > 1:  # small tensors: every CTA gets MIN_ITERS iterations
        assert N * HW >= (p.grid - 1) * step * hg.MIN_ITERS
    red = p.rows * p.lanes_c * p.V * 16
    extra = 4 * N if kind == "stats" else 5 * p.lanes_c * p.V * 4
    assert p.smem == red + extra <= hg.SMEM_LIMIT
    assert p.part == p.grid * C * 2


def test_plan_bn_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        hg.plan_bn("stats", 60000, 16, 256, 2, True, 132)


@pytest.mark.parametrize("N,HW,C,itemsize,vec", PLANS)
def test_plan_split_counts_the_partial_blocks(N, HW, C, itemsize, vec):
    V = 16 // itemsize if vec else 1
    lanes_c = min(C // V, hg.SPLIT_THREADS)
    per_block = (hg.SPLIT_THREADS // lanes_c) * hg.SPLIT_ITERS
    assert hg.plan_split(N, HW, C, itemsize, vec) == -(-N * HW // per_block)


def _slab(n, grid, b):
    """`bn_train.cu` slab_of."""
    per = -(-n // grid)
    a = b * per
    return min(a, n), min(a + per, n)


def _thread_pixels(p0, p1, sub, lanes_p, unroll, reverse=False):
    """The pixels one thread handles in a fused pass (the loads past the slab
    are clamped and their values not used), in its order."""
    step = lanes_p * unroll
    if p0 + sub >= p1:
        return []
    n_it = -(-(p1 - (p0 + sub)) // step)
    its = range(n_it - 1, -1, -1) if reverse else range(n_it)
    us = range(unroll - 1, -1, -1) if reverse else range(unroll)
    return [p for i in its for u in us
            if (p := p0 + sub + i * step + u * lanes_p) < p1]


@pytest.mark.parametrize("N,HW,C", [(32, 64, 256), (5, 37, 64), (3, 1000, 128), (7, 16, 8)])
def test_fused_walks_cover_every_pixel_once(N, HW, C):
    rng = np.random.default_rng(N * HW + C)
    mask = rng.random(N) < 0.7
    for kind, unroll in (("stats", hg.STATS_UNROLL), ("bwd", hg.BWD_UNROLL)):
        p = hg.plan_bn(kind, N, HW, C, 2, True, 16)
        if kind == "stats":  # the real rows' pixels, through the compaction
            real = np.flatnonzero(mask)
            n, lanes = len(real) * HW, [q for q in range(p.lanes_p)]
            seen = []
            for b in range(p.grid):
                q0, q1 = _slab(n, p.grid, b)
                for sub in lanes:
                    seen += [int(real[q // HW]) * HW + q % HW
                             for q in _thread_pixels(q0, q1, sub, p.lanes_p, unroll)]
            want = [int(r) * HW + k for r in real for k in range(HW)]
            assert sorted(seen) == want
        else:
            for reverse in (False, True):
                seen = []
                for b in range(p.grid):
                    p0, p1 = _slab(N * HW, p.grid, b)
                    for sub in range(p.lanes_p):
                        seen += _thread_pixels(p0, p1, sub, p.lanes_p, unroll, reverse)
                assert sorted(seen) == list(range(N * HW))


# the plain twins' fused outputs ------------------------------------------------
def _case(dt, seed=0, N=6, C=12, H=5, W=4):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(N, C, H, W, generator=g) * 1.5 + torch.randn(1, C, 1, 1, generator=g)).to(
        dt).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(N, C, H, W, generator=g).to(dt).contiguous(memory_format=torch.channels_last)
    f = torch.float64 if dt == torch.float64 else torch.float32
    scale = (torch.rand(C, generator=g) + 0.5).to(f)
    bias = torch.randn(C, generator=g).to(f)
    rm, rv = torch.randn(C, generator=g).to(f), (torch.rand(C, generator=g) + 0.5).to(f)
    return x, dy, scale, bias, rm, rv


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("mask", [None, "bool", "uint8"])
def test_bn_train_stats_plain_is_the_eager_epilogue(dt, mask):
    x, _, scale, bias, rm, rv = _case(dt)
    m = None if mask is None else torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)
    if mask == "uint8":
        m = m.to(torch.uint8)
    rm0, rv0 = rm.clone(), rv.clone()
    mean, var, rstd, inv, shift = hg.bn_train_stats_plain(x, m, scale, bias, 1e-5, rm, rv, 0.9)
    # MaskedBatchNorm's eager operations before K16 took them over
    mref, vref = hg.bn_stats_plain(x, None if m is None else m.bool())
    assert torch.equal(mean, mref) and torch.equal(var, vref)
    r = torch.rsqrt(vref + 1e-5)
    i = r * scale
    assert torch.equal(rstd, r) and torch.equal(inv, i)
    assert torch.equal(shift, bias - mref * i)
    assert torch.equal(rm, rm0 * 0.9 + mref * (1 - 0.9))
    assert torch.equal(rv, rv0 * 0.9 + vref * (1 - 0.9))
    if dt != torch.float64:  # flax's f32 rounding of each product, by numpy
        f = np.float32
        want = (rm0.numpy().astype(f) * f(0.9)) + (mref.numpy().astype(f) * f(1 - 0.9))
        np.testing.assert_array_equal(rm.numpy(), want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float64])
def test_norm_relu_bwd_plain_dscale(dt):
    x, dy, scale, bias, _, _ = _case(dt, seed=1)
    m = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.uint8)
    mean, var = hg.bn_stats_plain(x, m)
    rstd = torch.rsqrt(var + 1e-5)
    inv = rstd * scale
    shift = bias - mean * inv
    dx, sg, sgc, dscale = hg.norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, m)
    assert torch.equal(dscale, sgc * rstd)  # the backward's former eager multiply
    dxb = hg.norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, m.bool())
    assert all(torch.equal(a, b) for a, b in zip((dx, sg, sgc, dscale), dxb))
    fixed = hg.norm_relu_bwd_plain(x, dy, inv, shift)
    assert fixed[3] is fixed[2]  # d inv with fixed statistics


def test_train_mode_norm_matches_the_earlier_composition():
    """`MaskedBatchNorm(train=True)` on the CPU: output, running averages and
    gradients equal to the earlier composition (statistics, then the eager
    affine, K8's plain version, the eager running update; the backward's
    dscale as sum_gc * rstd)."""
    x, dy, scale, bias, rm, rv = _case(torch.float32, seed=2)
    m = torch.tensor([1, 0, 1, 1, 1, 0], dtype=torch.bool)
    bn = hg.MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
        bn.mean.copy_(rm)
        bn.var.copy_(rv)
    xg = x.clone().requires_grad_(True)
    y = bn(xg, train=True, row_mask=m)
    y.backward(dy)
    mean, var = hg.bn_stats_plain(x, m)
    rstd = torch.rsqrt(var + bn.eps)
    inv = rstd * scale
    shift = bias - mean * inv
    assert torch.equal(y, hg.norm_relu_plain(x, inv, shift))
    assert torch.equal(bn.mean, rm * 0.9 + mean * (1 - 0.9))
    assert torch.equal(bn.var, rv * 0.9 + var * (1 - 0.9))
    dx, sg, sgc, _ = hg.norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, m)
    assert torch.equal(xg.grad, dx) and torch.equal(bn.bias.grad, sg)
    assert torch.equal(bn.scale.grad, sgc * rstd)


def test_net_hands_every_norm_one_uint8_mask():
    net = hg.HourglassNet(in_features=3, num_output=4, n_stack=1, n_modules=1, features=16,
                          depth=2)
    x = torch.rand(3, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    masks = []
    real = hg.bn_train_stats

    def spy(xx, row_mask, *a, **kw):
        masks.append(row_mask)
        return real(xx, row_mask, *a, **kw)

    hg.bn_train_stats = spy
    try:
        net(x, train=True, row_mask=torch.tensor([True, False, True]))
    finally:
        hg.bn_train_stats = real
    n_norms = sum(isinstance(m, hg.MaskedBatchNorm) for m in net.modules())
    assert len(masks) == n_norms > 1
    assert all(m is masks[0] for m in masks) and masks[0].dtype == torch.uint8


# a numpy model of the fused kernels' order of summation -------------------------
def _block_fold(s, p):
    """[lanes_p, C] per-thread f64 sums -> the CTA's [C] row: shuffle-down tree
    inside each warp's q pixel lanes, then the rows in order."""
    s = s.copy()
    if p.q > 1:
        s = s.reshape(p.rows, p.q, -1)
        o = p.q // 2
        while o >= 1:
            s[:, :o] = s[:, :o] + s[:, o:2 * o]
            o //= 2
        s = s[:, 0]
    out = np.zeros(s.shape[1])
    for r in range(s.shape[0]):
        out = out + s[r]
    return out


THREAD_SUMS = _const((CSRC / "bn_train.cu").read_text(), "kThreadSums")


def _grid_fold(rows):
    """[grid, C] -> [C]: up to THREAD_SUMS rows, a thread adds them in order;
    more, lane l adds rows l, l + 32, ... in order, then a shuffle-down tree
    to lane 0."""
    if rows.shape[0] <= THREAD_SUMS:
        out = np.zeros(rows.shape[1])
        for r in rows:
            out = out + r
        return out
    lanes = np.zeros((32, rows.shape[1]))
    for i in range(rows.shape[0]):
        lanes[i % 32] = lanes[i % 32] + rows[i]
    o = 16
    while o >= 1:
        lanes[:o] = lanes[:o] + lanes[o:2 * o]
        o //= 2
    return lanes[0]


def _fold_cta(vals, p0, p1, p, unroll):
    """One CTA's per-channel sums of vals [P, k, C] (k summands a pixel) in the
    kernel's order: thread sub adds, in f64, pixels p0 + sub + it * step +
    u * lanes_p in (it, u) order, then the CTA folds its pixel lanes."""
    step = p.lanes_p * unroll
    k, C = vals.shape[1:]
    acc = np.zeros((k, p.lanes_p, C))
    n_it = -(-(p1 - p0) // step) if p1 > p0 else 0
    subs = np.arange(p.lanes_p)
    for it in range(n_it):
        for u in range(unroll):
            px = p0 + subs + it * step + u * p.lanes_p
            ok = px < p1
            v = vals[np.minimum(px, max(p1 - 1, 0))]  # [lanes_p, k, C]
            acc = acc + np.where(ok[:, None, None], v, 0).transpose(1, 0, 2)
    return np.stack([_block_fold(acc[i], p) for i in range(k)])


def _model_sums(vals, p, unroll):
    """Grid-wide sums of vals [P, k, C] in the fused kernels' order."""
    rows = [_fold_cta(vals, *_slab(vals.shape[0], p.grid, b), p, unroll) for b in range(p.grid)]
    return np.stack([_grid_fold(np.stack([r[i] for r in rows])) for i in range(vals.shape[1])])


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("ratio", [0.0, 1.0, 10.0])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,HW,C,n_sm", [(8, 96, 32, 6), (6, 48, 256, 5), (32, 1024, 64, 40)])
def test_summation_order_model_within_the_gates(ratio, dt, N, HW, C, n_sm):
    rng = np.random.default_rng(int(ratio * 7) + C)
    itemsize = 4 if dt == "f32" else 2
    std = 1.5
    mu_c = ratio * std * rng.choice([-1.0, 1.0], C)
    x = (rng.normal(size=(N * HW, C)) * std + mu_c).astype(np.float32)
    dy = rng.normal(size=(N * HW, C)).astype(np.float32)
    if dt == "bf16":
        x, dy = _bf16(x), _bf16(dy)
    real = rng.random(N) < 0.75
    real[0] = True
    # K16 over the real rows' pixels, f64 per value
    p16 = hg.plan_bn("stats", N, HW, C, itemsize, True, n_sm)
    xr = x.reshape(N, HW, C)[real].reshape(-1, C).astype(np.float64)
    M = real.sum() * HW

    def stats_of(s):
        mu = s[0] / M
        return mu.astype(np.float32), (s[1] / M - mu * mu).astype(np.float32)

    s = _model_sums(np.stack([xr, xr * xr], 1), p16, hg.STATS_UNROLL)
    (mean, var), (mean_e, var_e) = stats_of(s), stats_of(np.stack([xr.sum(0), (xr * xr).sum(0)]))
    assert np.array_equal(mean, mean_e) and np.array_equal(var, var_e)
    exact_mean = xr.mean(0)
    exact_var = ((xr - exact_mean) ** 2).mean(0)
    for a, b in ((mean, exact_mean), (var, exact_var)):
        assert (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max() <= 1e-6
    # K17: g and g * xc (an exact f64 product), f64 per value
    mean32, var32 = exact_mean.astype(np.float32), exact_var.astype(np.float32)
    rstd = (1 / np.sqrt(var32.astype(np.float64) + 1e-5)).astype(np.float32)
    inv = (rstd * rng.uniform(0.5, 1.5, C).astype(np.float32)).astype(np.float32)
    shift = (rng.normal(size=C).astype(np.float32) * np.float32(0.3) - mean32 * inv).astype(
        np.float32)
    pre = (x * inv).astype(np.float32) + shift
    on = pre > (2.0 ** -134 if dt == "bf16" else 0.0)
    g = np.where(on, dy, np.float32(0))
    xc = (x - mean32).astype(np.float32)
    gd, gxc = g.astype(np.float64), g.astype(np.float64) * xc.astype(np.float64)
    p17 = hg.plan_bn("bwd", N, HW, C, itemsize, True, n_sm)
    s = _model_sums(np.stack([gd, gxc], 1), p17, hg.BWD_UNROLL)
    exact = np.stack([gd.sum(0), gxc.sum(0)])
    assert (np.abs(s - exact).max(1) <= 1e-5 * np.maximum(np.abs(exact).max(1), 1)).all()

    def coefs(sums):
        cb = (inv.astype(np.float64) * sums[0] / M).astype(np.float32)
        cc = (inv.astype(np.float64) * rstd.astype(np.float64) ** 2 * sums[1] / M).astype(
            np.float32)
        return cb, cc

    assert all(np.array_equal(u, v) for u, v in zip(coefs(s), coefs(exact)))

    def dx_of(sums):
        cb, cc = coefs(sums)
        d = (inv * g).astype(np.float32)
        corr = (cb + (xc * cc).astype(np.float32)).astype(np.float32)
        mrow = np.repeat(real, HW)[:, None]
        d = np.where(mrow, (d - corr).astype(np.float32), d)
        return _bf16(d) if dt == "bf16" else d

    a, b = dx_of(s), dx_of(exact)
    tol = 1e-5 if dt == "f32" else 2.0 ** -8
    assert np.abs(a - b).max() <= tol * np.abs(b).max()
