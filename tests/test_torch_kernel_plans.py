"""Launch plans of kernels K1 and K15 on the CPU (no card needed).

`ops/roi.py` `plan_crop` and `solvers/pnp.py` `plan_ransac` are the launch
geometry the wrappers pass to `csrc/roi_crop.cu` and `csrc/pnp_ransac.cu`.
Each test walks the plan's grid as the kernel's index math does and checks
that every output pixel of K1, and every (hypothesis, point) pair of K15's
phases, is covered exactly once; the plans' constants are read from the
sources; shapes the kernels cannot take raise. Also: the exact early exit of
`cubick`'s Newton loop (mirrored in f32 numpy against the full trip count),
and the rule that a pointer passed as a plain int through a `c_void_p`
argtype keeps all 64 bits.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from suo_slam_tpu_torch.ops import roi
from suo_slam_tpu_torch.solvers import p3p, pnp

CSRC = Path(__file__).resolve().parents[1] / "suo_slam_tpu_torch" / "csrc"


def _consts(name):
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_crop_plan_mirrors_the_source():
    c = _consts("roi_crop.cu")
    assert c["kGenericThreads"] == roi.GENERIC_THREADS
    assert (c["kStrip"], c["kStripWarps"]) == (roi.STRIP_PIXELS, roi.STRIP_WARPS)


def _crop_cover(plan, n_box, oh, ow):
    """How many times the kernel's threads write each output pixel
    [n_box, oh, ow], walking `plan`'s grid with each path's index math."""
    gx, gy, gz = plan.grid
    bx, by, _ = plan.block
    hits = np.zeros((n_box, oh, ow), np.int64)
    bxi, byi, tx, ty = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(bx), np.arange(by),
                                   indexing="ij")
    if plan.path == roi.GENERIC:  # j = bx * 256 + tx, i = by
        i, js = byi, [bxi * bx + tx]
    else:  # warp w = tx / 32 owns row by * 8 + w; lane l owns p = k * 32 + l of strip bx
        i = byi * roi.STRIP_WARPS + tx // 32
        js = [bxi * roi.STRIP_PIXELS + k * 32 + tx % 32 for k in range(roi.STRIP_PIXELS // 32)]
    for j in js:
        keep = (i < oh) & (j < ow)
        for z in range(gz):
            np.add.at(hits[z], (i[keep], j[keep]), 1)
    return hits


@pytest.mark.parametrize("n_box,oh,ow,C", [(8, 256, 256, 3), (2, 33, 48, 3), (3, 17, 255, 3),
                                           (1, 5, 260, 3), (2, 9, 4, 3), (1, 7, 257, 1),
                                           (2, 6, 12, 4)])
def test_crop_plan_covers_each_pixel_once(n_box, oh, ow, C):
    vec = C == 3 and ow % 4 == 0
    default = roi.plan_crop(n_box, oh, ow, C)
    assert default.path == (roi.STRIP if vec else roi.GENERIC)
    paths = (roi.GENERIC, roi.STRIP) if vec else (roi.GENERIC,)
    for path in paths:
        plan = roi.plan_crop(n_box, oh, ow, C, True, path)
        assert plan.path == path and plan.grid[2] == n_box
        assert (_crop_cover(plan, n_box, oh, ow) == 1).all(), path
    # an unaligned output takes the generic path
    assert roi.plan_crop(n_box, oh, ow, C, False).path == roi.GENERIC


def test_crop_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="boxes"):
        roi.plan_crop(0, 256, 256, 3)
    with pytest.raises(ValueError, match="non-empty"):
        roi.plan_crop(8, 0, 256, 3)
    with pytest.raises(ValueError, match="65535"):
        roi.plan_crop(70000, 8, 8, 3)
    with pytest.raises(ValueError, match="65535"):
        roi.plan_crop(1, 70000, 8, 3, True, roi.GENERIC)
    for shape in ((4, 8, 8, 4), (4, 8, 6, 3)):
        with pytest.raises(ValueError, match="C = 3"):
            roi.plan_crop(*shape, True, roi.STRIP)
    with pytest.raises(ValueError, match="aligned"):
        roi.plan_crop(4, 8, 8, 3, False, roi.STRIP)
    with pytest.raises(ValueError, match="no path"):
        roi.plan_crop(4, 8, 8, 3, True, 7)


def test_ransac_plan_mirrors_the_source():
    c = _consts("pnp_ransac.cu")
    assert c["kThreads"] == pnp.K15_THREADS
    assert c["kPoseFloats"] == pnp.K15_POSE_FLOATS
    src = (CSRC / "pnp_ransac.cu").read_text()
    # the static shared memory: the centroid, scale and count, the two Gauss-Newton
    # warps' sums in two parities, a row of partial sums per lane, two counts
    for decl in ("float s_cs[5];", "float s_red[2][2][32];",
                 "float s_part[2][32 * kPartStride];", "int s_cnt3[2];"):
        assert f"__shared__ {decl}" in src
    assert c["kPartStride"] == 33
    assert pnp.K15_STATIC_SMEM == 4 * (5 + 2 * 2 * 32 + 2 * 32 * 33 + 2)
    phases = re.search(r"enum Phase \{([^}]*)\}", src).group(1)
    assert len([p for p in phases.split(",") if p.strip()]) == len(pnp.PNP_PHASES) + 1


@pytest.mark.parametrize("n_hyp", [1, 31, 64, 65, 128, 300])
@pytest.mark.parametrize("N", [0, 1, 4, 8, 41, 2048])
def test_ransac_plan_covers_each_pair_once(n_hyp, N):
    plan = pnp.plan_ransac(n_hyp, N)
    T, L = plan.threads, plan.lanes
    tid = np.arange(T)
    assert L in (1, 2, 4) and (L == 4 or n_hyp * L * 2 > T)
    assert plan.rounds == -(-n_hyp // (T // L))
    cand = np.zeros((n_hyp, 4), np.int64)
    pairs = np.zeros((n_hyp, N), np.int64)
    for r in range(plan.rounds):
        h = r * (T // L) + tid // L
        assert ((h // (32 // L)) == (r * (T // 32) + tid // 32)).all()  # a group within a warp
        for t in tid[h < n_hyp]:
            # P3P: lane q0 of the group solves candidates q0, q0 + L, ...
            cand[h[t], np.arange(t % L, 4, L)] += 1
            # counts: the same lane, points q0, q0 + L, ...
            pairs[h[t], np.arange(t % L, N, L)] += 1
    assert (cand == 1).all() and (pairs == 1).all()
    # Gauss-Newton and the final pass: lane l owns points l + 32 j, j < 64
    lanes = np.zeros(N, np.int64)
    for lane in range(32):
        own = np.arange(lane, N, 32)
        assert len(own) <= 64
        lanes[own] += 1
    assert (lanes == 1).all()
    assert plan.shared_bytes == 4 * (9 * N + (pnp.K15_POSE_FLOATS + 1) * n_hyp)


def test_ransac_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="hypothesis"):
        pnp.plan_ransac(0, 41)
    with pytest.raises(ValueError, match="at most 2048"):
        pnp.plan_ransac(64, 2049)
    most = (pnp.SMEM_PER_BLOCK - pnp.K15_STATIC_SMEM - 4 * 9 * 2048) // (4 * 13)
    assert pnp.plan_ransac(most, 2048).shared_bytes + pnp.K15_STATIC_SMEM <= pnp.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        pnp.plan_ransac(most + 1, 2048)


def _cubick_start(b, c, d):
    """`cubick`'s starting root in f32 numpy (`p3p._cubick` before its loop)."""
    f = np.float32
    third = f(1) / f(3)
    nz = lambda x, sign=1: f(sign * p3p.TINY) if abs(x) < p3p.TINY else x
    clamp0 = lambda x: x if np.isnan(x) else max(x, f(0))
    disc = b * b - f(3) * c
    v = np.sqrt(clamp0(disc))
    t1, t2 = (-b - v) * third, (-b + v) * third
    k1 = ((t1 + b) * t1 + c) * t1 + d
    k2 = ((t2 + b) * t2 + c) * t2 + d
    r_stat = (t1 - np.sqrt(clamp0(-k1 / nz(f(3) * t1 + b, -1))) if k1 > 0
              else t2 + np.sqrt(clamp0(-k2 / nz(f(3) * t2 + b))))
    r_mono = -b * third
    if abs((f(3) * r_mono + f(2) * b) * r_mono + c) < 1e-4:
        r_mono = r_mono + f(1)
    return f(r_stat if disc >= 0 else r_mono)


def _cubick_newton(b, c, d, early):
    """`cubick`'s Newton loop in f32 numpy from its start: the full trip
    count, or with the kernel's exit where a step returns to the iterate m
    <= 4 steps back. Returns (root, steps run)."""
    f = np.float32
    nz = lambda x: f(p3p.TINY) if abs(x) < p3p.TINY else x
    r = _cubick_start(b, c, d)
    hist = [r]  # r_0 .. r_it
    for it in range(p3p.CUBIC_ITERS):
        nxt = f(r - (((r + b) * r + c) * r + d) / nz((f(3) * r + f(2) * b) * r + c))
        for m in range(1, 5):
            if early and it + 1 - m >= 0 and nxt.view(np.int32) == hist[it + 1 - m].view(np.int32):
                base = it + 1 - m
                return hist[base + (p3p.CUBIC_ITERS - base) % m], it + 1
        hist.append(nxt)
        r = nxt
    return r, p3p.CUBIC_ITERS


# cubics of phase 3's front-end hypotheses whose Newton steps end in a 3- or
# 4-cycle (near double roots), and random ones
CYCLING = [(-4.6633234, 8.780538, -6.707132), (-1.7972151, 1.1222702, -0.24924867),
           (-4.5503554, 7.0680304, -3.7784243), (-2.614511, 2.27287, -0.65778863)]


def test_cubic_early_exit_equals_the_full_trip_count():
    """A Newton step is a function of r alone, so `cubick` stops at a
    repeated iterate (the step returns to the iterate 1-4 steps back) with
    the value the full trip count gives — bit for bit, in f32 numpy with the
    kernel's correctly rounded operations, on cubics that end in fixed
    points, 2-, 3- and 4-cycles and 2,000 random ones."""
    rng = np.random.default_rng(0)
    f = np.float32
    cases = [tuple(f(v) for v in bcd) for bcd in CYCLING]
    cases += [tuple(f(v) for v in rng.normal(size=3) * rng.choice([1e-2, 1.0, 1e2], 3))
              for _ in range(2000)]
    steps = []
    with np.errstate(all="ignore"):
        for k, (bk, ck, dk) in enumerate(cases):
            full, _ = _cubick_newton(bk, ck, dk, early=False)
            short, n = _cubick_newton(bk, ck, dk, early=True)
            assert short.view(np.int32) == full.view(np.int32), (k, bk, ck, dk)
            steps.append(n)
    assert max(steps[:len(CYCLING)]) < p3p.CUBIC_ITERS  # the cycles end early too
    assert np.median(steps) < 15


def test_plain_int_pointers_keep_64_bits_through_c_void_p():
    """The wrappers pass `data_ptr()` ints and the raw stream straight to
    entry points whose argtypes declare `c_void_p`: ctypes converts them to
    full 64-bit pointers (checked through a C callback)."""
    echo = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)(lambda p, n: p)
    for p in (0x7F12_3456_7890, 0xFFFF_FFFF_FFF0, (1 << 47) + 16):
        assert echo(p, 3) == p
    for argtypes in (roi._ARGTYPES, pnp._K15_ARGTYPES, pnp._K15_SERIAL_ARGTYPES):
        assert argtypes[:4] == [ctypes.c_void_p] * 4 and argtypes[-1] is ctypes.c_void_p
