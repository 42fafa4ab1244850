"""Batched closed-form P3P (LambdaTwist) and P4P in plain PyTorch.

Port of `suo_slam_tpu/solvers/p3p.py` (Persson & Nordberg, ECCV'18), the
plain version of kernel K3 (`csrc/pnp_hypotheses.cu`). Everything is written
per scalar component over arbitrary leading batch dimensions, with explicit
dot/cross/matrix products, so that the CUDA kernel — one thread per
hypothesis — runs the same operations in the same order: the branch-free
`where` masks, the fixed-trip `_cubick` Newton loop (CUBIC_ITERS), the
known-zero-eigenvalue eigendecomposition, the monotone lambda Gauss-Newton
(REFINE_ITERS) and the failure contract (identity pose, valid False).
"""

from __future__ import annotations

import torch

CUBIC_ITERS = 50
REFINE_ITERS = 5
TINY = 1e-30
# x / 3 is written x * (1/3): PyTorch's CUDA division by a Python scalar
# multiplies by its reciprocal, so this keeps the plain version identical on
# every device and lets K3 compute exactly the same thing.
THIRD = 1.0 / 3.0


def _nz(x, sign=1.0):
    """x with |x| < 1e-30 replaced by sign * 1e-30."""
    return torch.where(torch.abs(x) < TINY, sign * TINY, x)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _root2real(b, c):
    """Roots of x^2 + b x + c. Returns (r1, r2, real_mask); stable form."""
    v = b * b - 4.0 * c
    ok = v >= 0
    y = torch.sqrt(torch.clamp(v, min=0.0))
    denom_p = _nz(-b + y)
    denom_m = _nz(-b - y)
    r1 = torch.where(b < 0, 0.5 * (-b + y), 2.0 * c / denom_p)
    r2 = torch.where(b < 0, 0.5 * (-b - y), 2.0 * c / denom_m)
    return r1, r2, ok


def _cubick(b, c, d):
    """One real root of r^3 + b r^2 + c r + d (smart init + Newton)."""
    disc = b * b - 3.0 * c
    has_stat = disc >= 0
    v = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - v) * THIRD
    k1 = ((t1 + b) * t1 + c) * t1 + d
    t2 = (-b + v) * THIRD
    k2 = ((t2 + b) * t2 + c) * t2 + d
    r0_left = t1 - torch.sqrt(torch.clamp(-k1 / _nz(3.0 * t1 + b, -1.0), min=0.0))
    r0_right = t2 + torch.sqrt(torch.clamp(-k2 / _nz(3.0 * t2 + b), min=0.0))
    r0_stat = torch.where(k1 > 0, r0_left, r0_right)
    r0_mono = -b * THIRD
    dh = (3.0 * r0_mono + 2.0 * b) * r0_mono + c
    r0_mono = torch.where(torch.abs(dh) < 1e-4, r0_mono + 1.0, r0_mono)
    r = torch.where(has_stat, r0_stat, r0_mono)
    for _ in range(CUBIC_ITERS):
        fx = ((r + b) * r + c) * r + d
        fpx = _nz((3.0 * r + 2.0 * b) * r + c)
        r = r - fx / fpx
    return r


def _eig_with_known_0(A00, A01, A02, A11, A12, A22):
    """Eigenpairs of a symmetric 3x3 with one known zero eigenvalue.

    Returns the two nonzero eigenvalues (|e1| >= |e2|) and their unit
    eigenvectors v1, v2 (3-tuples); the null vector is not needed by P3P."""
    x01_sq = A01 * A01
    b = -A00 - A11 - A22
    c = -x01_sq - A02 * A02 - A12 * A12 + A00 * (A11 + A22) + A11 * A22
    e1, e2, _ = _root2real(b, c)
    swap = torch.abs(e1) < torch.abs(e2)
    e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)
    mx0011 = -A00 * A11
    prec_0 = A01 * A12 - A02 * A11
    prec_1 = A01 * A02 - A00 * A12

    def eigvec(e):
        tmp_d = e * (A00 + A11) + mx0011 - e * e + x01_sq
        tmp = 1.0 / _nz(tmp_d)
        a1 = -(e * A02 + prec_0) * tmp
        a2 = -(e * A12 + prec_1) * tmp
        rnorm = 1.0 / torch.sqrt(a1 * a1 + a2 * a2 + 1.0)
        return (a1 * rnorm, a2 * rnorm, rnorm)

    return e1, e2, eigvec(e1), eigvec(e2)


def _gauss_newton_refine_L(l1, l2, l3, a12, a13, a23, b12, b13, b23,
                           iters: int = REFINE_ITERS):
    """Polish lambda on the 3 distance constraints, accepting a step only if
    it does not raise sum |residual|."""

    def residuals(l1, l2, l3):
        return (l1 * l1 + l2 * l2 + b12 * l1 * l2 - a12,
                l1 * l1 + l3 * l3 + b13 * l1 * l3 - a13,
                l2 * l2 + l3 * l3 + b23 * l2 * l3 - a23)

    for _ in range(iters):
        r1, r2, r3 = residuals(l1, l2, l3)
        dr1dl1 = 2.0 * l1 + b12 * l2
        dr1dl2 = 2.0 * l2 + b12 * l1
        dr2dl1 = 2.0 * l1 + b13 * l3
        dr2dl3 = 2.0 * l3 + b13 * l1
        dr3dl2 = 2.0 * l2 + b23 * l3
        dr3dl3 = 2.0 * l3 + b23 * l2
        det_d = -dr1dl1 * dr2dl3 * dr3dl2 - dr1dl2 * dr2dl1 * dr3dl3
        det = 1.0 / _nz(det_d)
        s1 = -dr2dl3 * dr3dl2 * r1 + -dr1dl2 * dr3dl3 * r2 + dr1dl2 * dr2dl3 * r3
        s2 = -dr2dl1 * dr3dl3 * r1 + dr1dl1 * dr3dl3 * r2 + -dr1dl1 * dr2dl3 * r3
        s3 = dr2dl1 * dr3dl2 * r1 + -dr1dl1 * dr3dl2 * r2 + -dr1dl2 * dr2dl1 * r3
        n1, n2, n3 = l1 - det * s1, l2 - det * s2, l3 - det * s3
        q1, q2, q3 = residuals(n1, n2, n3)
        better = (torch.abs(q1) + torch.abs(q2) + torch.abs(q3)
                  <= torch.abs(r1) + torch.abs(r2) + torch.abs(r3))
        l1 = torch.where(better, n1, l1)
        l2 = torch.where(better, n2, l2)
        l3 = torch.where(better, n3, l3)
    return l1, l2, l3


def p3p(y: torch.Tensor, x: torch.Tensor):
    """P3P for a batch of triples.

    y: [..., 3, 3] bearing vectors (rows, any scale); x: [..., 3, 3] 3D
    points (rows). Returns Rs [..., 4, 3, 3], ts [..., 4, 3], valid [..., 4]
    with lambda_i y_i = R x_i + t; invalid slots hold identity poses."""
    dtype = torch.promote_types(y.dtype, x.dtype)
    y = y.to(dtype)
    x = x.to(dtype)
    Y = [[y[..., i, j] for j in range(3)] for i in range(3)]
    X = [[x[..., i, j] for j in range(3)] for i in range(3)]

    def unit(a):
        n = torch.sqrt(_dot3(a, a))
        return (a[0] / n, a[1] / n, a[2] / n)

    y1, y2, y3 = unit(Y[0]), unit(Y[1]), unit(Y[2])
    b12 = -2.0 * _dot3(y1, y2)
    b13 = -2.0 * _dot3(y1, y3)
    b23 = -2.0 * _dot3(y2, y3)
    d12 = tuple(X[0][k] - X[1][k] for k in range(3))
    d13 = tuple(X[0][k] - X[2][k] for k in range(3))
    d23 = tuple(X[1][k] - X[2][k] for k in range(3))
    d12xd13 = _cross3(d12, d13)
    a12 = _dot3(d12, d12)
    a13 = _dot3(d13, d13)
    a23 = _dot3(d23, d23)

    # cubic for gamma
    c31 = -0.5 * b13
    c23 = -0.5 * b23
    c12 = -0.5 * b12
    blob = c12 * c23 * c31 - 1.0
    s31_sq = 1.0 - c31 * c31
    s23_sq = 1.0 - c23 * c23
    s12_sq = 1.0 - c12 * c12
    p3 = a13 * (a23 * s31_sq - a13 * s23_sq)
    p2 = 2.0 * blob * a23 * a13 + a13 * (2.0 * a12 + a13) * s23_sq + a23 * (a23 - a12) * s31_sq
    p1 = a23 * (a13 - a23) * s12_sq - a12 * a12 * s23_sq - 2.0 * a12 * (blob * a23 + a13 * s23_sq)
    p0 = a12 * (a12 * s23_sq - a23 * s12_sq)
    ip3 = 1.0 / _nz(p3)
    g = _cubick(p2 * ip3, p1 * ip3, p0 * ip3)

    # conic pencil at gamma
    A00 = a23 * (1.0 - g)
    A01 = (a23 * b12) * 0.5
    A02 = (a23 * b13 * g) * (-0.5)
    A11 = a23 - a12 + a13 * g
    A12 = b23 * (a13 * g - a12) * 0.5
    A22 = g * (a13 - a23) - a12
    e1, e2, v1, v2 = _eig_with_known_0(A00, A01, A02, A11, A12, A22)
    L0 = _nz(e1)
    v = torch.sqrt(torch.clamp(-e2 / L0, min=0.0))

    def branch(s):
        w2 = 1.0 / _nz(s * v2[0] - v1[0])
        w0 = (v1[1] - s * v2[1]) * w2
        w1 = (v1[2] - s * v2[2]) * w2
        a = 1.0 / _nz((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12)
        b = (a13 * b12 * w1 - a12 * b13 * w0 - 2.0 * w0 * w1 * (a12 - a13)) * a
        c = ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13) * a
        tau1, tau2, real = _root2real(b, c)

        def lam_for(tau):
            tau_ok = tau > 0
            tau_safe = torch.where(tau_ok, tau, 1.0)
            d_ = a23 / (tau_safe * (b23 + tau_safe) + 1.0)
            l2 = torch.sqrt(torch.clamp(d_, min=0.0))
            l3 = tau_safe * l2
            l1 = w0 * l2 + w1 * l3
            return (l1, l2, l3), real & tau_ok & (d_ > 0) & (l1 >= 0)

        return lam_for(tau1), lam_for(tau2)

    cands = [*branch(v), *branch(-v)]

    # absolute orientation: R [d12 d13 d12xd13] = [yd1 yd2 yd1xyd2], with the
    # closed-form adjugate inverse of X = [d12 | d13 | d12xd13] (columns)
    Xr = [(d12[i], d13[i], d12xd13[i]) for i in range(3)]  # rows of X
    c0 = _cross3(Xr[1], Xr[2])
    c1 = _cross3(Xr[2], Xr[0])
    c2 = _cross3(Xr[0], Xr[1])
    idet = 1.0 / _nz(_dot3(Xr[0], c0))
    Xinv = [[c0[i] * idet, c1[i] * idet, c2[i] * idet] for i in range(3)]

    Rs, ts, valid = [], [], []
    for (l1, l2, l3), ok in cands:
        l1, l2, l3 = _gauss_newton_refine_L(l1, l2, l3, a12, a13, a23, b12, b13, b23)
        ry1 = tuple(y1[k] * l1 for k in range(3))
        ry2 = tuple(y2[k] * l2 for k in range(3))
        ry3 = tuple(y3[k] * l3 for k in range(3))
        yd1 = tuple(ry1[k] - ry2[k] for k in range(3))
        yd2 = tuple(ry1[k] - ry3[k] for k in range(3))
        yd1xd2 = _cross3(yd1, yd2)
        Yr = [(yd1[i], yd2[i], yd1xd2[i]) for i in range(3)]  # rows of Y
        R = [[Yr[i][0] * Xinv[0][j] + Yr[i][1] * Xinv[1][j] + Yr[i][2] * Xinv[2][j]
              for j in range(3)] for i in range(3)]
        t = [ry1[i] - (R[i][0] * X[0][0] + R[i][1] * X[0][1] + R[i][2] * X[0][2])
             for i in range(3)]
        Rm = torch.stack([torch.stack(R[i], -1) for i in range(3)], -2)
        tv = torch.stack(t, -1)
        finite = (torch.isfinite(Rm).flatten(-2).all(-1)
                  & torch.isfinite(tv).all(-1))
        ok = ok & finite
        eye = torch.eye(3, dtype=dtype, device=y.device)
        Rs.append(torch.where(ok[..., None, None], Rm, eye))
        ts.append(torch.where(ok[..., None], tv, 0.0))
        valid.append(ok)
    return torch.stack(Rs, -3), torch.stack(ts, -2), torch.stack(valid, -1)


def p4p(y4: torch.Tensor, x4: torch.Tensor):
    """P3P on points 0..2 disambiguated by point 3.

    y4: [..., 4, 2] pinhole-normalized image points; x4: [..., 4, 3].
    Returns (T [..., 4, 4], err [...] squared reprojection error of the 4th
    point, valid [...]); identity + inf on failure."""
    dtype = torch.promote_types(y4.dtype, x4.dtype)
    y4 = y4.to(dtype)
    x4 = x4.to(dtype)
    ones = torch.ones(y4.shape[:-2] + (3, 1), dtype=dtype, device=y4.device)
    Rs, ts, valid = p3p(torch.cat([y4[..., :3, :], ones], -1), x4[..., :3, :])
    xq = [x4[..., 3, k][..., None] for k in range(3)]  # broadcast over the 4 candidates
    yq = (y4[..., 3, 0][..., None], y4[..., 3, 1][..., None])
    xr = [Rs[..., i, 0] * xq[0] + Rs[..., i, 1] * xq[1] + Rs[..., i, 2] * xq[2]
          + ts[..., i] for i in range(3)]
    z_ok = xr[2] > 0
    iz = 1.0 / _nz(xr[2])
    du = xr[0] * iz - yq[0]
    dv = xr[1] * iz - yq[1]
    e = du * du + dv * dv
    # orthonormality sanity: max |R^T R - I| < 1e-2
    dev = torch.zeros_like(e)
    for i in range(3):
        for j in range(3):
            rtr = (Rs[..., 0, i] * Rs[..., 0, j] + Rs[..., 1, i] * Rs[..., 1, j]
                   + Rs[..., 2, i] * Rs[..., 2, j])
            dev = torch.maximum(dev, torch.abs(rtr - (1.0 if i == j else 0.0)))
    good = valid & z_ok & (dev < 1e-2) & torch.isfinite(e)
    errs = torch.where(good, e, torch.inf)
    i = torch.argmin(errs, dim=-1, keepdim=True)  # first minimum
    err = torch.gather(errs, -1, i)[..., 0]
    best_ok = torch.isfinite(err)
    R = torch.gather(Rs, -3, i[..., None, None].expand(i.shape[:-1] + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, i[..., None].expand(i.shape[:-1] + (1, 3)))[..., 0, :]
    eye = torch.eye(3, dtype=dtype, device=y4.device)
    R = torch.where(best_ok[..., None, None], R, eye)
    t = torch.where(best_ok[..., None], t, 0.0)
    T = torch.eye(4, dtype=dtype, device=y4.device).repeat(R.shape[:-2] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T, err, best_ok
