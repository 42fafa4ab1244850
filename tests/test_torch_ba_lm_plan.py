"""The cluster design of kernel K14 (`csrc/ba_lm.cu`) on the CPU: its plan
and the arithmetic of its solves, mirrored in numpy f32 (every operation
rounds once, as the kernel's under --fmad=false).

- every capacity the engine reaches plans a cluster of at most 16 CTAs
  (8 where the card co-schedules no more), each owning at least one
  camera, in at most 227 KB of shared memory a CTA; the tracking path
  one CTA;
- the camera partition covers each camera exactly once, in rank order;
- the tracking path's warp-parallel camera solve (right-looking, the
  right-hand side as a seventh row) performs `chol6` + `cho_solve6`'s
  operations in their order: equal bit for bit;
- the global path's factor (right-looking, products with 1 / L_jj, the
  forward solve riding in column n) solves the reduced system.
"""

import numpy as np
import pytest

from suo_slam_tpu_torch.solvers import ba as tba

F = np.float32
CAPACITY_V = (1, 16, 32, 64, 128, 256)
CAPACITY_O = (8, 16, 32, 64)


@pytest.mark.parametrize("O", CAPACITY_O)
@pytest.mark.parametrize("V", CAPACITY_V)
def test_cluster_plan_fits_one_cta(V, O):
    for cap in (16, 8):
        plan = tba.plan_lm(V, O, max_cluster=cap)
        G = plan.cluster
        assert 1 <= G <= min(cap, V) and plan.threads == tba.LM_CLUSTER_THREADS
        per = -(-V // G)
        assert (G - 1) * per < V  # no rank without a camera
        assert plan.smem_bytes <= 4 * tba.LM_SMEM_FLOATS <= 227 * 1024 - 5 * 1024
        _, s, g = tba.lm_cluster_layout(V, O, G)
        assert plan.smem_bytes == 4 * s and plan.scratch_floats == max(1, G * g)
    if V >= 16:
        assert tba.plan_lm(V, O).cluster == 16


def _camera_partition(V, G):
    """The cameras each rank owns (`CView` in `csrc/ba_lm.cu`: rank r from
    r * cpr, cpr = ceil(V / G), nc = min(cpr, V - r * cpr))."""
    cpr = -(-V // G)
    return [range(r * cpr, r * cpr + max(0, min(cpr, V - r * cpr))) for r in range(G)]


@pytest.mark.parametrize("V", CAPACITY_V + (5, 40, 100))
def test_camera_partition_covers_each_camera_once_in_rank_order(V):
    for cap in (16, 8, 4, 1):
        G = tba.lm_cluster_size(V, cap)
        parts = _camera_partition(V, G)
        assert len(parts) == G and all(len(r) > 0 for r in parts)
        assert [v for r in parts for v in r] == list(range(V))


@pytest.mark.parametrize("V", CAPACITY_V)
def test_tracking_plans_one_cta(V):
    for O in CAPACITY_O:
        plan = tba.plan_lm(V, O, tracking=True)
        assert plan.cluster == 1 and plan.threads == tba.LM_TRACK_THREADS
        assert plan.smem_bytes <= 4 * tba.LM_SMEM_FLOATS
        inside = tba.lm_tracking_cams_in_smem(V, O)
        assert plan.smem_bytes == 4 * (tba.lm_tracking_fixed_floats(O)
                                       + (V * tba._LM_TCAM if inside else 0))
        assert plan.scratch_floats == (1 if inside else V * tba._LM_TCAM)


def _camera_system(rng, mc):
    """A camera's sums (Hcc upper, gc) as K4 forms them: a Gauss-Newton
    block of 20 random 2x6 Jacobian rows, and its gradient."""
    J = rng.normal(size=(40, 6)).astype(F) * F(30)
    H = (J.T @ J).astype(F)
    g = rng.normal(size=6).astype(F) * F(5)
    return H, g, F(mc)


def _damp_scale(H, g, mc, lam):
    """K7's `cams` stage for one camera: damped, masked, Jacobi-scaled, as
    `camera_block` forms each entry; then `chol6`'s sym(A)."""
    def dm(i, j):
        d = max(H[i, i], F(1e-9))
        x = F(H[i, j] + F(lam * d * F(i == j)))
        return F(F(x * mc) + F(F(F(1) - mc) * F(i == j)))
    s = [F(F(1) / np.sqrt(max(dm(i, i), F(1e-12)))) for i in range(6)]
    A = np.zeros((6, 6), F)
    for i in range(6):
        for j in range(6):
            A[i, j] = F(F(F(dm(i, j) * s[i]) * s[j]) + F(1e-9 if i == j else 0))
    S = np.array([[F(F(0.5) * F(A[i, j] + A[j, i])) for j in range(6)] for i in range(6)], F)
    b = np.array([-F(F(g[i] * mc) * s[i]) for i in range(6)], F)
    return S, b, s


def _chol6_solve(S, b):
    """`chol6` (left-looking) then `cho_solve6`, one rounding an operation."""
    L = np.zeros((6, 6), F)
    for j in range(6):
        d = S[j, j]
        for k in range(j):
            d = F(d - F(L[j, k] * L[j, k]))
        if not d > 0:
            return None
        L[j, j] = np.sqrt(d)
        for i in range(j + 1, 6):
            a = S[i, j]
            for k in range(j):
                a = F(a - F(L[i, k] * L[j, k]))
            L[i, j] = F(a / L[j, j])
    z = np.zeros(6, F)
    for i in range(6):
        a = b[i]
        for k in range(i):
            a = F(a - F(L[i, k] * z[k]))
        z[i] = F(a / L[i, i])
    x = np.zeros(6, F)
    for i in range(5, -1, -1):
        a = z[i]
        for k in range(i + 1, 6):
            a = F(a - F(L[k, i] * x[k]))
        x[i] = F(a / L[i, i])
    return x


def _warp_solve(S, b):
    """`warp_camera_step`'s order: lanes hold the 7 x 6 lower triangle
    [S; b^T]; column c divides its entries below the pivot by L_cc, then
    every entry (i, j), c < j <= i, subtracts L_ic L_jc (row 6: z_c L_jc);
    then `cho_solve6`'s backward half."""
    T = np.zeros((7, 6), F)
    T[:6] = np.tril(S)
    T[6] = b
    for c in range(6):
        d = T[c, c]
        if not d > 0:
            return None
        ljj = np.sqrt(d)
        for i in range(c + 1, 7):
            T[i, c] = F(T[i, c] / ljj)
        T[c, c] = ljj
        for i in range(c + 1, 7):
            for j in range(c + 1, min(i, 5) + 1):
                T[i, j] = F(T[i, j] - F(T[i, c] * T[j, c]))
    x = np.zeros(6, F)
    for i in range(5, -1, -1):
        a = T[6, i]
        for k in range(i + 1, 6):
            a = F(a - F(T[k, i] * x[k]))
        x[i] = F(a / T[i, i])
    return x


@pytest.mark.parametrize("seed", range(6))
def test_warp_camera_solve_is_chol6_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for mc, lam in ((1.0, 1e-5), (1.0, 4.0), (0.0, 1e-5)):
        H, g, m = _camera_system(rng, mc)
        S, b, _ = _damp_scale(H, g, m, F(lam))
        x1, x2 = _chol6_solve(S, b), _warp_solve(S, b)
        assert x1 is not None and x2 is not None
        assert x1.tobytes() == x2.tobytes()
    # a pivot that is not > 0: both refuse
    S = np.eye(6, dtype=F)
    S[3, 3] = F(-1)
    assert _chol6_solve(S, np.ones(6, F)) is None and _warp_solve(S, np.ones(6, F)) is None


def _chol_right(S, b):
    """`chol_right` on [S | b] (f32): column j reads the pivot, forms
    1 / L_jj once, each L_ij = S_ij * (1 / L_jj), subtracts L_ij L_kj from
    S[i][k] (k <= i) and L_ij z_j from b_i; then `back_solve_warp`."""
    n = S.shape[0]
    A = np.tril(S).astype(F)
    b = b.astype(F).copy()
    dg, z = np.zeros(n, F), np.zeros(n, F)
    for j in range(n):
        d = A[j, j]
        if not d > 0:
            return None
        ljj = np.sqrt(d)
        rl = F(F(1) / ljj)
        zj = F(b[j] * rl)
        col = (A[j + 1:, j] * rl).astype(F)
        A[j + 1:, j + 1:] -= np.tril(np.outer(col, col).astype(F))
        b[j + 1:] -= (col * zj).astype(F)
        A[j + 1:, j] = col
        dg[j], z[j] = ljj, zj
    x = np.zeros(n, F)
    for j in range(n - 1, -1, -1):
        x[j] = F(z[j] / dg[j])
        z[:j] -= (A[j, :j] * x[j]).astype(F)
    return x


@pytest.mark.parametrize("n", [48, 96])
def test_right_looking_reduced_solve(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(n, n))
    S = (M @ M.T + n * np.eye(n)).astype(F)
    b = rng.normal(size=n).astype(F)
    x = _chol_right(S, b)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    assert np.abs(x - ref).max() <= 1e-5 * np.abs(ref).max()
    bad = S.copy()
    bad[n // 2, n // 2] = F(-1e3)
    assert _chol_right(bad, b) is None
