"""Kernels K1-K15 against their plain PyTorch versions on the card.

Marked `cuda`: they skip where no CUDA device exists (a CUDA kernel has no
CPU mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

(`--noconftest`: tests/conftest.py configures JAX, which that machine need
not have; this file imports only the port.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from suo_slam_tpu_torch import _device
    from suo_slam_tpu_torch.kernels import build_all

    d = _device.resolve_device("cuda")
    build_all()
    return d


def test_k1_roi_crop(dev):
    from suo_slam_tpu_torch.ops import roi

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)).to(dev)
    boxes = torch.tensor([[[4.0, 6.0, 60.5, 40.25], [-30.0, -12.0, 20.0, 15.0],
                           [float("nan"), 3.0, 20.0, 30.0]]] * 2, device=dev)
    mask = torch.tensor([[True, True, True], [True, False, True]], device=dev)
    k = roi.roi_crop_batch(img, boxes, mask, (32, 48))
    p = roi.roi_crop_batch_plain(img, boxes, mask, (32, 48))
    assert (k - p).abs().max().item() <= 1e-5
    assert not k[1, 1].any()


def test_k2_heatmap_readout(dev):
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = torch.randn(3, 41, 64, 64, device=dev).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    for view in (x, x.transpose(1, 2)):
        for a, b in zip(hm.heatmap_readout(view), hm.heatmap_readout_plain(view)):
            assert (a - b).abs().max().item() <= 1e-5


def test_k3_pnp_hypotheses(dev):
    from suo_slam_tpu_torch.solvers import pnp

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(4, 41, 3, device=dev, generator=g) * 2 - 1
    y = torch.rand(4, 41, 2, device=dev, generator=g) * 0.2 - 0.1
    mask = torch.rand(4, 41, device=dev, generator=g) < 0.7
    idx = pnp.sample_hypothesis_indices(mask, 64, g)
    Tk, okk, ck = pnp.pnp_hypotheses(x, y, mask, idx, 1e-3)
    Tp, okp, cp = pnp.pnp_hypotheses_plain(x, y, mask, idx, 1e-3)
    assert torch.equal(okk, okp)
    assert torch.equal(ck, cp)
    both = okk & okp
    assert (Tk - Tp).abs().amax(dim=(-2, -1))[both].max().item() <= 1e-4
    # an index outside the point set fails that hypothesis alone
    bad = idx.clone()
    bad[0, 0, 1] = 41
    bad[1, 0, 2] = -1
    Tb, okb, cb = pnp.pnp_hypotheses(x, y, mask, bad, 1e-3)
    assert not okb[0, 0] and not okb[1, 0] and cb[0, 0] == -1 and cb[1, 0] == -1
    assert torch.equal(Tb[0, 0], torch.eye(4, device=dev))
    assert torch.equal(cb[:, 1:], ck[:, 1:])


def test_k4_ba_edges(dev):
    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.solvers import ba

    g = torch.Generator(device=dev).manual_seed(1)
    V, O, K = 4, 3, 41
    cam_T = lie.se3_exp(torch.randn(V, 6, device=dev, generator=g) * 0.05)
    obj_T = lie.se3_exp(torch.randn(O, 6, device=dev, generator=g) * 0.3)
    obj_T[:, 2, 3] += 8.0
    uv = torch.rand(V, O, K, 2, device=dev, generator=g) * 0.4 - 0.2
    info = torch.eye(2, device=dev).expand(V, O, K, 2, 2) * 1e4
    model_kp = torch.rand(O, K, 3, device=dev, generator=g) - 0.5
    cam_k = torch.tensor([2.0, 2.0, 0.0, 0.0], device=dev).expand(V, O, 4).contiguous()
    inl = torch.rand(V, O, K, device=dev, generator=g) < 0.8
    args = (cam_T, obj_T, uv, info, model_kp, cam_k)
    Hk, gk, ck, zk = ba._edge_planes_Hg(*args, inl=inl, use_huber=True, huber_d=ba.HUBER_DELTA)
    Hp, gp, cp, zp = ba._edge_planes_Hg_plain(*args, inl, True, ba.HUBER_DELTA)
    from chip_smoke import k4_scaled_errors

    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    sH, sg = k4_scaled_errors(Hk, gk, Hp, gp, cp, inl, ba.HUBER_DELTA)
    assert sH <= 1e-4 and sg <= 1e-4 and rel(ck, cp) <= 1e-5
    assert rel(ba._edge_chi2(*args), ba._edge_chi2_plain(*args)) <= 1e-5


def test_k5_prior_render(dev):
    from suo_slam_tpu_torch.ops import heatmap as hm

    g = torch.Generator(device=dev).manual_seed(2)
    uv = torch.rand(8, 41, 2, device=dev, generator=g) * 2.4 - 1.2
    uv[0, 0, 0] = float("nan")
    uv[0, 1, 1] = float("inf")
    mask = torch.rand(8, 41, device=dev, generator=g) < 0.7
    for hw in ((64, 64), (256, 256)):
        k = hm.render_prior_heatmaps(uv, mask, hw, hm.prior_sigma_for(hw))
        p = hm.render_prior_heatmaps_plain(uv, mask, hw, hm.prior_sigma_for(hw))
        assert k.is_contiguous() and k.shape == p.shape
        assert (k - p).abs().max().item() <= 1e-6
        assert not k[0, ..., :2].any()


def _ransac_problem(dev, g, S=8, M=1):
    from suo_slam_tpu_torch.core import lie

    O, K = 8, 41
    T = lie.se3_exp(torch.randn(S, O, 6, device=dev, generator=g) * 0.05)
    T[..., 2, 3] += 8.0
    model_kp = torch.rand(O, K, 3, device=dev, generator=g) - 0.5
    uv = (model_kp[..., :2] / 8.0 * 2.0)[None].expand(M, O, K, 2).contiguous()
    uv = uv + torch.randn(M, O, K, 2, device=dev, generator=g) * 0.01
    info = (torch.eye(2, device=dev) * 1e4).expand(M, O, K, 2, 2).contiguous()
    mask = torch.rand(M, O, K, device=dev, generator=g) < 0.8
    cam_k4 = torch.tensor([2.0, 2.0, 0.0, 0.0], device=dev).expand(M, O, 4).contiguous()
    return T, model_kp, uv, info, mask, cam_k4


def test_k6_chi2_counts(dev):
    from suo_slam_tpu_torch.slam import kernels as sk

    g = torch.Generator(device=dev).manual_seed(3)
    for S, M, per_object in ((8, 1, False), (30, 15, True)):
        args = _ransac_problem(dev, g, S, M)
        k = sk.chi2_counts(*args, per_object=per_object)
        p = sk.chi2_counts_plain(*args, per_object=per_object)
        assert torch.equal(k, p)
        assert 0 < int(k.min()) and int(k.max()) < args[4].sum()


def test_k7_ba_schur(dev):
    from chip_smoke import k7_scaled_errors
    from suo_slam_tpu_torch.solvers import ba

    g = torch.Generator(device=dev).manual_seed(4)
    V, O = 6, 4
    J = torch.randn(V, O, 40, 12, device=dev, generator=g)
    H = torch.einsum("voki,vokj->voij", J, J)
    gv = torch.randn(V, O, 12, device=dev, generator=g)
    blocks = (H[..., :6, :6].sum(1), H[..., 6:, 6:].sum(0), H[..., :6, 6:].contiguous(),
              gv[..., :6].sum(1), gv[..., 6:].sum(0))
    lam = torch.tensor(1e-3, device=dev)
    cam_free = torch.tensor([False, True, True, True, False, True], device=dev)
    for obj_free in (torch.tensor([True, False, True, True], device=dev),
                     torch.zeros(O, dtype=torch.bool, device=dev)):
        frozen = not bool(obj_free.any())
        k = ba._solve_normal_eq_schur(*blocks, cam_free, obj_free, lam, objects_frozen=frozen)
        p = ba._solve_normal_eq_schur_plain(*blocks, cam_free, obj_free, lam)
        assert bool(k[2]) == bool(p[2]) is True
        assert max(k7_scaled_errors(k, p)) <= 1e-4
    bad = blocks[0].clone()
    bad[1] = -torch.eye(6, device=dev)
    k = ba._solve_normal_eq_schur(bad, *blocks[1:], cam_free, obj_free, lam)
    assert not bool(k[2]) and not k[0].any() and not k[1].any()


def test_k8_norm_relu(dev):
    """f32 equal, bf16 within 1 ulp of bf16 (measured equal); vector and
    scalar paths (C % 8 and not)."""
    from suo_slam_tpu_torch.models import hourglass as hg

    g = torch.Generator(device=dev).manual_seed(5)
    for C in (64, 256, 6):
        x = torch.randn(4, C, 16, 16, device=dev, generator=g).contiguous(
            memory_format=torch.channels_last)
        inv = torch.rand(C, device=dev, generator=g) + 0.5
        shift = torch.randn(C, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            k = hg.norm_relu(xd, inv, shift)
            p = hg.norm_relu_plain(xd, inv, shift)
            assert k.dtype == dt and k.is_contiguous(memory_format=torch.channels_last)
            ulp = 0.0 if dt == torch.float32 else 2.0 ** -7
            err = ((k.float() - p.float()).abs() / p.float().abs().clamp(min=1e-30))
            assert torch.equal(k == 0, p == 0) and float(err.max()) <= ulp
    with pytest.raises(ValueError, match="channels_last"):
        hg.norm_relu(torch.randn(2, 8, 4, 4, device=dev), inv[:8], shift[:8])


def test_k9_upsample_add(dev):
    from suo_slam_tpu_torch.models import hourglass as hg

    g = torch.Generator(device=dev).manual_seed(6)
    for C, H in ((256, 16), (5, 8)):
        up1 = torch.randn(3, C, H, H, device=dev, generator=g).contiguous(
            memory_format=torch.channels_last)
        low = torch.randn(3, C, H // 2, H // 2, device=dev, generator=g).contiguous(
            memory_format=torch.channels_last)
        for dt in (torch.float32, torch.bfloat16):
            k = hg.upsample_add(up1.to(dt), low.to(dt))
            p = hg.upsample_add_plain(up1.to(dt), low.to(dt))
            assert k.dtype == dt and torch.equal(k, p)


def test_k10_add_dists(dev):
    """Per-point distances equal to the plain version's, means within 1e-6
    relative; padded rows, n = 0 and P not a multiple of the tiles."""
    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.eval import meter

    g = torch.Generator(device=dev).manual_seed(7)
    for B, P in ((1, 4096), (5, 700)):
        pts = (torch.rand(B, P, 3, device=dev, generator=g) - 0.5) * 100
        n = torch.randint(1, P + 1, (B,), device=dev, generator=g).to(torch.int32)
        n[0] = P
        if B > 1:
            n[1] = 0
        Tg = lie.se3_exp(torch.randn(B, 6, device=dev, generator=g) * 0.3)
        Tg[:, 2, 3] += 800.0
        Tp = lie.se3_exp(torch.randn(B, 6, device=dev, generator=g) * 0.01) @ Tg
        k = meter._add_dists_cuda(pts, n, Tp, Tg, per_point=True)
        p = meter.add_dists_plain(pts, n, Tp, Tg, per_point=True)
        assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
        for a, b in zip(k[:2], p[:2]):
            assert float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) <= 1e-6


def test_k2_heatmap_readout_bf16(dev):
    """bf16 logits (the int8 engine's head): the shift rounds to bf16 in both."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    g = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn(3, 41, 64, 64, device=dev, generator=g) * 4).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    for view in (x, x.transpose(1, 2)):
        for a, b in zip(hm.heatmap_readout(view), hm.heatmap_readout_plain(view)):
            assert a.dtype == torch.float32 and (a - b).abs().max().item() <= 1e-5


def _qconv(dev, cin, cout, k, stride=1):
    from suo_slam_tpu_torch.models import int8_forward as i8

    conv = torch.nn.Conv2d(cin, cout, k, stride, k // 2)
    return i8.quantize_conv(conv.to(dev), 0, dev)


def test_k11_int8_conv(dev):
    """Equal bf16 bits and s8 codes at the engine's kinds of shape, on both
    routes: 1x1 and 3x3 at every hourglass width (64, 32, 16, 8, 4; the small
    levels' tiles span several images) and at 128x128, Cout 41 (a partial N
    tile, 82-byte bf16 rows), Cin 41 padded to 48 (a 64-byte channel box with
    a zero-filled tail), pixels not a multiple of the tile (5x5, 9x9), the
    concat stem's 7x7 stride-2 prior convolution (the mma.sync route), and a
    3x3 128->128 at 128 crops of 64x64."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(9)
    cases = [(128, 256, 1, 1, 16, 2), (128, 128, 3, 1, 16, 2), (256, 41, 1, 1, 9, 2),
             (41, 64, 7, 2, 32, 2), (64, 64, 3, 1, 5, 2), (48, 256, 1, 1, 16, 3),
             (64, 64, 3, 1, 128, 1), (64, 128, 1, 1, 128, 1), (128, 128, 3, 1, 64, 128)]
    cases += [(cin, cout, k, 1, hw, 8) for hw in (64, 32, 16, 8, 4)
              for cin, cout, k in ((256, 128, 1), (128, 128, 3), (128, 256, 1))]
    routes = set()
    for cin, cout, k, stride, hw, n in cases:
        qc = _qconv(dev, cin, cout, k, stride)
        x = torch.randint(-127, 128, (n, hw, hw, cin), device=dev, generator=g,
                          dtype=torch.int32).to(torch.int8)
        if cin % ik.CIN_ALIGN:  # as K12 writes it: zero channels up to Cin_p
            x = torch.nn.functional.pad(x, (0, ik.padded(cin) - cin))
        e1 = (torch.rand(cout, device=dev, generator=g) * 1e-3).to(torch.bfloat16).float()
        e2 = torch.randn(cout, device=dev, generator=g).to(torch.bfloat16).float()
        routes.add(ik.plan_conv(n, hw, hw, qc.wq.shape[-1], cout, k, k, stride, k // 2).route)
        for out_s8 in (False, True):
            a = ik.int8_conv(x, qc, e1, e2, out_s8)
            b = ik.int8_conv_plain(x, qc, e1, e2, out_s8)
            torch.cuda.synchronize()
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (
                cin, cout, k, hw, n, out_s8)
    assert routes == {"wgmma", "mma_sync"}


def test_k12_int8_quant(dev):
    """Equal codes for f32, bf16 and s8 inputs, per-tensor and per-channel
    divisors, raw, normalised and both outputs; every prologue (one or two
    s8 operands, a bf16 tensor or [C] vector addend) and the padded output
    (41 channels written 48 wide, f32 and bf16 input)."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(10)
    C = 48
    x32 = torch.randn(2, 7, 9, C, device=dev, generator=g) * 3
    codes = torch.randint(-127, 128, (2, 7, 9, C), device=dev, generator=g,
                          dtype=torch.int32).to(torch.int8)
    for x in (x32, x32.to(torch.bfloat16), codes):
        dt = torch.bfloat16 if x.dtype != torch.float32 else torch.float32
        r = lambda t: t.to(dt).float()
        m = r(torch.randn(C, device=dev, generator=g) * 20)
        c = r(torch.randn(C, device=dev, generator=g) * 5)
        for div in (r(torch.full((C,), 0.021, device=dev)), r(torch.rand(C, device=dev,
                                                                           generator=g) + 0.01)):
            for args in ((div,), (div, m, c), (None, m, c)):
                if x.dtype == torch.int8 and args[0] is not None:
                    continue
                for a, b in zip(ik.int8_quant(x, *args), ik.int8_quant_plain(x, *args)):
                    assert (a is None) == (b is None)
                    assert a is None or torch.equal(a, b), (x.dtype, len(args))
    bf = lambda t: t.to(torch.bfloat16).float()
    for C, shape in ((256, (8, 16, 16)), (48, (2, 7, 9)), (128, (3, 5, 5))):
        q1, q2 = (torch.randint(-127, 128, shape + (C,), device=dev, generator=g,
                                dtype=torch.int32).to(torch.int8) for _ in range(2))
        s1 = bf(torch.rand(C, device=dev, generator=g) * 0.05 + 0.001)
        s2 = bf(torch.full((C,), 0.02, device=dev))
        t = (torch.randn(shape + (C,), device=dev, generator=g) * 2).to(torch.bfloat16)
        v = bf(torch.randn(C, device=dev, generator=g))
        div = bf(torch.rand(C, device=dev, generator=g) * 0.05 + 0.01)
        m = bf(torch.randn(C, device=dev, generator=g) * 20)
        c = bf(torch.randn(C, device=dev, generator=g) * 5)
        for kw in (dict(), dict(add=t), dict(add=v), dict(x2=ik.Deq(q2, s2)),
                   dict(x2=ik.Deq(q2, s2), add=t)):
            for args in ((div,), (div, m, c)):
                a = ik.int8_quant(ik.Deq(q1, s1), *args, **kw)
                b = ik.int8_quant_plain(ik.Deq(q1, s1), *args, **kw)
                torch.cuda.synchronize()
                for u, w in zip(a, b):
                    assert (u is None) == (w is None)
                    assert u is None or torch.equal(u, w), (C, sorted(kw), len(args))
    for x in (torch.rand(8, 64, 64, 41, device=dev, generator=g),
              (torch.randn(8, 64, 64, 41, device=dev, generator=g) * 3).to(torch.bfloat16)):
        div = torch.full((41,), 1 / 127, device=dev).to(x.dtype).float()
        a, _ = ik.int8_quant(x, div, c_out=48)
        b, _ = ik.int8_quant_plain(x, div, c_out=48)
        torch.cuda.synchronize()
        assert a.shape == (8, 64, 64, 48) and torch.equal(a, b) and not a[..., 41:].any()


def test_k13_int8_pool_junction(dev):
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(11)
    for C, H in ((256, 16), (128, 8), (4, 2)):
        x = torch.randint(-128, 128, (3, H, H, C), device=dev, generator=g,
                          dtype=torch.int32).to(torch.int8)
        assert torch.equal(ik.int8_maxpool(x), ik.int8_maxpool_plain(x))
        low = x[:, : H // 2, : H // 2].contiguous()
        e_up = (torch.rand(C, device=dev, generator=g) * 0.1).to(torch.bfloat16).float()
        e_low = torch.full((C,), 0.03, device=dev).to(torch.bfloat16).float()
        a = ik.int8_upsample_add(x, low, e_up, e_low)
        b = ik.int8_upsample_add_plain(x, low, e_up, e_low)
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _lm_arrays(V, O, n_views, n_objs, seed, K=41):
    """A pose graph at the engine's shapes, numpy only: n_views cameras on a
    ~0.2 rad arc 600 mm from n_objs objects (16 of K keypoints each, in a
    100 mm cube), NDC measurements with N(0, 0.003) noise and 5% outliers,
    info 1e4 I, cameras after the first and the objects 1-2 mm off; the
    rest of the V x O capacity inactive."""
    rng = np.random.default_rng(seed)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        i, j = [(1, 2), (2, 0), (0, 1)][axis]
        R = np.eye(3)
        R[i, i] = R[j, j] = c
        R[i, j], R[j, i] = -s, s
        return R

    obj_T = np.tile(np.eye(4), (O, 1, 1))
    model_kp = np.zeros((O, K, 3))
    valid_kp = np.zeros((O, K), bool)
    for o in range(n_objs):
        obj_T[o, :3, :3] = rot(0, rng.uniform(-3, 3)) @ rot(1, rng.uniform(-3, 3))
        obj_T[o, :3, 3] = rng.uniform(-120, 120, 3) * [1, 1, 0.3] + [0, 0, 600]
        ch = rng.choice(K, 16, replace=False)
        valid_kp[o, ch] = True
        model_kp[o, ch] = rng.uniform(-50, 50, (16, 3))
    cam_T = np.tile(np.eye(4), (V, 1, 1))
    for v in range(n_views):
        a = 0.2 * v / max(n_views - 1, 1)
        c = np.array([0, 0, 600.0])
        cam_T[v, :3, :3] = rot(1, a)
        cam_T[v, :3, 3] = c - rot(1, a) @ c + rng.normal(size=3)
    uv = np.zeros((V, O, K, 2))
    valid = np.zeros((V, O, K), bool)
    for v in range(n_views):
        for o in range(n_objs):
            p = (cam_T[v] @ obj_T[o])[:3, :3] @ model_kp[o].T + (cam_T[v] @ obj_T[o])[:3, 3:]
            uv[v, o] = 2.0 * (p[:2] / p[2]).T + rng.normal(scale=0.003, size=(K, 2))
            valid[v, o] = valid_kp[o]
    out = rng.uniform(size=(V, O, K)) < 0.05
    uv[out] += rng.uniform(-0.3, 0.3, size=(int(out.sum()), 2))
    cam_T[1:n_views, :3, 3] += rng.normal(scale=1.0, size=(n_views - 1, 3))
    obj_T[:n_objs, :3, 3] += rng.normal(scale=2.0, size=(n_objs, 3))
    cam_active = np.zeros(V, bool)
    cam_active[:n_views] = True
    obj_active = np.zeros(O, bool)
    obj_active[:n_objs] = True
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    cam_k = np.zeros((V, O, 4))
    cam_k[..., :2] = 2.0
    return dict(cam_T=f32(cam_T), obj_T=f32(obj_T), uv=f32(uv),
                info=f32(np.broadcast_to(np.eye(2) * 1e4, (V, O, K, 2, 2))),
                model_kp=f32(model_kp), cam_k=f32(cam_k), valid=valid, inliers=valid.copy(),
                cam_active=cam_active, obj_active=obj_active)


@pytest.mark.parametrize("V,O,n_views,n_objs", [(1, 8, 1, 8), (16, 8, 6, 8), (32, 8, 22, 8),
                                                (128, 16, 70, 12)])
def test_k14_ba_lm_matches_the_eager_schedule(dev, V, O, n_views, n_objs):
    """K14 against the eager plain schedule on the card and f64 on the CPU
    (chip_smoke's `compare_ba` gate), tracking and global, at the (V, O)
    the engine's capacity growth reaches."""
    import chip_smoke as cs

    arrays = _lm_arrays(V, O, n_views, n_objs, seed=V + O)
    act = (arrays["cam_active"], arrays["obj_active"])
    cs.compare_ba(f"global V={V} O={O}", arrays, dev, act)
    row = {k: (a[:1] if k in ("cam_T", "uv", "info", "cam_k", "valid", "inliers") else a)
           for k, a in arrays.items()}
    row["cam_active"] = np.ones(1, bool)
    row["cam_T"] = row["cam_T"].copy()
    row["cam_T"][0, :3, 3] += 0.5
    cs.compare_ba(f"tracking O={O}", row, dev, (np.ones(1, bool), act[1]), **cs.TRACKING)


def test_k14_first_iteration_matches_k4_k7(dev):
    import chip_smoke as cs

    rng = np.random.default_rng(12)
    assert cs.k14_first_step(cs._ba_problem(dev, rng, cs.Objects(rng))) <= 1e-3


def test_k14_one_launch_per_optimize(dev):
    """`optimize` on CUDA tensors: one K14 launch, no K4, no K7."""
    import chip_smoke as cs
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.solvers import ba

    p = cs._ba_problem_of(_lm_arrays(16, 8, 6, 8, seed=3), dev)
    ba.optimize(p)
    kernels.reset_counts()
    r = ba.optimize(p)
    t = ba.optimize(p._replace(cam_T=p.cam_T[:1], uv=p.uv[:1], info=p.info[:1],
                               cam_k=p.cam_k[:1], valid=p.valid[:1], inliers=p.inliers[:1],
                               cam_active=p.cam_active[:1]), **cs.TRACKING)
    torch.cuda.synchronize()
    c = kernels.counts()
    assert c["ba_lm"] == 2 and c["ba_edges"] == 0 and c["ba_schur"] == 0
    assert torch.isfinite(r.cam_T).all() and torch.isfinite(t.cam_T).all()
    assert int(r.num_inliers) > 0 and r.inliers.dtype == torch.bool


def test_k15_pnp_ransac(dev):
    """K15 against its plain version under chip_smoke's gate at the front
    end's shapes and the backup pose's; `pnp_ransac_batch` and `pnp_ransac`
    on CUDA tensors are one K15 launch each and no K3; f64, too many points
    and an unknown shape raise instead of falling back."""
    import chip_smoke as cs
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.solvers import pnp

    rng = np.random.default_rng(15)
    x, y, mask, idx = cs.pnp_inputs(dev, rng)
    cs.k15_gate("front end", x, y, mask, idx)
    cs.k15_gate("front end, no refinement", x, y, mask, idx, refine=False)
    cs.k15_gate("backup pose", *cs.backup_inputs(dev, rng))
    kernels.reset_counts()
    r = pnp.pnp_ransac_batch(x, y, mask, idx)
    one = pnp.pnp_ransac(x[0], y[0], mask[0], idx[0])
    torch.cuda.synchronize()
    c = kernels.counts()
    assert c["pnp_ransac"] == 2 and c["pnp_hypotheses"] == 0
    assert r.success[:-2].all() and not r.success[-2:].any()
    assert torch.equal(one.T, r.T[0]) and torch.equal(one.inliers, r.inliers[0])
    with pytest.raises(ValueError, match="f32"):
        pnp.pnp_ransac_batch(x.double(), y.double(), mask, idx)
    big = pnp.K15_MAX_POINTS + 1
    with pytest.raises(ValueError, match="at most"):
        pnp.pnp_ransac_batch(torch.zeros(1, big, 3, device=dev), torch.zeros(1, big, 2, device=dev),
                             torch.ones(1, big, dtype=torch.bool, device=dev), idx[:1])
    assert kernels.counts()["pnp_ransac"] == 2


def test_kernels_refuse_autograd(dev):
    """C1: K2, K8 and K9 raise where autograd would record them (they have
    no backward yet); the same forward runs under inference_mode."""
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    torch.manual_seed(0)
    net = PkpNet(n_stack=2, n_modules=1, features=8).to(dev)
    x = torch.rand(2, 64, 64, 3, device=dev)
    with pytest.raises(RuntimeError, match="ROADMAP B13"):
        net(x)
    with torch.inference_mode():
        out = net(x)
    assert torch.isfinite(out.uv).all()
