"""Kernels K1-K13 against their plain PyTorch versions on the card.

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
    """Equal bf16 bits and s8 codes at the engine's kinds of shape: 1x1 and
    3x3, Cout 41 (a partial tile), the prior's 41 input channels (padded to
    48) in a 7x7 stride-2 convolution, pixels not a multiple of the tile."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(9)
    for cin, cout, k, stride, hw in ((128, 256, 1, 1, 16), (128, 128, 3, 1, 16),
                                     (256, 41, 1, 1, 9), (41, 64, 7, 2, 32), (64, 64, 3, 1, 5)):
        qc = _qconv(dev, cin, cout, k, stride)
        x = torch.randint(-127, 128, (2, hw, hw, cin), device=dev, generator=g,
                          dtype=torch.int32).to(torch.int8)
        e1 = (torch.rand(cout, device=dev, generator=g) * 1e-3).to(torch.bfloat16).float()
        e2 = torch.randn(cout, device=dev, generator=g).to(torch.bfloat16).float()
        for out_s8 in (False, True):
            a = ik.int8_conv(x, qc, e1, e2, out_s8)
            b = ik.int8_conv_plain(x, qc, e1, e2, out_s8)
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (cin, k)


def test_k12_int8_quant(dev):
    """Equal codes for f32, bf16 and s8 inputs, per-tensor and per-channel
    divisors, raw, normalised and both outputs."""
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
