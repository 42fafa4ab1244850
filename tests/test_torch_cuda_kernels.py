"""Kernels K1-K22 against their plain PyTorch versions on the card.

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


@pytest.mark.parametrize("ow", [255, 256, 257])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_k1_roi_crop_ragged_shapes(dev, ow, C):
    """K1 on every path its plan allows, against its plain version within
    1e-5 (the same two f32 taps) and bit-equal across paths, at ragged widths
    and channel counts, with masked slots, boxes off the image, NaN / +-inf
    coordinates and misaligned boxes. The plain version runs on the CPU
    here: on the card PyTorch divides by the Python scalar `ow` through its
    reciprocal, which moves a bin centre by an ulp (1e-5 px at 150 px) away
    from the true division that K1, JAX and the CPU compute."""
    from suo_slam_tpu_torch.ops import roi

    rng = np.random.default_rng(ow * 10 + C)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 120, 160, C)).astype(np.float32)).to(dev)
    inf, nan = float("inf"), float("nan")
    boxes = torch.tensor([[[4.0, 6.0, 150.5, 100.25], [-30.0, -12.0, 20.0, 15.0],
                           [nan, 3.0, 20.0, 30.0], [140.0, 100.0, 400.0, 300.0]],
                          [[0.0, -inf, inf, 40.0], [10.0, 10.0, 10.0, 10.0],
                           [33.0, 5.0, 12.0, 40.0], [-inf, nan, 1e30, -1e30]]], device=dev)
    mask = torch.tensor([[True, True, True, False], [True, False, True, True]], device=dev)
    p = roi.roi_crop_batch_plain(img.cpu(), boxes.cpu(), mask.cpu(), (37, ow)).to(dev)
    paths = (roi.GENERIC, roi.STRIP) if C == 3 and ow % 4 == 0 else (roi.GENERIC,)
    outs = [roi._roi_crop_cuda(img, boxes, mask, (37, ow), path=q) for q in paths]
    assert (roi.roi_crop_batch(img, boxes, mask, (37, ow)) - p).abs().max().item() <= 1e-5
    # boxes 4 bytes off a 16-byte boundary (the vector paths read a box as
    # one 16-byte load: the wrapper realigns them)
    odd = torch.empty(1 + boxes.numel(), device=dev)[1:].view(boxes.shape).copy_(boxes)
    assert odd.data_ptr() % 16 == 4
    outs.append(roi._roi_crop_cuda(img, odd, mask, (37, ow)))
    for k in outs:
        assert (k - p).abs().max().item() <= 1e-5
        assert torch.equal(k, outs[0])
        assert not k[0, 3].any() and not k[1, 1].any()


def test_k1_one_launch_per_call(dev):
    """The K1 wrapper makes exactly one kernel launch per call (no copy of
    the mask or the boxes), by torch.profiler's kernel count, on the main
    path's shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from suo_slam_tpu_torch.ops import roi

    img = torch.rand(1, 480, 640, 3, device=dev)
    boxes = torch.tensor([[[100.0 + 40 * o, 80.0, 260.0 + 40 * o, 240.0] for o in range(8)]],
                         device=dev)
    mask = torch.ones((1, 8), dtype=torch.bool, device=dev)
    roi.roi_crop_batch(img, boxes, mask)
    torch.cuda.synchronize()
    for attempt in range(3):  # the tracer now and then loses a short session
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                roi.roi_crop_batch(img, boxes, mask)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if kern:
            break
    assert sum(e.count for e in kern) == 5
    assert all("roi_crop" in e.key for e in kern)


def _head_logits(dev, n, dtype, seed, scale=1.0):
    """[n, 64, 64, 41] logits in the head's layout: an NHWC view of a
    channels_last NCHW tensor."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, 41, 64, 64, device=dev, generator=g) * scale).to(dtype).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)


@pytest.mark.parametrize("n", [3, 8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_heatmap_readout(dev, n, dtype):
    """Both paths of K2 (dense: a cluster per crop; strided: the earlier
    design) within 1e-5 of the plain version, in both transpose_heatmaps
    orders; the wrapper picks the dense path for the head's layout."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = _head_logits(dev, n, dtype, n, scale=4.0 if dtype == torch.bfloat16 else 1.0)
    for view in (x, x.transpose(1, 2)):
        assert hm.plan_readout(view.shape, view.stride(), view.element_size(),
                               view.data_ptr()).path == hm.DENSE
        p = hm.heatmap_readout_plain(view)
        for path in (None, hm.DENSE, hm.STRIDED):
            k = hm._heatmap_readout_cuda(view, 1e-6, path=path) if path is not None else \
                hm.heatmap_readout(view)
            for a, b in zip(k, p):
                assert a.dtype == torch.float32 and (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_batch_invariance(dev, dtype):
    """K2's dense path: every crop's outputs from a 128-crop call equal the
    single-crop call's bit for bit (a crop's sums run in an order that
    depends on the crop alone), in both orders."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = _head_logits(dev, 128, dtype, 11, scale=4.0)
    for view in (x, x.transpose(1, 2)):
        big = hm.heatmap_readout(view)
        for i in (0, 1, 57, 127):
            one = hm.heatmap_readout(view[i:i + 1])
            assert all(torch.equal(a[i:i + 1], b) for a, b in zip(big, one)), i


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
    """K5 on both store routes (16-byte and one value a store), in f32 and
    bf16, with a bool mask, NaN / inf keypoints and ragged 8 x 8 tiles: f32
    equal to the plain version, bf16 equal to the plain f32 map rounded once
    (`.to(torch.bfloat16)`), at sizes whose half-extent is a power of two;
    at others PyTorch on the card divides the NDC grid by its Python scalar
    through a reciprocal, which K5 and the CPU do not, so there K5's f32
    map is within 1e-6 of the plain one and its bf16 map is the f32 map
    rounded once. One kernel a call: no mask conversion, no cast."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    g = torch.Generator(device=dev).manual_seed(2)
    uv = torch.rand(8, 41, 2, device=dev, generator=g) * 2.4 - 1.2
    uv[0, 0, 0] = float("nan")
    uv[0, 1, 1] = float("inf")
    mask = torch.rand(8, 41, device=dev, generator=g) < 0.7
    routes = set()
    for hw in ((64, 64), (256, 256), (16, 2), (16, 4), (4, 2), (2, 16), (20, 12)):
        sigma = hm.prior_sigma_for(hw)
        p = hm.render_prior_heatmaps_plain(uv, mask, hw, sigma)
        k = {dt: hm.render_prior_heatmaps(uv, mask, hw, sigma, dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
        if hw == (20, 12):
            assert (k[torch.float32] - p).abs().max().item() <= 1e-6
            p = k[torch.float32]
        for dt, kd in k.items():
            routes.add((dt, hm.plan_prior_render(8, hw, 41, dt, kd.data_ptr())))
            assert kd.is_contiguous() and kd.shape == p.shape and kd.dtype == dt
            assert torch.equal(kd, p.to(dt)), (hw, dt)
            assert not kd[0, ..., :2].any()
            assert _graph_kernels(lambda: hm.render_prior_heatmaps(uv, mask, hw, sigma,
                                                                   dtype=dt)) == 1
    assert routes == {(dt, r) for dt in (torch.float32, torch.bfloat16)
                      for r in (hm.PRIOR_VECTOR, hm.PRIOR_SCALAR)}
    # fewer keypoints than a vector: a dv row's repeated terms wrap more than once
    for K, hw in ((3, (16, 8)), (1, (32, 16))):
        sigma = hm.prior_sigma_for(hw)
        p = hm.render_prior_heatmaps_plain(uv[:, :K], mask[:, :K], hw, sigma)
        for dt in (torch.float32, torch.bfloat16):
            k = hm.render_prior_heatmaps(uv[:, :K], mask[:, :K], hw, sigma, dtype=dt)
            assert hm.plan_prior_render(8, hw, K, dt, k.data_ptr()) == hm.PRIOR_VECTOR
            assert torch.equal(k, p.to(dt)), (K, hw, dt)


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
        k = sk._chi2_counts_cuda(*args, sk.CHI2_THRESH_2DOF, per_object)
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


def _k10_problem(dev, g, n_obj, P, B):
    """A table of n_obj clouds of P padded points (the first full, one empty),
    B poses reading rows of it, ground truth and a perturbed prediction."""
    from suo_slam_tpu_torch.core import lie

    pts = (torch.rand(n_obj, P, 3, device=dev, generator=g) - 0.5) * 100
    n = torch.randint(1, P + 1, (n_obj,), device=dev, generator=g).to(torch.int32)
    n[0] = P
    if n_obj > 1:
        n[1] = 0
    obj = torch.randint(0, n_obj, (B,), device=dev, generator=g).to(torch.int32)
    obj[0] = 0
    if B > 1:
        obj[1] = min(1, n_obj - 1)
    Tg = lie.se3_exp(torch.randn(B, 6, device=dev, generator=g) * 0.3)
    Tg[:, 2, 3] += 800.0
    Tp = lie.se3_exp(torch.randn(B, 6, device=dev, generator=g) * 0.01) @ Tg
    return pts, n, obj, Tp.contiguous(), Tg.contiguous()


@pytest.mark.parametrize("P", [700, 4096])
@pytest.mark.parametrize("B", [1, 5, 128])
def test_k10_add_dists(dev, B, P):
    """Per-point distances equal to the plain version's and means within
    1e-6 relative, on both designs (the earlier one on gathered clouds, as
    the current one without a table); a pose's results are the same bits
    whatever the batch it is scored in; padded rows and n = 0."""
    from suo_slam_tpu_torch.eval import meter

    g = torch.Generator(device=dev).manual_seed(7 + B + P)
    pts, n, obj, Tp, Tg = _k10_problem(dev, g, 6, P, B)
    means, d = meter._add_dists_cuda(pts, n, Tp, Tg, obj, per_point=True)
    p = meter.add_dists_plain(pts, n, Tp, Tg, per_point=True, obj=obj)
    pm, pd = torch.stack(p[:2]), torch.stack(p[2:])
    assert torch.equal(d, pd)
    assert float(((means - pm).abs() / pm.abs().clamp(min=1e-30)).max()) <= 1e-6
    if B > 1:
        assert means[0, 1] == means[1, 1] == 0.0  # n = 0
    for i in sorted({0, 1, B // 2, B - 1}):
        m1, d1 = meter._add_dists_cuda(pts, n, Tp[i:i + 1], Tg[i:i + 1], obj[i:i + 1],
                                       per_point=True)
        assert torch.equal(means[:, i:i + 1], m1) and torch.equal(d[:, i:i + 1], d1), i
    if B * P <= 128 * 700:  # the earlier design on the gathered clouds
        o = obj.long()
        m2, d2 = meter._add_dists_cuda(pts[o], n[o], Tp, Tg, per_point=True, two_pass=True)
        assert torch.equal(d2, pd)
        assert float(((m2 - pm).abs() / pm.abs().clamp(min=1e-30)).max()) <= 1e-6
        # the current design without a table (pose b on cloud b): the same bits
        m3, d3 = meter._add_dists_cuda(pts[o], n[o], Tp, Tg, per_point=True)
        assert torch.equal(m3, means) and torch.equal(d3, d)


def _cuda_kernels(fn, calls):
    """The CUDA kernels (by name and count) of `calls` calls of fn, from
    torch.profiler (retaken where the tracer lost the session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # the tracer now and then loses a short session
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and "emcpy" not in e.key}
        if kern:
            return kern
    return kern


def test_k2_k10_one_launch_per_call(dev):
    """K2's wrapper (both paths) and K10's (the current design, inputs of the
    types it takes) make one kernel launch per call, by torch.profiler's
    kernel count."""
    from suo_slam_tpu_torch.eval import meter
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = _head_logits(dev, 8, torch.float32, 3)
    for path, name in ((hm.DENSE, "heatmap_readout_kernel_dense"),
                       (hm.STRIDED, "heatmap_readout_kernel<")):
        kern = _cuda_kernels(lambda: hm._heatmap_readout_cuda(x, 1e-6, path=path), 5)
        assert sum(kern.values()) == 5 and all(name in k for k in kern), kern
    g = torch.Generator(device=dev).manual_seed(5)
    pts, n, obj, Tp, Tg = _k10_problem(dev, g, 8, 4096, 96)
    kern = _cuda_kernels(lambda: meter._add_dists_cuda(pts, n, Tp, Tg, obj), 5)
    assert sum(kern.values()) == 5 and all("add_dists_kernel" in k for k in kern), kern


def test_k2_heatmap_readout_bf16(dev):
    """bf16 logits (the int8 engine's head): the shift rounds to bf16 in both;
    a contiguous NHWC tensor (the int8 head's own layout) and a view the
    dense path cannot take."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = _head_logits(dev, 3, torch.bfloat16, 8, scale=4.0)
    for view in (x.contiguous(), x[:, 1:], x.transpose(1, 2).contiguous()):
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


def test_k12_pool_and_junction_modes(dev):
    """K12's pool mode (the max-pool fused with the nrq that reads it) and
    junction mode (the second operand read at half resolution) equal the
    earlier chain — K13's kernel, then K12 on its output — and the plain
    version, bit for bit: every hourglass width, a ragged C (no vector
    path), odd pooled extents, per-tensor and per-channel scales, quant and
    quant_pair after the junction, the pool alone."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(13)
    bf = lambda t: t.to(torch.bfloat16).float()
    codes = lambda shape: torch.randint(-127, 128, shape, device=dev, generator=g,
                                        dtype=torch.int32).to(torch.int8)
    for C, H, W in ((256, 64, 64), (128, 16, 16), (48, 8, 8), (40, 6, 6), (16, 7, 9),
                    (256, 2, 2)):
        x = codes((3, H, W, C))
        m = bf(torch.randn(C, device=dev, generator=g) * 0.2)
        c = bf(torch.randn(C, device=dev, generator=g) * 5)
        kernels.reset_counts()
        fused = ik.int8_quant(x, None, m, c, pool=True)
        alone, _ = ik.int8_quant(x, None, pool=True)
        assert kernels.counts()["int8_quant_pool"] == 2
        pooled = ik._int8_maxpool_cuda(x) if C % 4 == 0 else ik.int8_maxpool_plain(x)
        chain = (pooled, ik.int8_quant(pooled, None, m, c)[1])
        plain = ik.int8_quant_plain(x, None, m, c, pool=True)
        torch.cuda.synchronize()
        for a, b, p in zip(fused, chain, plain):
            assert torch.equal(a, b) and torch.equal(a, p), ("pool", C, H, W)
        assert torch.equal(alone, chain[0])
        if H % 2 or W % 2:
            continue
        low = codes((3, H // 2, W // 2, C))
        s_up = bf(torch.rand(C, device=dev, generator=g) * 0.05 + 0.001)
        for s_low in (bf(torch.full((C,), 0.03, device=dev)),
                      bf(torch.rand(C, device=dev, generator=g) * 0.05 + 0.001)):
            div = bf(torch.rand(C, device=dev, generator=g) * 0.05 + 0.01)
            for args in ((div,), (div, m, c)):
                kw = dict(x2=ik.Deq(low, s_low, up=True))
                fused = ik.int8_quant(ik.Deq(x, s_up), *args, **kw)
                plain = ik.int8_quant_plain(ik.Deq(x, s_up), *args, **kw)
                if C % 4 == 0:
                    t = ik._int8_upsample_add_cuda(x, low, s_up, s_low)
                    chain = ik.int8_quant(t, *args)
                    # the quantize of the materialised sum: its own bf16 chain
                    assert torch.equal(t, ik.int8_upsample_add_plain(x, low, s_up, s_low))
                else:
                    chain = plain
                torch.cuda.synchronize()
                for a, b, p in zip(fused, chain, plain):
                    assert (a is None) == (b is None) == (p is None)
                    assert a is None or (torch.equal(a, b) and torch.equal(a, p)), (
                        "junction", C, H, len(args))


def _lm_arrays(V, O, n_views, n_objs, seed, K=41):
    import chip_smoke as cs

    return cs.lm_arrays(V, O, n_views, n_objs, seed, K)


@pytest.mark.parametrize("V,O,n_views,n_objs", [(1, 8, 1, 8), (16, 8, 6, 8), (32, 8, 22, 8),
                                                (128, 16, 70, 12), (8, 40, 6, 30)])
def test_k14_ba_lm_matches_the_eager_schedule(dev, V, O, n_views, n_objs):
    """K14 against the eager plain schedule on the card and f64 on the CPU
    (chip_smoke's `compare_ba` gate on the cluster design, which also
    repeats bit for bit; the block design beside it), tracking and global,
    at the (V, O) the engine's capacity growth reaches, and at O = 40, whose
    reduced system and exchange buffers outgrow a CTA's shared memory (the
    cluster design's scratch path)."""
    import chip_smoke as cs
    from suo_slam_tpu_torch.solvers import ba

    designs = ba.LM_DESIGNS
    if O == 40:
        layout, _, _ = ba.lm_cluster_layout(V, O, ba.lm_cluster_size(V))
        assert not all(inside for inside, _, _ in layout)
        # the O = 40 case is about the cluster design's scratch path (the
        # block design runs this problem in ~40 ms)
        designs = ("cluster",)
    arrays = _lm_arrays(V, O, n_views, n_objs, seed=V + O)
    act = (arrays["cam_active"], arrays["obj_active"])
    cs.compare_ba(f"global V={V} O={O}", arrays, dev, act, designs=designs)
    row = {k: (a[:1] if k in ("cam_T", "uv", "info", "cam_k", "valid", "inliers") else a)
           for k, a in arrays.items()}
    row["cam_active"] = np.ones(1, bool)
    row["cam_T"] = row["cam_T"].copy()
    row["cam_T"][0, :3, 3] += 0.5
    cs.compare_ba(f"tracking O={O}", row, dev, (np.ones(1, bool), act[1]), designs=designs,
                  **cs.TRACKING)


@pytest.mark.parametrize("design", ["cluster", "block"])
def test_k14_first_iteration_matches_k4_k7(dev, design):
    import chip_smoke as cs

    rng = np.random.default_rng(12)
    assert cs.k14_first_step(cs._ba_problem(dev, rng, cs.Objects(rng)), design=design) <= 1e-3


@pytest.mark.parametrize("tracking", [False, True])
def test_k14_cluster_design_repeats_bit_for_bit(dev, tracking):
    """Two calls of the cluster design on one problem: equal poses, inliers,
    counts, chi2 and iterations, bit for bit (every cross-CTA sum in rank
    order), on a capacity that takes a cluster of 16 with cameras of
    several ranks active."""
    import chip_smoke as cs
    from suo_slam_tpu_torch.solvers import ba

    arrays = _lm_arrays(64, 8, 44, 8, seed=7)
    p = cs._ba_problem_of(arrays, dev)
    kw = dict(cs.TRACKING) if tracking else {}
    if tracking:
        p = p._replace(cam_T=p.cam_T[:4], uv=p.uv[:4], info=p.info[:4], cam_k=p.cam_k[:4],
                       valid=p.valid[:4], inliers=p.inliers[:4], cam_active=p.cam_active[:4])
    runs = [ba._ba_lm_cuda(p, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    for r, it in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][0], r))
        assert torch.equal(runs[0][1], it)
    assert int(runs[0][0].num_inliers) > 0


def test_k14_captured_optimize_replays_equal(dev):
    """`ba.optimize` (the cluster design: a cluster launch on the global
    path) captured in a CUDA graph and replayed equals the eager call bit
    for bit, global and tracking; one kernel node per call."""
    import chip_smoke as cs

    p = cs._ba_problem_of(_lm_arrays(32, 8, 22, 8, seed=40), dev)
    t = p._replace(cam_T=p.cam_T[:1], uv=p.uv[:1], info=p.info[:1], cam_k=p.cam_k[:1],
                   valid=p.valid[:1], inliers=p.inliers[:1], cam_active=p.cam_active[:1])
    for prob, kw in ((p, {}), (t, cs.TRACKING)):
        per_call, same = cs.k14_capture_check(prob, kw)
        assert per_call == 1 and same


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


@pytest.mark.parametrize("n_hyp", [1, 31, 64, 65, 128])
@pytest.mark.parametrize("N", [4, 8, 41, 2048])
def test_k15_pnp_ransac_shapes(dev, n_hyp, N):
    """K15 at ragged hypothesis and point counts (an object with fewer than
    4 valid points and one whose points coincide among them): without
    refinement the chosen hypothesis (its rotation, copied verbatim), the
    inliers and their counts equal the plain version's exactly; with it,
    `k15_gate`'s outcome holds. The earlier serial design agrees too."""
    import chip_smoke as cs
    from suo_slam_tpu_torch.solvers import pnp

    rng = np.random.default_rng(n_hyp * 7 + N)
    x, y, mask, idx = cs.pnp_inputs(dev, rng, O=6, N=N, n_hyp=n_hyp)
    assert int(mask[4].sum()) < 4
    for serial in (False, True):
        rk = pnp._pnp_ransac_cuda(x, y, mask, idx, refine=False, serial=serial)
        rp = pnp.pnp_ransac_batch_plain(x, y, mask, idx, refine=False)
        assert torch.equal(rk.success, rp.success)
        assert torch.equal(rk.inliers, rp.inliers)
        assert torch.equal(rk.num_inliers, rp.num_inliers)
        assert torch.equal(rk.T[:, :3, :3], rp.T[:, :3, :3])
    cs.k15_gate(f"K15 n_hyp={n_hyp} N={N}", x, y, mask, idx)


@pytest.mark.parametrize("O,H,N", [(8, 64, 41), (1, 128, 328), (3, 5, 7), (2, 33, 1024),
                                   (1, 1, 1), (4, 16, 97), (2, 31, 2048)])
def test_k22_pnp_sample(dev, O, H, N):
    """K22 equals its plain version on the same CUDA draws exactly: ties
    (lowest index), a row with 2 valid points, one with none (index 0 for
    every exhausted pick), every per-lane width up to 2048 points (K15's
    limit)."""
    from suo_slam_tpu_torch.solvers import pnp

    g = torch.Generator(device=dev).manual_seed(O * 1000 + N)
    u = torch.rand((O, H, N), generator=g, device=dev)
    if N > 3:
        u[..., 3] = u[..., 1]
    mask = torch.rand((O, N), generator=g, device=dev) < 0.8
    mask[0] = False
    mask[0, :min(2, N)] = True
    if O > 1:
        mask[1] = False
    k = pnp._hypothesis_indices_cuda(u, mask)
    p = pnp.hypothesis_indices_plain(u, mask)
    torch.cuda.synchronize()
    assert k.dtype == torch.int64 and torch.equal(k, p)
    assert (k[0, :, min(2, N):] == 0).all()


def test_k22_one_launch_per_sampler_call(dev, monkeypatch):
    """The index sampler (`pnp.sample_hypothesis_indices`, off the main
    path) on a CUDA mask: one K22 launch a call, never the plain version."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.solvers import pnp

    plain = []
    monkeypatch.setattr(pnp, "hypothesis_indices_plain", lambda *a: plain.append(a))
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = torch.rand((8, 41), device=dev) < 0.8
    kernels.reset_counts()
    idx = pnp.sample_hypothesis_indices(mask, 64, gen)
    one = pnp.sample_hypothesis_indices(mask.flatten()[None], 128, gen)[0]
    torch.cuda.synchronize()
    assert kernels.counts()["pnp_sample"] == 2 and not plain
    assert idx.shape == (8, 64, 4) and one.shape == (128, 4) and idx.dtype == torch.int64
    assert bool(torch.gather(mask, 1, idx.flatten(1)).all())


def test_default_sampler_launches_no_k22(dev, monkeypatch):
    """The engine's default sampler draws `pnp.Draws` (one `torch.rand`, the
    index sampler's draw on the same generator) and launches nothing; the
    group's and the backup pose's PnP on them are one K15 launch each, no
    K22 and no plain ranking, bit-equal to K15 on the index sampler's
    indices from a generator at the same seed."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam.engine import TorchGumbelSampler
    from suo_slam_tpu_torch.solvers import pnp

    import chip_smoke as cs

    x, y, mask, _ = cs.pnp_inputs(dev, np.random.default_rng(3))
    plain = []
    rank = pnp.hypothesis_indices_plain
    monkeypatch.setattr(pnp, "hypothesis_indices_plain", lambda *a: plain.append(a) or rank(*a))
    kernels.reset_counts()
    sampler = TorchGumbelSampler(7, dev)
    d = sampler(mask, 64)
    one = sampler.single(mask[0], 128)
    assert isinstance(d, pnp.Draws) and d.u.shape == (8, 64, 41) and one.u.shape == (128, 41)
    assert sum(kernels.counts().values()) == 0
    r = pnp.pnp_ransac_batch(x, y, mask, d)
    r1 = pnp.pnp_ransac(x[0], y[0], mask[0], one)
    torch.cuda.synchronize()
    c = kernels.counts()
    assert c["pnp_ransac"] == 2 and c["pnp_sample"] == 0 and not plain
    gen = torch.Generator(device=dev).manual_seed(7)
    idx = pnp.sample_hypothesis_indices(mask, 64, gen)
    idx1 = pnp.sample_hypothesis_indices(mask[:1], 128, gen)[0]
    ri = pnp.pnp_ransac_batch(x, y, mask, idx)
    ri1 = pnp.pnp_ransac(x[0], y[0], mask[0], idx1)
    for a, b in ((r, ri), (r1, ri1)):
        assert torch.equal(a.T.view(torch.int32), b.T.view(torch.int32))
        assert torch.equal(a.inliers, b.inliers) and torch.equal(a.success, b.success)
        assert torch.equal(a.num_inliers, b.num_inliers)


@pytest.mark.parametrize("n_hyp,N", [(64, 41), (128, 8), (31, 4), (65, 97), (1, 1),
                                     (128, 328), (64, 2048)])
def test_k15_draws_mode_equals_k15_on_k22_indices(dev, n_hyp, N):
    """K15's draws mode (it ranks the `torch.rand` draws itself, the main
    path's input) against K15 on K22's indices of the same draws: pose bits,
    inliers, counts and success equal, with and without refinement, at the
    front end's [8, 64, 41], the backup pose's [1, 128, 8] (`backup_inputs`)
    and ragged shapes (rows of 3 and 0 valid points among them: exhausted
    picks). f64 draws and the serial design raise."""
    import chip_smoke as cs
    from suo_slam_tpu_torch.solvers import pnp

    rng = np.random.default_rng(n_hyp * 31 + N)
    if (n_hyp, N) == (128, 8):
        x, y, mask, d = cs.backup_inputs(dev, rng, draws=True)
    else:
        x, y, mask, d = cs.pnp_inputs(dev, rng, O=8 if N == 41 else 6, N=N, n_hyp=n_hyp,
                                      draws=True)
    cs.k15_draws_equal(f"n_hyp={n_hyp} N={N}", x, y, mask, d)
    with pytest.raises(ValueError, match="f32 draws"):
        pnp._pnp_ransac_cuda(x, y, mask, pnp.Draws(d.u.double()))
    with pytest.raises(ValueError, match="serial"):
        pnp._pnp_ransac_cuda(x, y, mask, d, serial=True)


@pytest.mark.parametrize("case", ["seeded", "padded", "tie", "no inlier", "no candidate",
                                  "unmet", "map 64", "map 128"])
def test_k6_camera_ransac_fused(dev, case):
    """K6's camera-RANSAC mode (`camera_ransac`, the front end's slots
    branch) in one launch, bit-equal to its plain twin on the card: the
    pose's bits, the count, ok and the best slot (`chip_smoke`'s cases: a
    padded group, a tie to the lower slot, a row with no inlier, no
    candidate, min_num_inliers unmet, maps of 64 and 128 slots: several
    rounds of hypotheses, and one a round); `camera_pose_ransac` on the
    scattered rows is one launch too, equal."""
    import chip_smoke as cs
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk

    objs = cs.Objects(np.random.default_rng(0))
    args, mi = cs.camera_ransac_inputs(dev, np.random.default_rng(len(case)), objs, case)
    kernels.reset_counts()
    k = sk.camera_ransac(*args, mi)
    torch.cuda.synchronize()
    assert kernels.counts()["chi2_counts"] == 1 and sum(kernels.counts().values()) == 1
    p = sk.camera_ransac_plain(*args, mi)
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    for a, b in zip(k[1:], p[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if case == "tie":
        assert bool(k[2]) and int(k[3]) == 1
    if case in ("no candidate", "unmet"):
        assert not bool(k[2]) and torch.equal(k[0], torch.eye(4, device=dev))
    T_pnp, pnp_ok, uv, info, keep, k4, slots, obj_T, active, model_kp = args
    O = obj_T.shape[0]

    def rows(src, fill):
        out = torch.full((O + 1,) + src.shape[1:], fill, dtype=src.dtype, device=dev)
        out[slots] = src
        return out[:O]

    T_row = rows(T_pnp, 0.0)
    T_row[~rows(torch.ones_like(pnp_ok), False)] = torch.eye(4, device=dev)
    ok_row = rows(pnp_ok, False)
    kernels.reset_counts()
    j = sk.camera_pose_ransac(T_row, ok_row, obj_T, active & ok_row, model_kp, rows(uv, 0.0),
                              rows(info, 0.0), rows(keep, False), rows(k4, 0.0), mi)
    torch.cuda.synchronize()
    assert kernels.counts()["chi2_counts"] == 1
    assert all(torch.equal(a, b) for a, b in zip(j, k[:3]))


def test_k6_reinit_votes_fused(dev):
    """K6's re-init mode (`reinit_votes`, the tail's vote over the views cs
    of the device mirrors) in one launch, equal to its plain twin on the
    card (two invalid views among 16 of 32 rows); `reinit_counts` on CUDA
    tensors is one launch too."""
    import chip_smoke as cs
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk

    objs = cs.Objects(np.random.default_rng(0))
    args = cs.reinit_inputs(dev, np.random.default_rng(1), objs)
    kernels.reset_counts()
    k = sk.reinit_votes(*args)
    torch.cuda.synchronize()
    assert kernels.counts()["chi2_counts"] == 1
    p = sk.reinit_votes_plain(*args)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and k[0].dtype == torch.int32
    assert (k[0][[0, 2, 4]] < k[1][[0, 2, 4]]).all() and (k[0][[1, 3, 5]] > k[1][[1, 3, 5]]).all()
    T_pnp, T_est, cam_T, cam_valid, model_kp, uv_m, info_m, valid_m, k4_m, cs_ = args
    r = sk.reinit_counts(T_pnp, T_est, cam_T, cam_valid, model_kp, uv_m[cs_], info_m[cs_],
                         valid_m[cs_], k4_m[cs_])
    torch.cuda.synchronize()
    assert kernels.counts()["chi2_counts"] == 2
    assert torch.equal(r[0], k[0]) and torch.equal(r[1], k[1])


def test_kernels_refuse_autograd(dev):
    """Gradients flow through K2, K8 and K9 (their backward kernels K19, K17
    and K18): the full net under autograd on the card gives outputs with a
    `grad_fn` and parameter gradients equal to the run with the plain
    versions (the same autograd Functions, plain bodies): with fixed
    statistics within 1e-4 of each tensor's largest magnitude; in train mode,
    where this tiny net at random initialization amplifies rounding layer by
    layer (tests/test_torch_train_step.py measures it against JAX), by the
    whole gradient's cosine (>= 0.999), without the convolution biases a
    batch norm removes (0 in exact arithmetic: rounding noise)."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.ops import heatmap as hm

    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    net = PkpNet(n_stack=2, n_modules=1, features=16).to(dev).to(
        memory_format=torch.channels_last)
    x = torch.rand(4, 64, 64, 3, device=dev)
    mask = torch.tensor([True, True, True, False], device=dev)
    keep = torch.rand(4, 41, device=dev) < 0.5

    def grads(train):
        net.zero_grad(set_to_none=True)
        out = net(x, train=train, row_mask=mask, dropout_mask=keep if train else None)
        assert out.uv.grad_fn is not None
        (out.uv.square().sum() + out.cov.sum() + out.kp_mask_logits.sum()).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}

    plain = {"_norm_relu_fwd": lambda a, b, c: hg.norm_relu_plain(a, b, c),
             "bn_train_stats": hg.bn_train_stats_plain, "norm_relu_bwd": hg.norm_relu_bwd_plain,
             "_upsample_add_fwd": hg.upsample_add_plain,
             "upsample_add_bwd": hg.upsample_add_bwd_plain}
    for train in (False, True):
        state = {k: v.clone() for k, v in net.state_dict().items()}
        kernels.reset_counts()
        gk = grads(train)
        c = kernels.counts()
        assert c["norm_relu_bwd"] > 0 and c["upsample_add_bwd"] > 0
        assert c["heatmap_readout_bwd"] == 1 and (c["bn_stats"] > 0) == train
        net.load_state_dict(state)
        saved = {k: getattr(hg, k) for k in plain}
        saved_hm = (hm._heatmap_readout_fwd, hm.heatmap_readout_bwd)
        try:
            for k, f in plain.items():
                setattr(hg, k, f)
            hm._heatmap_readout_fwd = lambda l, mv: hm.heatmap_readout_plain(l, mv)
            hm.heatmap_readout_bwd = hm.heatmap_readout_bwd_plain
            gp = grads(train)
        finally:
            for k, f in saved.items():
                setattr(hg, k, f)
            hm._heatmap_readout_fwd, hm.heatmap_readout_bwd = saved_hm
        assert set(gk) == set(gp)
        if train:  # the whole gradient's direction, without the zero biases
            keys = [k for k in gk if not (k.endswith(".bias") and k[:-5] + ".weight" in gk
                                          and k not in ("classifier.bias",
                                                        "backbone.heads.1.bias"))]
            a = torch.cat([gk[k].reshape(-1).double() for k in keys])
            b = torch.cat([gp[k].reshape(-1).double() for k in keys])
            assert (a @ b / a.norm() / b.norm()).item() >= 0.999
            continue
        for k in gk:
            scale = gp[k].abs().max().item()
            if scale > 1e-6:
                assert (gk[k] - gp[k]).abs().max().item() <= 1e-4 * scale, (train, k)


@pytest.mark.parametrize("design", ["fused", "split"])
def test_k16_k17_bn_train(dev, design):
    """K16's statistics and K17's sums and dx against their plain versions,
    f32 and bf16, with and without padded rows, in both designs (the fused
    design's grids of one CTA to many, a channel-block loop at C = 600, the
    scalar path at C = 96 and 300): statistics 1e-6 relative (f64 sums in
    another order), sums 1e-5 of their scale, dx 1e-5 of its largest
    magnitude (f32) or 1 bf16 ulp of it. One counted call each, equal bits
    when repeated; the fused K16's affine and running averages and K17's
    scale gradient bit-equal to the eager ops they replace."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg

    g = torch.Generator(device=dev).manual_seed(0)
    shapes = ((5, 64, 16, 16), (3, 256, 8, 8), (4, 96, 3, 5), (2, 300, 4, 4), (6, 256, 32, 32),
              (32, 128, 4, 4), (2, 600, 3, 3))
    for shape in shapes:
        N, C = shape[0], shape[1]
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=g) * 2 + 1).to(dt).contiguous(
                memory_format=torch.channels_last)
            dy = torch.randn(shape, device=dev, generator=g).to(dt).contiguous(
                memory_format=torch.channels_last)
            for mask in (None, torch.arange(N, device=dev) % 3 != 1):
                kernels.reset_counts()
                mk, vk = hg._bn_stats_cuda(x, mask, design=design)
                mp, vp = hg.bn_stats_plain(x, mask)
                assert kernels.counts()["bn_stats"] == 1
                assert torch.allclose(mk, mp, rtol=1e-6, atol=1e-7)
                assert torch.allclose(vk, vp, rtol=1e-6, atol=1e-7)
                scale = torch.rand(C, device=dev, generator=g) + 0.5
                bias = torch.randn(C, device=dev, generator=g)
                if design == "fused":
                    rm, rv = torch.randn(C, device=dev, generator=g), torch.rand(C, device=dev,
                                                                                   generator=g)
                    rm0, rv0 = rm.clone(), rv.clone()
                    m2, v2, rs, iv, sh = hg._bn_train_stats_cuda(x, mask, scale, bias, 1e-5,
                                                                 rm, rv, 0.9)
                    assert torch.equal(m2, mk) and torch.equal(v2, vk)
                    assert torch.equal(rs, torch.rsqrt(vk + 1e-5))
                    assert torch.equal(iv, rs * scale)
                    assert torch.equal(sh, bias - mk * iv)
                    assert torch.equal(rm, rm0 * 0.9 + mk * (1 - 0.9))
                    assert torch.equal(rv, rv0 * 0.9 + vk * (1 - 0.9))
                rstd = torch.rsqrt(vp + 1e-5)
                inv = rstd * scale
                shift = torch.randn(C, device=dev, generator=g) - mp * inv
                for train in (True, False):
                    args = (mp, rstd, mask) if train else ()
                    kernels.reset_counts()
                    k = hg._norm_relu_bwd_cuda(x, dy, inv, shift, *args, design=design)
                    assert kernels.counts()["norm_relu_bwd"] == 1
                    p = hg.norm_relu_bwd_plain(x, dy, inv, shift, *args)
                    for a, b in zip(k[1:], p[1:]):
                        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1)
                    tol = 1e-5 if dt == torch.float32 else 2.0 ** -8
                    d = (k[0].float() - p[0].float()).abs().max().item()
                    assert d <= tol * p[0].float().abs().max().item(), (shape, dt, train, d)
                    assert k[0].is_contiguous(memory_format=torch.channels_last)
                    assert torch.equal(k[3], k[2] * rstd if train else k[2])
                    again = hg._norm_relu_bwd_cuda(x, dy, inv, shift, *args, design=design)
                    assert all(torch.equal(a, b) for a, b in zip(k, again))


def _graph_kernels(fn, calls=3):
    """Kernel nodes per call of fn in a CUDA graph that captures `calls`
    calls (`cuGraphGetNodes` / `cuGraphNodeGetType` of libcuda): every
    launch, where a profiler session can lose some. fn runs once first on
    the capture's stream (its workspace is made there)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)) == 0
    kind, kernels = ctypes.c_int(-1), 0
    for i in range(count.value):
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(kind)) == 0
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    g.replay()
    torch.cuda.synchronize()
    g.reset()
    return kernels / calls


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_k16_k17_fused_one_launch_per_call(dev, dt):
    """The fused K16 (with the affine and the running averages) and K17 (both
    modes) are one kernel a call — by the kernel nodes of a captured graph,
    which also replays — at the train step's largest norm and a small one;
    their workspace counters are back at 0 after the calls and the replay."""
    from suo_slam_tpu_torch.models import hourglass as hg

    for shape in ((32, 256, 64, 64), (32, 128, 4, 4)):
        x = torch.randn(shape, device=dev).to(dt).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(shape, device=dev).to(dt).contiguous(memory_format=torch.channels_last)
        mask = (torch.arange(32, device=dev) % 4 != 3).to(torch.uint8)  # as the net passes it
        C = shape[1]
        one, zero = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        rm, rv = zero.clone(), one.clone()
        mean, _, rstd, inv, shift = hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9)
        calls = (lambda: hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9),
                 lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, mask),
                 lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift))
        assert [_graph_kernels(f) for f in calls] == [1, 1, 1], shape
        torch.cuda.synchronize()
        for w in hg._bn_work.values():
            assert not w[0].any()


def test_k18_upsample_add_bwd(dev):
    """K18 equal to its plain version on both routes — the vector route (16
    bytes a load) and the scalar route, for channel counts no multiple of a
    vector and for a dy one value off 16 bytes — and at the four junctions of the full-width train step (32 rows
    x 256 channels, 64 down to 8) in f32 and bf16."""
    from suo_slam_tpu_torch.models import hourglass as hg

    cl = torch.channels_last
    routes = set()

    def check(dy):
        route = hg.plan_upsample_bwd(tuple(dy.shape), dy.element_size(), dy.data_ptr())
        routes.add((dy.dtype, route))
        assert torch.equal(hg._upsample_add_bwd_cuda(dy), hg.upsample_add_bwd_plain(dy)), (
            tuple(dy.shape), dy.dtype, route)

    for dt in (torch.float32, torch.bfloat16):
        for H in (64, 8, 2):
            for C in (40, 12, 6):
                check(torch.randn(3, C, H, H + 2, device=dev).to(dt).contiguous(memory_format=cl))
        base = torch.randn(1 + 2 * 10 * 6 * 256, device=dev).to(dt)
        view = base[1:].view(2, 10, 6, 256).permute(0, 3, 1, 2)
        assert view.is_contiguous(memory_format=cl) and view.data_ptr() % 16
        check(view)
        for H in (64, 32, 16, 8):
            check(torch.randn(32, 256, H, H, device=dev).to(dt).contiguous(memory_format=cl))
    assert routes == {(dt, r) for dt in (torch.float32, torch.bfloat16)
                      for r in (hg.K18_VECTOR, hg.K18_SCALAR)}


def test_k19_heatmap_readout_bwd(dev):
    from suo_slam_tpu_torch.ops import heatmap as hm

    x = (torch.randn(3, 41, 64, 64, device=dev) * 3).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    gu, gc, gp = (torch.randn(3, 41, 2, device=dev), torch.randn(3, 41, 2, 2, device=dev),
                  torch.randn(3, 41, device=dev))
    for view in (x, x.transpose(1, 2)):
        for dt in (torch.float32, torch.bfloat16):
            v = view.to(dt)
            plan = hm.plan_readout_bwd(v.shape, v.stride(), v.element_size(), v.data_ptr())
            assert plan.path == hm.DENSE  # the head's layout takes the dense path
            p = hm.heatmap_readout_bwd_plain(v, gu, gc, gp)
            for path in (None, hm.STRIDED):
                k = hm._heatmap_readout_bwd_cuda(v, gu, gc, gp, path=path)
                assert k.stride() == v.stride() and k.dtype == dt
                # f - E[f] cancels near a peak; the two sum the moments in other orders
                tol = 1e-4 if dt == torch.float32 else 2.0 ** -7
                assert (k.float() - p.float()).abs().max().item() <= (
                    tol * p.float().abs().max().item()), (path, dt)
    # other layouts take the strided path
    y = x.contiguous().permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert hm.plan_readout_bwd(y.shape, y.stride(), 4, y.data_ptr()).path == hm.STRIDED
    k = hm._heatmap_readout_bwd_cuda(y, gu, gc, gp)
    p = hm.heatmap_readout_bwd_plain(y, gu, gc, gp)
    assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_k19_dense_batch_invariance_and_graph_replay(dev, dt):
    """K19's dense path: a crop's gradient has the same bits in a 32-crop
    call and alone (both orders), it is one kernel a call, and a captured
    call replays the eager bits."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    g = torch.Generator(device=dev).manual_seed(19)
    x = (torch.randn(32, 41, 64, 64, device=dev, generator=g) * 3).to(dt).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    gu, gc, gp = (torch.randn(s, device=dev, generator=g)
                  for s in ((32, 41, 2), (32, 41, 2, 2), (32, 41)))
    for v in (x, x.transpose(1, 2)):
        full = hm._heatmap_readout_bwd_cuda(v, gu, gc, gp)
        for n in (0, 5, 31):
            one = hm._heatmap_readout_bwd_cuda(v[n:n + 1], gu[n:n + 1], gc[n:n + 1],
                                               gp[n:n + 1])
            assert torch.equal(one[0], full[n]), n
        f = lambda: hm._heatmap_readout_bwd_cuda(v, gu, gc, gp)
        assert _graph_kernels(f) == 1
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = f()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, full)


def test_k11_f32_epilogue(dev):
    """K11's f32 epilogue (the quantized PkpNet's `QuantConv`): f32 or bf16
    results equal to the plain version's bits on both routes (the 7x7
    stride-2 stem on 3 channels padded to 16, stride-1 1x1 and 3x3 at the
    hourglass widths, Cin 41 padded to 48, a partial pixel tile)."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(19)
    cases = [(3, 64, 7, 2, 64, 2), (256, 128, 1, 1, 64, 2), (128, 128, 3, 1, 32, 3),
             (128, 256, 1, 1, 8, 4), (41, 256, 1, 1, 16, 2), (64, 64, 3, 1, 5, 2),
             (256, 256, 1, 1, 4, 8)]
    routes = set()
    for cin, cout, k, stride, hw, n in cases:
        qc = _qconv(dev, cin, cout, k, stride)
        x = torch.randint(-127, 128, (n, hw, hw, ik.padded(cin)), device=dev, generator=g,
                          dtype=torch.int32).to(torch.int8)
        x[..., cin:] = 0  # as K12 writes the codes
        e1 = torch.rand(cout, device=dev, generator=g) * 1e-4
        e2 = torch.randn(cout, device=dev, generator=g) * 0.1
        for dt in (torch.float32, torch.bfloat16):
            mode = ik.conv_mode(False, dt)
            routes.add(ik.plan_conv(n, hw, hw, x.shape[-1], cout, k, k, stride, k // 2,
                                    mode).route)
            a = ik.int8_conv(x, qc, e1, e2, f32_epilogue=dt)
            b = ik.int8_conv_plain(x, qc, e1, e2, f32_epilogue=dt)
            torch.cuda.synchronize()
            assert a.dtype == b.dtype == dt and torch.equal(a, b), (cin, cout, k, hw, dt)
    assert routes == {"wgmma", "mma_sync"}


def test_k12_f32_ops(dev):
    """K12's f32 mode: codes of a bf16 input (and of f32) computed in f32,
    clip(rint(f32(x) / s_x)), equal to the plain version's, written 16 wide
    for the stem's 3 channels and 48 wide for 41; a prologue is refused."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    g = torch.Generator(device=dev).manual_seed(20)
    for C, shape in ((3, (4, 64, 64)), (41, (2, 16, 16)), (128, (3, 32, 32)), (256, (2, 8, 8))):
        x32 = torch.randn(shape + (C,), device=dev, generator=g) * 3
        s_x = torch.full((C,), 7.3 / 127, device=dev)
        for x in (x32, x32.to(torch.bfloat16)):
            a, _ = ik.int8_quant(x, s_x, c_out=ik.padded(C), f32_ops=True)
            b, _ = ik.int8_quant_plain(x, s_x, c_out=ik.padded(C), f32_ops=True)
            torch.cuda.synchronize()
            assert a.shape[-1] == ik.padded(C) and torch.equal(a, b), (C, x.dtype)
            assert not a[..., C:].any()
    q = torch.zeros(2, 4, 4, 16, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        ik.int8_quant(ik.Deq(q, torch.ones(16, device=dev)), torch.ones(16, device=dev),
                      f32_ops=True)


def test_k20_k21_group_norm(dev):
    """K20 (y, mean, rstd) and K21 (dx, dscale, dbias) against their plain
    versions in both designs (the wrappers' route, and the split design's
    functions at every shape), f32 and bf16, at group sizes 1 to 8,
    unvectorized channel counts, one shape of each cluster-design plan class
    (k = 1 with several samples a CTA, k > 1 with the slice in shared
    memory, k > 1 with part of it read again) and pixels wider than the
    cluster design takes (the wrappers route them to the split design:
    three and four kernels a call, one elsewhere): statistics 1e-6 relative
    (f64 sums in another order), y and dx within 1e-5 of their largest
    magnitude (f32) or 1 bf16 ulp of it, the parameter gradients within 1e-5
    of their scale; one counted call each, and the cluster design's outputs
    bit-equal when a call is repeated."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg

    g = torch.Generator(device=dev).manual_seed(21)
    classes = set()
    routes = {"route": (hg._group_norm_relu_cuda, hg._group_norm_relu_bwd_cuda),
              "split": (hg._group_norm_relu_split, hg._group_norm_relu_bwd_split)}
    for shape in ((4, 256, 16, 16), (3, 128, 32, 32), (2, 64, 9, 7), (3, 16, 4, 4),
                  (2, 36, 5, 5), (32, 128, 4, 4), (4, 128, 64, 64), (2, 256, 64, 64),
                  (2, 2048, 4, 4), (2, 300, 5, 5)):
        N, C = shape[:2]
        G = hg.num_groups(C)
        for dt in (torch.float32, torch.bfloat16):
            cl = lambda t: t.to(dt).contiguous(memory_format=torch.channels_last)
            x = cl(torch.randn(shape, device=dev, generator=g) * 2 + 0.5)
            dy = cl(torch.randn(shape, device=dev, generator=g))
            scale = torch.rand(C, device=dev, generator=g) + 0.5
            bias = torch.randn(C, device=dev, generator=g) * 0.2
            yp, mp, rp = hg.group_norm_relu_plain(x, scale, bias, G)
            p = hg.group_norm_relu_bwd_plain(x, dy, scale, bias, mp, rp)
            tol = 1e-5 if dt == torch.float32 else 2.0 ** -8
            cluster = hg._gn_plan("fwd", x, G) is not None
            assert (hg._gn_plan("bwd", x, G, dy) is not None) == cluster
            assert cluster == (C // (16 // x.element_size() if C * x.element_size() % 16 == 0
                                     else 1) <= hg.GN_THREADS)
            assert [_graph_kernels(lambda: hg._group_norm_relu_cuda(x, scale, bias, G)),
                    _graph_kernels(lambda: hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, mp,
                                                                        rp))] == (
                [1, 1] if cluster else [3, 4]), (shape, dt)
            for design, (fwd, bwd) in routes.items():
                kernels.reset_counts()
                yk, mk, rk = fwd(x, scale, bias, G)
                assert kernels.counts()["group_norm_relu"] == 1
                assert torch.allclose(mk, mp, rtol=1e-6, atol=1e-7), (shape, dt, design)
                assert torch.allclose(rk, rp, rtol=1e-6, atol=0), (shape, dt, design)
                d = (yk.float() - yp.float()).abs().max().item()
                assert d <= tol * yp.float().abs().max().item(), (shape, dt, design, d)
                assert yk.is_contiguous(memory_format=torch.channels_last)
                k = bwd(x, dy, scale, bias, mp, rp)
                assert kernels.counts()["group_norm_relu_bwd"] == 1
                for a, b in zip(k[1:], p[1:]):
                    assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1)
                d = (k[0].float() - p[0].float()).abs().max().item()
                assert d <= tol * p[0].float().abs().max().item(), (shape, dt, design, d)
                if design == "route" and cluster:
                    assert all(torch.equal(a, b) for a, b in zip(
                        (yk, mk, rk), hg._group_norm_relu_cuda(x, scale, bias, G)))
                    assert all(torch.equal(a, b) for a, b in zip(
                        k, hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, mp, rp)))
                    for kind, ts in (("fwd", (yk,)), ("bwd", (dy, k[0]))):
                        plan = hg._gn_plan(kind, x, G, *ts)
                        classes.add("k = 1, spp > 1" if plan.spp > 1 else "k = 1"
                                    if plan.k == 1 else "k > 1, on chip"
                                    if plan.keep == plan.iters else "k > 1, read again")
    assert classes >= {"k = 1, spp > 1", "k > 1, on chip", "k > 1, read again"}, classes
    for w in hg._gn_work.values():
        assert not w[0].any()


def test_k20_k21_cluster_one_launch_and_graph_replay(dev):
    """The cluster design's K20 and K21 are one kernel a call (the kernel
    nodes of a captured graph); a graph that captures a K20 + K21 pair
    replays to the eager call's bits; the workspace counters are back at 0."""
    from suo_slam_tpu_torch.models import hourglass as hg

    for shape in ((32, 256, 64, 64), (32, 128, 4, 4), (8, 64, 128, 128)):
        C = shape[1]
        G = hg.num_groups(C)
        for dt in (torch.float32, torch.bfloat16):
            cl = lambda t: t.to(dt).contiguous(memory_format=torch.channels_last)
            x = cl(torch.randn(shape, device=dev) * 1.5 + 0.3)
            dy = cl(torch.randn(shape, device=dev))
            scale = torch.rand(C, device=dev) + 0.5
            bias = torch.randn(C, device=dev) * 0.2
            _, mean, rstd = hg._group_norm_relu_cuda(x, scale, bias, G)
            calls = (lambda: hg._group_norm_relu_cuda(x, scale, bias, G),
                     lambda: hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, mean, rstd))
            assert [_graph_kernels(f) for f in calls] == [1, 1], (shape, dt)

            def pair():
                y, m, r = hg._group_norm_relu_cuda(x, scale, bias, G)
                return (y, m, r) + hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, m, r)

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                pair()  # the capture stream's workspace, made before the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = pair()
            graph.replay()
            torch.cuda.synchronize()
            eager = pair()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, eager)), (shape, dt)
            graph.reset()
            for w in hg._gn_work.values():
                assert not w[0].any()