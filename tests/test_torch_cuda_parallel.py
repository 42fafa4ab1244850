"""Card tests of this slice's kernels (marked `cuda`; they skip without a
card; this file imports only the port, so it runs on the card's machine with
`python -m pytest tests/test_torch_cuda_parallel.py -m cuda -q
--noconftest`):

- K16 / K17's cross-rank modes (partial sums + finalize; sums + dx) through
  a group of one rank, against the fused kernels bit for bit (one rank sums
  the fused kernels' partial rows in their order) and against their plain
  versions (sums 1e-12 relative, the finalize exact, dx 1e-5 of its max in
  f32 and 2^-8 in bf16), on an uneven row mask;
- `ba.lm_run` and the compat shims on CUDA tensors: K4 + K7 each LM
  iteration (K14 never), `lambdatwist.pnp` one K15 launch, each within
  1e-4 of its CPU run.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from suo_slam_tpu_torch import _device
    from suo_slam_tpu_torch.kernels import build_all

    d = _device.resolve_device("cuda")
    build_all()
    return d


@pytest.fixture(scope="module")
def group(dev, tmp_path_factory):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path_factory.mktemp("pg") / "init"), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(12, 64, 16, 16), (32, 256, 8, 8), (7, 40, 5, 3)])
def test_k16_k17_cross_rank_modes(dev, group, dt, shape):
    from suo_slam_tpu_torch.models import hourglass as hg

    g = torch.Generator().manual_seed(0)
    N, C = shape[:2]
    mask = (torch.arange(N) % 4 != 3).to(torch.uint8).to(dev)
    cl = lambda t: t.to(dt).to(dev).contiguous(memory_format=torch.channels_last)
    x = cl(torch.randn(shape, generator=g) * 1.5 + torch.randn(1, C, 1, 1, generator=g))
    dy = cl(torch.randn(shape, generator=g))
    scale = (torch.rand(C, generator=g) + 0.5).to(dev)
    bias = (torch.randn(C, generator=g) * 0.3).to(dev)
    rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
    fused = hg.bn_train_stats(x, mask, scale, bias, 1e-5, rm.clone(), rv.clone())
    r1, v1 = rm.clone(), rv.clone()
    cross = hg.bn_train_stats_cross(x, mask, scale, bias, 1e-5, r1, v1, group=group)
    r0, v0 = rm.clone(), rv.clone()
    hg.bn_train_stats(x, mask, scale, bias, 1e-5, r0, v0)
    for a, b in zip(fused + (r0, v0), cross + (r1, v1)):
        assert torch.equal(a, b)
    sums = hg._bn_stats_partial_cuda(x, mask)
    assert _rel(sums, hg.bn_stats_partial_plain(x, mask)) <= 1e-12
    k = hg._bn_stats_finalize_cuda(sums, scale, bias, 1e-5)
    p = hg.bn_stats_finalize_plain(sums, scale, bias, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    mean, _, rstd, inv, shift = fused
    f = hg.norm_relu_bwd(x, dy, inv, shift, mean, rstd, mask)
    c = hg.norm_relu_bwd_cross(x, dy, inv, shift, mean, rstd, mask, group)
    for a, b in zip(f, c):
        assert torch.equal(a, b)
    s17 = hg._norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, mask)[0]
    assert _rel(s17, hg.norm_relu_bwd_sums_plain(x, dy, inv, shift, mean, rstd, mask)[0]) <= 1e-12
    dx = hg._norm_relu_bwd_dx_cuda(x, dy, inv, shift, mean, rstd, mask, s17).float()
    pdx = hg.norm_relu_bwd_dx_plain(x, dy, inv, shift, mean, rstd, mask, s17).float()
    assert _rel(dx, pdx) <= (1e-5 if dt == torch.float32 else 2.0 ** -8)


def _pose_gap(a, b, scale):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return max(np.abs(a[..., :3, :3] - b[..., :3, :3]).max(),
               np.abs(a[..., :3, 3] - b[..., :3, 3]).max() / scale)


@pytest.mark.cuda
def test_compat_on_the_card_launches_k4_k7_k15(dev):
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.compat import g2o, lambdatwist

    rng = np.random.default_rng(0)
    k4 = np.array([1.2, 1.2, 0.0, 0.0])
    est = {}
    for d in ("cpu", "cuda"):
        r = np.random.default_rng(0)
        opt = g2o.SparseOptimizer(device=d)
        verts = []
        for i in range(2):
            v = g2o.VertexSE3Expmap()
            v.set_id(i)
            T = np.eye(4)
            T[:3, 3] = [60.0 * i - 30.0, 0.0, 600.0]
            v.set_estimate(g2o.SE3Quat(T[:3, :3], T[:3, 3]))
            opt.add_vertex(v)
            verts.append(v)
        cams = []
        for i in range(2):
            v = g2o.VertexSE3Expmap()
            v.set_id(2 + i)
            v.set_estimate(g2o.SE3Quat(np.eye(3), [3.0 * i, -2.0 * i, 4.0 * i]))
            v.set_fixed(i == 0)
            opt.add_vertex(v)
            cams.append(v)
        pts = r.uniform(-40, 40, (2, 12, 3))
        for j in range(2):
            for i in range(2):
                for p in pts[j]:
                    pc = p + np.array([60.0 * j - 30.0 + 5.0 * i, 0.0, 600.0])
                    e = g2o.EdgeSE3ProjectFromObject(k4, p)
                    e.set_vertex(0, verts[j])
                    e.set_vertex(1, cams[i])
                    e.set_measurement(1.2 * pc[:2] / pc[2] + r.normal(0, 1e-3, 2))
                    e.set_information(np.eye(2) * 1e4)
                    opt.add_edge(e)
        opt.initialize_optimization(0)
        kernels.reset_counts()
        opt.optimize(20)
        c = kernels.counts()
        if d == "cuda":
            assert c["ba_edges"] > 0 and c["ba_schur"] > 0 and c["ba_lm"] == 0
        else:
            assert sum(c.values()) == 0
        est[d] = [v.estimate().matrix() for v in verts + cams]
    for a, b in zip(est["cpu"], est["cuda"]):
        assert _pose_gap(b, a, 600.0) <= 1e-4
    x = rng.uniform(-0.5, 0.5, (41, 3))
    t = np.array([0.1, -0.05, 2.0])
    pc = x + t
    kernels.reset_counts()
    T = lambdatwist.pnp(x, pc[:, :2] / pc[:, 2:3])
    assert kernels.counts()["pnp_ransac"] == 1
    gt = np.eye(4)
    gt[:3, 3] = t
    assert _pose_gap(T, gt, 2.0) <= 1e-4
