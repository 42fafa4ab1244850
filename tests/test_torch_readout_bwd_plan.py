"""K19's host planner and the dense design's arithmetic, on the CPU.

- `plan_readout_bwd` sends the head's channels-last logits (an NHWC view of
  a channels_last NCHW tensor, and its transpose under transpose_heatmaps)
  to the dense path — K2's cluster of `READOUT_CLUSTER` CTAs per crop, a
  strip of ceil(outer / cluster) storage rows a CTA — and any other layout
  to the strided path; its shared memory a CTA (the strip kept whole, the
  per-thread moments, the exchange buffers, and the kernel's static arrays)
  fits the card's 227 KB at every shape the dense geometry admits, and two
  CTAs fit an SM at the train step's [32, 64, 64, 41] f32 and bf16.
- A numpy model of the dense kernel (per-rank strips in storage order, the
  moments in storage coordinates combined in rank order, d logit formed per
  stored element with u and v taken from the row's and the inner
  coordinate as `transposed` says) equals the plain backward in f64.
- The plain backward on the dense layout's strides (and transposed) against
  `jax.vjp` of the JAX package's `spatial_softmax` -> `soft_argmax` and the
  mean pool, as `PkpNet` reads the logits out (f32: 1e-5 of the largest
  gradient, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu_torch.ops import heatmap as thm

CL = thm.READOUT_CLUSTER


def _head_logits(a_nchw: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """The head's logits as the net hands them to the readout: an NHWC view
    of a channels_last NCHW tensor."""
    t = torch.from_numpy(a_nchw).to(dtype).contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


def _plan(t: torch.Tensor, path=None):
    return thm.plan_readout_bwd(t.shape, t.stride(), t.element_size(), t.data_ptr(), path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["head", "head_transposed", "nhwc", "nchw_view", "sliced"])
def test_route_by_layout(layout, dtype):
    N, K, H, W = 3, 41, 64, 48
    a = np.zeros((N, K, H, W), np.float32)
    head = _head_logits(a, dtype)
    t = {"head": head, "head_transposed": head.transpose(1, 2),
         "nhwc": torch.zeros((N, H, W, K), dtype=dtype),
         "nchw_view": torch.zeros((N, K, H, W), dtype=dtype).permute(0, 2, 3, 1),
         "sliced": torch.zeros((N, H, W, K + 3), dtype=dtype)[..., :K]}[layout]
    p = _plan(t)
    if layout in ("nchw_view", "sliced"):
        assert p.path == thm.STRIDED
        with pytest.raises(ValueError, match="dense path cannot take"):
            _plan(t, thm.DENSE)
        return
    assert p.path == thm.DENSE and p.transposed == (layout == "head_transposed")
    _, Hv, Wv, _ = t.shape
    A, Bd = (Wv, Hv) if p.transposed else (Hv, Wv)
    assert (p.A, p.Bd) == (A, Bd)
    assert p.rows == -(-A // CL) and p.rows * CL >= A > (p.rows - 1) * CL
    J = Bd // thm.READOUT_PER
    assert p.threads == -(-J * K // 32) * 32 and 6 * K <= p.threads <= thm.READOUT_MAX_THREADS
    es = t.element_size()
    assert p.smem == p.rows * Bd * K * es + 6 * p.threads * 4 + CL * K * 7 * 4
    # forcing the strided path is allowed; the forward's planner agrees on the route
    assert _plan(t, thm.STRIDED).path == thm.STRIDED
    assert thm.plan_readout(t.shape, t.stride(), es, t.data_ptr()).path == thm.DENSE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_shared_memory_at_the_train_shapes(transposed, dtype):
    """[32, 64, 64, 41]: 8 rows a CTA; f32 84 KB of strip, bf16 42 KB;
    two CTAs an SM (228 KB, 1 KB reserved each)."""
    t = _head_logits(np.zeros((32, 41, 64, 64), np.float32), dtype)
    t = t.transpose(1, 2) if transposed else t
    p = _plan(t)
    assert p.path == thm.DENSE and p.rows == 8 and p.threads == 352
    strip = 8 * 64 * 41 * t.element_size()
    assert strip == {torch.float32: 83968, torch.bfloat16: 41984}[dtype]
    total = p.smem + thm.READOUT_BWD_STATIC
    assert total <= thm.CTA_SMEM and 2 * (total + 1024) <= 228 * 1024


def test_shared_memory_fits_at_the_dense_limits():
    """The largest strip the dense geometry admits with the most threads and
    channels still fits one CTA."""
    worst = (thm.READOUT_STRIP_BYTES + 6 * thm.READOUT_MAX_THREADS * 4
             + CL * thm.READOUT_MAX_K * 7 * 4 + thm.READOUT_BWD_STATIC)
    assert worst <= thm.CTA_SMEM
    for shape in ((2, 256, 128, 40), (1, 64, 512, 16), (4, 128, 128, 64)):
        t = torch.zeros(shape, dtype=torch.float32)
        p = _plan(t)
        if p.path == thm.DENSE:
            assert p.smem + thm.READOUT_BWD_STATIC <= thm.CTA_SMEM, shape


def _dense_model(x: np.ndarray, transposed: bool, g_uv, g_cov, g_pool) -> np.ndarray:
    """numpy (f64) model of `heatmap_readout_bwd_kernel_dense` on [N, H, W,
    K] logits: each crop's storage slab [A, Bd, K], rank r's strip of rows,
    the moments in storage coordinates summed per rank and combined in rank
    order, pass 3 per stored element; returns dl [N, H, W, K]."""
    N, H, W, K = x.shape
    slab = np.swapaxes(x, 1, 2) if transposed else x  # [N, A, Bd, K]
    A, Bd = slab.shape[1:3]
    rows = -(-A // CL)
    ca_all = (np.arange(A) + 0.5) / (0.5 * A)
    ca_all = ca_all - 1.0 if transposed else 1.0 - ca_all
    cb = (np.arange(Bd) + 0.5) / (0.5 * Bd)
    cb = 1.0 - cb if transposed else cb - 1.0
    out = np.empty_like(slab)
    for n in range(N):
        strips = [slab[n, r * rows:(r + 1) * rows] for r in range(CL)]
        cas = [ca_all[r * rows:(r + 1) * rows] for r in range(CL)]
        shift = np.max([s.max(axis=(0, 1)) if len(s) else np.full(K, -np.inf) for s in strips],
                       axis=0)
        mom = np.zeros((6, K))
        for s, ca in zip(strips, cas):
            if not len(s):
                continue
            e = np.exp(s - shift)                      # [rows, Bd, K]
            s0, s1, s2 = e.sum(1), (e * cb[None, :, None]).sum(1), (e * (cb * cb)[None, :, None]).sum(1)
            c = ca[:, None]
            mom += np.stack([s0.sum(0), (c * s0).sum(0), s1.sum(0), (c * c * s0).sum(0),
                             s2.sum(0), (c * s1).sum(0)])
        su, sv = (mom[1], mom[2]) if transposed else (mom[2], mom[1])
        suu, svv = (mom[3], mom[4]) if transposed else (mom[4], mom[3])
        z = mom[0]
        eu, ev, euu, evv, euv = su / z, sv / z, suu / z, svv / z, mom[5] / z
        du, dv = g_uv[n, :, 0], g_uv[n, :, 1]
        dcuu, dcvv = g_cov[n, :, 0, 0], g_cov[n, :, 1, 1]
        dcuv = g_cov[n, :, 0, 1] + g_cov[n, :, 1, 0]
        ef = (du * eu + dv * ev + dcuu * (euu - 2 * eu * eu) + dcvv * (evv - 2 * ev * ev)
              + dcuv * (euv - 2 * eu * ev))
        for r, (s, ca) in enumerate(zip(strips, cas)):
            c = ca[:, None, None]
            b = cb[None, :, None]
            u, v = (c, b) if transposed else (b, c)
            e = np.exp(s - shift)
            f = (du * u + dv * v + dcuu * (u * u - 2 * eu * u) + dcvv * (v * v - 2 * ev * v)
                 + dcuv * (u * v - ev * u - eu * v))
            out[n, r * rows:r * rows + len(s)] = (e / z) * (f - ef) + g_pool[n] / (A * Bd)
    return np.swapaxes(out, 1, 2) if transposed else out


@pytest.mark.parametrize("transposed", [False, True])
def test_dense_model_matches_the_plain_backward(transposed):
    """H != W and an outer extent that leaves the last ranks' strips short
    or empty (A = 20: 3 rows a CTA, rank 7 gets none)."""
    rng = np.random.default_rng(7 + transposed)
    N, K, H, W = 2, 5, 20, 16  # storage rows: H of the NCHW tensor, in both views
    x = (rng.normal(size=(N, K, H, W)) * 3).astype(np.float64)
    g_uv = rng.normal(size=(N, K, 2))
    g_cov = rng.normal(size=(N, K, 2, 2)) * 10
    g_pool = rng.normal(size=(N, K))
    t = torch.from_numpy(x).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    t = t.transpose(1, 2) if transposed else t
    t32 = t.float()
    p = _plan(t32)
    assert p.path == thm.DENSE and p.transposed == transposed and p.A == 20
    ref = thm.heatmap_readout_bwd_plain(t, *(torch.from_numpy(a) for a in (g_uv, g_cov, g_pool)))
    mine = _dense_model(t.numpy(), transposed, g_uv, g_cov, g_pool)
    scale = np.abs(ref.numpy()).max()
    assert np.abs(mine - ref.numpy()).max() <= 1e-12 * scale


@pytest.mark.parametrize("transposed", [False, True])
def test_plain_backward_on_the_dense_layout_matches_jax_vjp(transposed):
    rng = np.random.default_rng(11 + transposed)
    N, K, H, W = 3, 5, 16, 24
    a = (rng.normal(size=(N, K, H, W)) * 3).astype(np.float32)
    g_uv = rng.normal(size=(N, K, 2)).astype(np.float32)
    g_cov = (rng.normal(size=(N, K, 2, 2)) * 10).astype(np.float32)
    g_pool = rng.normal(size=(N, K)).astype(np.float32)
    head = _head_logits(a)
    raw = head.transpose(1, 2) if transposed else head
    assert _plan(raw).path == thm.DENSE

    def f(logits):
        uv, cov = jhm.soft_argmax(jhm.spatial_softmax(logits))
        return uv, cov, jnp.mean(logits, axis=(1, 2))

    nhwc = np.ascontiguousarray(raw.numpy())
    _, vjp = jax.vjp(f, jnp.asarray(nhwc))
    (dl_j,) = vjp((jnp.asarray(g_uv), jnp.asarray(g_cov), jnp.asarray(g_pool)))
    dl = thm.heatmap_readout_bwd_plain(raw, *(torch.from_numpy(g) for g in
                                             (g_uv, g_cov, g_pool)))
    dl_j = np.asarray(dl_j)
    assert np.abs(dl.numpy() - dl_j).max() <= 1e-5 * np.abs(dl_j).max()
    # and through autograd, as the train step records it
    leaf = raw.detach().clone().requires_grad_(True)
    uv, cov, pooled = thm.heatmap_readout(leaf)
    torch.autograd.backward([uv, cov, pooled], [torch.from_numpy(g) for g in
                                                 (g_uv, g_cov, g_pool)])
    assert np.abs(leaf.grad.numpy() - dl_j).max() <= 1e-5 * np.abs(dl_j).max()
