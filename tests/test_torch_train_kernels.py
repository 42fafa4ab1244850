"""The plain versions of the training kernels against `jax.vjp` of the JAX
package's functions, on the CPU:

- K16 + K8 (forward) and K17 (backward): flax `MaskedBatchNorm(train=True)`
  followed by `nn.relu` — output, updated running statistics, and the
  gradients of x, scale and bias — in f32 and bf16, with no padded row,
  some padded rows, and no row mask;
- K17 with fixed statistics: the inference form's gradients;
- K18: `up1 + upsample2x(low)`;
- K19: `spatial_softmax` -> `soft_argmax` and the mean pool of the logits,
  as `PkpNet` reads them out, plain and transposed.

Tolerances, relative to each tensor's largest magnitude: f32 1e-5 (sums in
another order); bf16 outputs 1 bf16 ulp (2^-8: the f32 affine rounds once to
bf16 in both, after f32 values that differ in their last bits), bf16 input
gradients 2^-7: JAX adds the cotangents of its two casts of x (the
statistics' and the normalization's) in bf16, each rounded, where the port
rounds their f32 sum once; both stay within an ulp of the exact sum. K18 in
bf16: 2^-6, as JAX rounds each add of its reduce to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.models.hourglass import MaskedBatchNorm as JaxBN
from suo_slam_tpu.models.hourglass import upsample2x
from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu_torch.models import hourglass as hg
from suo_slam_tpu_torch.ops import heatmap as thm

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MASKS = {"all_real": [1, 1, 1, 1, 1], "padded": [1, 0, 1, 1, 0], "none": None}


def _cl(a_nhwc: np.ndarray, dtype) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last torch tensor (no copy of the layout)."""
    return torch.from_numpy(np.array(a_nhwc, np.float32)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bn_case(seed, dt):
    rng = np.random.default_rng(seed)
    N, H, W, C = 5, 6, 4, 8
    x = (rng.normal(size=(N, H, W, C)) * 1.5 + rng.normal(size=C)).astype(np.float32)
    dy = rng.normal(size=(N, H, W, C)).astype(np.float32)
    if dt == "bf16":  # values both sides hold exactly
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dy = np.asarray(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.normal(size=C).astype(np.float32) * 0.3}
    s = {"mean": rng.normal(size=C).astype(np.float32) * 0.1,
         "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return x, dy, p, s


@pytest.mark.parametrize("mask_kind", list(MASKS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_masked_batchnorm_train_matches_jax_vjp(dt, mask_kind):
    jdt, tdt = DT[dt]
    x, dy, p, s = _bn_case(0, dt)
    m = MASKS[mask_kind]
    jm = None if m is None else jnp.asarray(np.asarray(m, bool))

    def f(xx, scale, bias):
        y, upd = JaxBN().apply({"params": {"scale": scale, "bias": bias}, "batch_stats": s},
                               xx, True, jm, mutable=["batch_stats"])
        return jax.nn.relu(y), upd["batch_stats"]

    yj, vjp, stats_j = jax.vjp(f, jnp.asarray(x, jdt), p["scale"], p["bias"], has_aux=True)
    dxj, dsj, dbj = vjp(jnp.asarray(dy, jdt))

    bn = hg.MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.mean.copy_(torch.from_numpy(s["mean"]))
        bn.var.copy_(torch.from_numpy(s["var"]))
    xt = _cl(x, tdt).requires_grad_(True)
    yt = bn(xt, train=True, row_mask=None if m is None else torch.tensor(m, dtype=torch.bool))
    assert yt.dtype == tdt and yt.is_contiguous(memory_format=torch.channels_last)
    yt.backward(_cl(dy, tdt))

    tol_y, tol_g = (1e-5, 1e-5) if dt == "f32" else (2.0 ** -8, 2.0 ** -7)
    assert _rel(_nhwc(yt), np.asarray(yj, np.float32)) <= tol_y
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(stats_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert _rel(_nhwc(xt.grad), np.asarray(dxj, np.float32)) <= tol_g
    assert _rel(bn.scale.grad.numpy(), np.asarray(dsj)) <= tol_g
    assert _rel(bn.bias.grad.numpy(), np.asarray(dbj)) <= tol_g
    if m is not None and not all(m):  # padded rows reach their own dx
        pad = [i for i, v in enumerate(m) if not v]
        assert np.abs(_nhwc(xt.grad)[pad]).max() > 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fixed_statistics_backward_matches_jax_vjp(dt):
    """The inference form (running statistics) under autograd: K8 forward,
    K17 with the statistics' terms off."""
    jdt, tdt = DT[dt]
    x, dy, p, s = _bn_case(1, dt)

    def f(xx, scale, bias):
        return jax.nn.relu(JaxBN().apply({"params": {"scale": scale, "bias": bias},
                                          "batch_stats": s}, xx, False))

    yj, vjp = jax.vjp(f, jnp.asarray(x, jdt), p["scale"], p["bias"])
    dxj, dsj, dbj = vjp(jnp.asarray(dy, jdt))
    bn = hg.MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        for k, v in {**p, **s}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    xt = _cl(x, tdt).requires_grad_(True)
    yt = bn(xt)
    yt.backward(_cl(dy, tdt))
    tol_y, tol_g = (1e-5, 1e-5) if dt == "f32" else (2.0 ** -8, 2.0 ** -7)
    assert _rel(_nhwc(yt), np.asarray(yj, np.float32)) <= tol_y
    assert _rel(_nhwc(xt.grad), np.asarray(dxj, np.float32)) <= tol_g
    assert _rel(bn.scale.grad.numpy(), np.asarray(dsj)) <= tol_g
    assert _rel(bn.bias.grad.numpy(), np.asarray(dbj)) <= tol_g


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_upsample_add_backward_matches_jax_vjp(dt):
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(2)
    up1 = rng.normal(size=(2, 8, 6, 5)).astype(np.float32)
    low = rng.normal(size=(2, 4, 3, 5)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 6, 5)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: a + upsample2x(b), jnp.asarray(up1, jdt),
                       jnp.asarray(low, jdt))
    dup1_j, dlow_j = vjp(jnp.asarray(dy, jdt))
    a = _cl(up1, tdt).requires_grad_(True)
    b = _cl(low, tdt).requires_grad_(True)
    o = hg.upsample_add(a, b)
    o.backward(_cl(dy, tdt))
    assert _rel(_nhwc(o), np.asarray(out, np.float32)) <= (1e-6 if dt == "f32" else 0.0)
    assert np.array_equal(_nhwc(a.grad), np.asarray(dup1_j, np.float32))
    # bf16: JAX's reduce over the broadcast axes rounds each of its three adds
    # to bf16, K18 the f32 sum once: a few ulps apart at the sum's scale
    assert _rel(_nhwc(b.grad), np.asarray(dlow_j, np.float32)) <= (
        1e-6 if dt == "f32" else 2.0 ** -6)
    assert b.grad.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("transposed", [False, True])
def test_readout_backward_matches_jax_vjp(transposed):
    rng = np.random.default_rng(3)
    N, H, W, K = 3, 16, 12, 5
    logits = (rng.normal(size=(N, H, W, K)) * 3).astype(np.float32)
    g_uv = rng.normal(size=(N, K, 2)).astype(np.float32)
    g_cov = rng.normal(size=(N, K, 2, 2)).astype(np.float32) * 10
    g_pool = rng.normal(size=(N, K)).astype(np.float32)

    def f(raw):
        if transposed:
            raw = jnp.swapaxes(raw, 1, 2)
        uv, cov = jhm.soft_argmax(jhm.spatial_softmax(raw))
        return uv, cov, jnp.mean(raw, axis=(1, 2))

    (uv_j, cov_j, pool_j), vjp = jax.vjp(f, jnp.asarray(logits))
    (dl_j,) = vjp((jnp.asarray(g_uv), jnp.asarray(g_cov), jnp.asarray(g_pool)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    raw = lt.transpose(1, 2) if transposed else lt
    uv, cov, pooled = thm.heatmap_readout(raw)
    torch.autograd.backward([uv, cov, pooled], [torch.from_numpy(g) for g in
                                                 (g_uv, g_cov, g_pool)])
    for a, b in ((uv, uv_j), (cov, cov_j), (pooled, pool_j)):
        assert _rel(a.detach().numpy(), np.asarray(b)) <= 1e-5
    assert _rel(lt.grad.numpy(), np.asarray(dl_j)) <= 1e-5
    # an output without a gradient counts as zero
    lt.grad = None
    uv, cov, pooled = thm.heatmap_readout(raw)
    uv.sum().backward()
    (dl_uv,) = vjp((jnp.ones_like(uv_j), jnp.zeros_like(cov_j), jnp.zeros_like(pool_j)))
    assert _rel(lt.grad.numpy(), np.asarray(dl_uv)) <= 1e-5


def test_heatmap_variance_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 0.5, (2, 3, 2)).astype(np.float32)
    prob_j = jhm.spatial_softmax(jnp.asarray(logits))
    want = np.asarray(jhm.heatmap_variance(prob_j, jnp.asarray(uv)))
    got = thm.heatmap_variance(thm.spatial_softmax(torch.from_numpy(logits)),
                               torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
