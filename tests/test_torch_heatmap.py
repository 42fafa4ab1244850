"""Port parity for kernel K2's plain version: the port's heatmap readout (CPU
tensors) against the JAX `soft_argmax(spatial_softmax(.))` (what PkpNet
calls) and `soft_argmax_from_logits`. Tolerance 1e-5 on uv and cov: both sides
accumulate the same f32 moments over a 64x64 plane, in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu_torch.ops import heatmap as thm

TOL = 1e-5


def _logits(kind, shape=(3, 64, 64, 41), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "peaked":
        n, h, w, k = shape
        for i in range(n):
            for c in range(k):
                x[i, rng.integers(h), rng.integers(w), c] += 25.0
    elif kind == "flat":
        x *= 1e-3
    return x


@pytest.mark.parametrize("kind", ["random", "peaked", "flat"])
def test_readout_matches_two_step_jax(kind):
    x = _logits(kind)
    uv_j, cov_j = jhm.soft_argmax(jhm.spatial_softmax(jnp.asarray(x)))
    uv_t, cov_t, pooled_t = thm.heatmap_readout(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(uv_j), uv_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(cov_j), cov_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jnp.mean(jnp.asarray(x), axis=(1, 2))),
                               pooled_t.numpy(), atol=1e-6, rtol=0)


def test_readout_matches_fused_jax_and_takes_strided_views():
    x = _logits("peaked", seed=1)
    uv_j, cov_j, _ = jhm.soft_argmax_from_logits(jnp.asarray(x))
    # the PkpNet head comes as an NHWC view of a channels_last NCHW tensor;
    # transpose_heatmaps swaps H and W on top of it
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    view = nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    uv_t, cov_t, _ = thm.heatmap_readout(view)
    np.testing.assert_allclose(np.asarray(uv_j), uv_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(cov_j), cov_t.numpy(), atol=TOL, rtol=0)
    uv_jt, _, _ = jhm.soft_argmax_from_logits(jnp.swapaxes(jnp.asarray(x), 1, 2))
    uv_tt, _, _ = thm.heatmap_readout(view.transpose(1, 2))
    np.testing.assert_allclose(np.asarray(uv_jt), uv_tt.numpy(), atol=TOL, rtol=0)


def test_ndc_grid_and_spatial_softmax():
    u_j, v_j = jhm.ndc_grid(8, 12)
    u_t, v_t = thm.ndc_grid(8, 12)
    np.testing.assert_array_equal(np.asarray(u_j), u_t.numpy())
    np.testing.assert_array_equal(np.asarray(v_j), v_t.numpy())
    x = _logits("random", (2, 16, 16, 5))
    np.testing.assert_allclose(np.asarray(jhm.spatial_softmax(jnp.asarray(x))),
                               thm.spatial_softmax(torch.from_numpy(x)).numpy(),
                               atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_readout_on_bf16_logits_matches_jax(kind):
    """The int8 engine's bf16 logits (`int8_forward._readout`): l - max rounds
    to bf16 before the f32 exp, and the validity head's mean pools in f32.
    The bf16 values are exact in both; 1e-5 on uv and cov as above, 1e-6 on
    the pooled mean (f32 sums of the same values in another order)."""
    x = (_logits(kind, seed=2) * 4).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xj.astype(jnp.float32)), xt.float().numpy())
    uv_j, cov_j, _ = jhm.soft_argmax_from_logits(xj)
    pooled_j = jnp.mean(xj.astype(jnp.float32), axis=(1, 2))
    uv_t, cov_t, pooled_t = thm.heatmap_readout(xt)
    assert uv_t.dtype == cov_t.dtype == pooled_t.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(uv_j), uv_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(cov_j), cov_t.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(pooled_j), pooled_t.numpy(), atol=1e-6, rtol=0)
    if kind == "random":  # there the bf16 shift rounds: an f32 one moves uv off JAX's
        uv_f, _, _ = thm.heatmap_readout(xt.float())
        assert np.abs(uv_f.numpy() - np.asarray(uv_j)).max() > TOL
