"""Port parity for the prior path: kernel K5's plain version
(`render_prior_heatmaps` on CPU tensors) against the JAX
`render_prior_heatmaps` at 1e-6 (values lie in [0, 1] and both sides
evaluate the same f32 Gaussian), at the post_stem (64x64) and concat
(256x256) map sizes of the full-width net, with masked, NaN, infinite and
out-of-range keypoints; `prior_sigma_for`; and the with-prior frame
inference (K1 crop -> K5 render -> PkpNet) against the JAX `fn_p` for both
prior modes with a small converted net, at 2e-4 (two f32 conv stacks, as
tests/test_torch_pkpnet.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.ops import heatmap as jhm
from suo_slam_tpu.slam import kernels as jk
from suo_slam_tpu_torch.ops import heatmap as thm
from suo_slam_tpu_torch.slam import kernels as tk
from tests.test_torch_pkpnet import _pair


def _priors(rng, n=3, k=41):
    uv = rng.uniform(-0.9, 0.9, (n, k, 2)).astype(np.float32)
    mask = rng.uniform(size=(n, k)) < 0.7
    uv[0, 0] = (np.nan, 0.2)
    uv[0, 1] = (np.inf, -0.3)
    uv[0, 2] = (0.1, -np.inf)
    uv[1, 3] = (1.7, -2.5)   # clipped to the border
    uv[1, 4] = (-1.0, 1.0)
    mask[0, :3] = True        # non-finite but marked valid: still drawn as 0
    mask[1, 3:5] = True
    return uv, mask


@pytest.mark.parametrize("hw", [(64, 64), (256, 256)])
def test_render_prior_heatmaps_matches_jax(hw):
    uv, mask = _priors(np.random.default_rng(0))
    sigma = thm.prior_sigma_for(hw)
    pj = np.asarray(jhm.render_prior_heatmaps(jnp.asarray(uv), jnp.asarray(mask), hw=hw,
                                              sigma_px=jhm.prior_sigma_for(hw)))
    pt = thm.render_prior_heatmaps(torch.from_numpy(uv), torch.from_numpy(mask), hw, sigma)
    assert pt.shape == pj.shape == (3,) + hw + (41,) and pt.is_contiguous()
    np.testing.assert_allclose(pj, pt.numpy(), atol=1e-6, rtol=0)
    p = pt.numpy().transpose(0, 3, 1, 2)          # [n, k, h, w]
    drawn = mask & np.isfinite(uv).all(-1)
    assert not p[0, :3].any()                      # non-finite -> 0
    assert not p[~drawn].any()                     # masked -> 0
    assert np.isclose(p[drawn].max(axis=(1, 2)), 1.0, atol=0.05).all()  # peak ~1
    # the clipped keypoint peaks in the bottom-right corner (u = 1, v = -1)
    assert np.unravel_index(p[1, 3].argmax(), hw) == (hw[0] - 1, hw[1] - 1)


def test_prior_sigma_and_merge():
    for hw in ((64, 64), (256, 256), (32, 48)):
        assert thm.prior_sigma_for(hw) == jhm.prior_sigma_for(hw)
    assert thm.prior_sigma_for((256, 256)) == thm.PRIOR_SIGMA_PX == 14.0
    a, b = torch.rand(2, 8, 8, 3), torch.rand(2, 8, 8, 3)
    np.testing.assert_array_equal(np.asarray(jhm.max_merge_priors(a.numpy(), b.numpy())),
                                  thm.max_merge_priors(a, b).numpy())


@pytest.mark.parametrize("prior_mode", ["post_stem", "concat"])
def test_with_prior_frame_inference_matches_jax(prior_mode):
    jnet, v, tnet = _pair(prior_mode)
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    boxes = np.array([[10, 8, 70, 60], [40, 30, 120, 90], [0, 0, 16, 16]], np.float32)
    valid = np.array([True, True, False])
    prior_uv = rng.uniform(-0.8, 0.8, (3, 41, 2)).astype(np.float32)
    prior_valid = rng.uniform(size=(3, 41)) < 0.5
    fj = jk.make_frame_inference(jnet, v, (64, 64))
    ft = tk.make_frame_inference(tnet, (64, 64), device="cpu")
    args = (img, boxes, valid, prior_uv, prior_valid)
    out_j = fj(*[jnp.asarray(a) for a in args])
    out_t = ft(*[torch.from_numpy(a) for a in args])
    for name, a, b in zip(("uv", "cov", "kp_mask"), out_j, out_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=2e-4, rtol=0, err_msg=name)
    # the prior really entered the net: the prior-free program differs
    out_np = ft(*[torch.from_numpy(a) for a in args], has_prior=False)
    assert np.abs(out_np[0].numpy() - out_t[0].numpy()).max() > 1e-3
