"""Port parity for kernel K1's plain version: `roi_crop_batch` of the port
(CPU tensors) against the JAX `roi_crop_batch`, including out-of-bounds
boxes (replicate border), NaN/inf boxes and masked slots. atol 1e-5: both
sides sum the same two nonzero bilinear taps in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.ops import roi as jroi
from suo_slam_tpu_torch.ops import roi as troi

ATOL = 1e-5


def _both(img, boxes, mask, out_hw):
    j = np.asarray(jroi.roi_crop_batch(jnp.asarray(img), jnp.asarray(boxes),
                                       jnp.asarray(mask), out_hw))
    t = troi.roi_crop_batch(torch.from_numpy(img), torch.from_numpy(boxes),
                            torch.from_numpy(mask), out_hw).numpy()
    return j, t


CASES = {
    "inside": [[4.0, 6.0, 50.5, 40.25], [0.0, 0.0, 64.0, 48.0]],
    "out_of_bounds": [[-30.0, -12.0, 20.0, 15.0], [40.0, 30.0, 90.0, 70.0]],
    "degenerate": [[10.0, 10.0, 10.0, 10.0], [33.0, 5.0, 12.0, 40.0]],
    "non_finite": [[np.nan, 3.0, 20.0, 30.0], [0.0, -np.inf, np.inf, 40.0]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_matches_jax(case):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    boxes = np.asarray(CASES[case], np.float32)
    boxes = np.stack([boxes, boxes[::-1]])  # [B=2, O=2, 4]
    mask = np.ones((2, 2), bool)
    j, t = _both(img, boxes, mask, (24, 32))
    assert t.shape == (2, 2, 24, 32, 3)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(j, t, atol=ATOL, rtol=0)


def test_masked_slots_are_zero():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (1, 40, 40, 3)).astype(np.float32)
    boxes = np.asarray([[[2.0, 2.0, 30.0, 30.0], [np.nan] * 4, [5.0, 5.0, 16.0, 16.0]]],
                       np.float32)
    mask = np.asarray([[True, False, False]])
    j, t = _both(img, boxes, mask, (16, 16))
    np.testing.assert_allclose(j, t, atol=ATOL, rtol=0)
    assert not t[0, 1:].any()


def test_main_path_shapes_small_frame():
    """The engine's call: one frame, a power-of-two object bucket."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (1, 120, 160, 3)).astype(np.float32)
    x1 = rng.uniform(0, 100, 8)
    y1 = rng.uniform(0, 70, 8)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 60, 8), y1 + rng.uniform(10, 50, 8)],
                     -1)[None].astype(np.float32)
    mask = np.asarray([[True] * 6 + [False] * 2])
    j, t = _both(img, boxes, mask, (64, 64))
    np.testing.assert_allclose(j, t, atol=ATOL, rtol=0)
