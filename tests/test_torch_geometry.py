"""Port parity of the geometry and Lie helpers that `test_torch_core.py`
leaves out (`core/geometry.py`: transform_pts ... apply_homography_2d;
`core/lie.py`: to_4x4, compose, euler2R) against the JAX package, on the
same numpy inputs made from a seed, in f32 and f64. Tolerance: 1e-6 in f32
and 1e-12 in f64, relative to the largest magnitude of JAX's output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.core import geometry as jgeo
from suo_slam_tpu.core import lie as jlie
from suo_slam_tpu_torch.core import geometry as tgeo
from suo_slam_tpu_torch.core import lie as tlie
from tests.helpers.threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {np.float32: 1e-6, np.float64: 1e-12}
HW = (240, 320)


def _poses(rng, n, rows=4):
    R = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-50, 50, (n, 3)) + [0, 0, 600]
    return T[:, :rows]


def _K(rng, n, full=False):
    K = np.tile(np.eye(3), (n, 1, 1))
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(400, 600, n), rng.uniform(400, 600, n)
    K[:, 0, 2], K[:, 1, 2] = rng.uniform(300, 340, n), rng.uniform(220, 260, n)
    if full:  # the NDC fix-up's off-diagonal terms
        K[:, 0, 1] = rng.uniform(-5, 5, n)
        K[:, 1, 0] = rng.uniform(-5, 5, n)
    return K


def _bbox(rng, n):
    xy = rng.uniform(0, 400, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(20, 200, (n, 2))], -1)


def _cases(rng):
    """name -> (fn name, args of numpy arrays / plain values, module)."""
    B, N = 6, 17
    pts = rng.uniform(-60, 60, (B, N, 3))
    pts_cam = pts + [0, 0, 600]
    uv_ndc = rng.uniform(-1.3, 1.3, (B, N, 2))  # past the edges: the clip
    K = _K(rng, B)
    Kb = np.asarray(jgeo.fix_K_for_bbox_ndc(jnp.asarray(K), jnp.asarray(_bbox(rng, B))))
    return {
        "transform_pts": ("transform_pts", (_poses(rng, B), pts), tgeo, jgeo),
        "transform_pts 3x4 broadcast": ("transform_pts", (_poses(rng, 1, 3)[0], pts), tgeo, jgeo),
        "project": ("project", (_K(rng, B, full=True)[:, None], pts_cam[:, :, None]), tgeo, jgeo),
        "fix_K_for_bbox_ndc": ("fix_K_for_bbox_ndc", (K, _bbox(rng, B)), tgeo, jgeo),
        "ndc_to_pixels": ("ndc_to_pixels", (uv_ndc, HW), tgeo, jgeo),
        "pixels_to_ndc": ("pixels_to_ndc", (rng.uniform(-10, 330, (B, N, 2)), HW), tgeo, jgeo),
        "normalize_image_points": ("normalize_image_points",
                                   (_K(rng, B, full=True)[:, None], rng.uniform(0, 640, (B, N, 2))),
                                   tgeo, jgeo),
        "normalize_image_points ndc": ("normalize_image_points", (Kb[:, None], uv_ndc), tgeo, jgeo),
        "bbox_xywh_to_xyxy": ("bbox_xywh_to_xyxy", (rng.uniform(0, 300, (B, 4)),), tgeo, jgeo),
        "homography_ndc_to_full": ("homography_ndc_to_full", (K, Kb), tgeo, jgeo),
        "apply_homography_2d": ("apply_homography_2d",
                                (np.asarray(jgeo.homography_ndc_to_full(jnp.asarray(K),
                                                                        jnp.asarray(Kb))),
                                 uv_ndc), tgeo, jgeo),
        "to_4x4 3x4": ("to_4x4", (_poses(rng, B, 3),), tlie, jlie),
        "to_4x4 4x4": ("to_4x4", (_poses(rng, B),), tlie, jlie),
        "compose": ("compose", (_poses(rng, B, 3), _poses(rng, 1)[0]), tlie, jlie),
        "compose 4x4 3x4": ("compose", (_poses(rng, B), _poses(rng, B, 3)), tlie, jlie),
        "euler2R": ("euler2R", (rng.uniform(-360, 360, (B, N, 3)),), tlie, jlie),
    }


CASES = list(_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_helper_matches_jax(case, dtype):
    fn, args, tmod, jmod = _cases(np.random.default_rng(0))[case]
    j_args = [jnp.asarray(a.astype(dtype)) if isinstance(a, np.ndarray) else a for a in args]
    t_args = [torch.from_numpy(a.astype(dtype)) if isinstance(a, np.ndarray) else a
              for a in args]
    j_out, t_out = getattr(jmod, fn)(*j_args), getattr(tmod, fn)(*t_args)
    if not isinstance(j_out, tuple):
        j_out, t_out = (j_out,), (t_out,)
    for j, t in zip(j_out, t_out):
        j = np.asarray(j)
        assert t.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        assert t.shape == j.shape, (t.shape, j.shape)
        err = np.abs(t.numpy().astype(np.float64) - j).max() / np.abs(j).max()
        assert err <= TOL[dtype], f"{case}: {err:.3e} relative"
