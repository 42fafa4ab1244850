"""`eval/render.render_shaded` of the port against the JAX package's, bit
for bit (the same numpy arithmetic, tolerance 0) in RGB and depth: a
cuboid and a random closed mesh of 3,072 triangles, under the labeling
panel's views, an oblique pose, a pose partly past the image's edge and
one behind the near plane, at the default and the symmetry viewer's
colour."""

import numpy as np
import pytest

from suo_slam_tpu.eval import render as jrender
from suo_slam_tpu_torch.eval import render as trender
from suo_slam_tpu_torch.tools.labeling import canonical_view_poses
from tests.helpers.meshes import torus_mesh
from tests.helpers.synthetic_bop import CUBOID_TRIS, OBJ_HALF_EXTENTS, cuboid_corners

K = np.array([[420.0, 0, 160.0], [0, 420.0, 120.0], [0, 0, 1.0]])
MESHES = {"cuboid": (cuboid_corners(*OBJ_HALF_EXTENTS[1]), CUBOID_TRIS),
          "torus": torus_mesh(seed=1)}


def _poses(diameter):
    rng = np.random.default_rng(2)
    poses = list(canonical_view_poses(diameter))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    for t in ([5.0, -8.0, 2.5 * diameter], [0.9 * diameter, 0.0, 1.5 * diameter],
              [0.0, 0.0, 0.2 * diameter]):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T)
    poses.append(poses[-1][:3])  # a [3, 4] pose
    return poses


@pytest.mark.parametrize("color", [(200, 200, 200), (80, 220, 220)])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_render_shaded_is_bit_equal_to_jax(mesh, color):
    verts, faces = MESHES[mesh]
    diameter = 2.0 * float(np.linalg.norm(verts - verts.mean(0), axis=1).max())
    drawn = 0
    for T in _poses(diameter):
        rgb_t, d_t = trender.render_shaded(verts, faces, K, T, (240, 320), color=color)
        rgb_j, d_j = jrender.render_shaded(verts, faces, K, T, (240, 320), color=color)
        assert rgb_t.dtype == rgb_j.dtype and d_t.dtype == d_j.dtype
        np.testing.assert_array_equal(rgb_t, rgb_j)
        np.testing.assert_array_equal(d_t, d_j)
        drawn += int((d_t > 0).any())
    assert drawn >= 9  # all but the pose behind the near plane draw


def test_render_shaded_without_faces_is_black():
    verts, _ = MESHES["cuboid"]
    T = canonical_view_poses(100.0)[0]
    rgb, d = trender.render_shaded(verts, None, K, T, (24, 32))
    assert not rgb.any() and not d.any() and rgb.shape == (24, 32, 3)
