"""Port parity: `suo_slam_tpu_torch.core` (lie, geometry) against the JAX
package, same numpy inputs on both sides. Tolerance 1e-6 in f32 (a few ulps
of the unit-scale outputs) and 1e-12 in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from suo_slam_tpu.core import geometry as jgeo
from suo_slam_tpu.core import lie as jlie
from suo_slam_tpu_torch.core import geometry as tgeo
from suo_slam_tpu_torch.core import lie as tlie

TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _tangent(rng, n, dtype, small=False):
    xi = rng.normal(size=(n, 6)) * (1e-5 if small else 1.0)
    return xi.astype(dtype)


def _poses(rng, n, dtype):
    xi = rng.normal(size=(n, 6))
    return np.asarray(jlie.se3_exp(jnp.asarray(xi))).astype(dtype)


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["hat", "so3_exp", "se3_exp"])
def test_exp_maps(fn, dtype):
    rng = np.random.default_rng(0)
    for small in (False, True):
        xi = _tangent(rng, 64, dtype, small)
        x = xi[:, :3] if fn != "se3_exp" else xi
        _close(getattr(jlie, fn)(jnp.asarray(x)), getattr(tlie, fn)(torch.from_numpy(x)),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_logs_vee_inverse(dtype):
    rng = np.random.default_rng(1)
    T = _poses(rng, 64, dtype)
    T[0, :3, :3] = np.eye(3)  # the small-angle branch
    tT = torch.from_numpy(T)
    _close(jlie.se3_log(jnp.asarray(T)), tlie.se3_log(tT), dtype)
    _close(jlie.so3_log(jnp.asarray(T[:, :3, :3])), tlie.so3_log(tT[:, :3, :3]), dtype)
    _close(jlie.vee(jnp.asarray(T[:, :3, :3])), tlie.vee(tT[:, :3, :3]), dtype)
    _close(jlie.invert_SE3(jnp.asarray(T)), tlie.invert_SE3(tT), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quaternion_round_trip(dtype):
    rng = np.random.default_rng(2)
    R = _poses(rng, 128, dtype)[:, :3, :3]
    R[0] = np.diag([1.0, -1.0, -1.0])  # theta = pi: the x-candidate branch
    q_j = jlie.R_to_quat(jnp.asarray(R))
    q_t = tlie.R_to_quat(torch.from_numpy(R))
    _close(q_j, q_t, dtype)
    _close(jlie.quat_to_R(q_j), tlie.quat_to_R(q_t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_geometry(dtype):
    rng = np.random.default_rng(3)
    K = np.array([[600.0, 0, 320.0], [0, 610.0, 240.0], [0, 0, 1.0]], dtype)
    np.testing.assert_array_equal(np.asarray(jgeo.k_to_cam4(jnp.asarray(K))),
                                  tgeo.k_to_cam4(torch.from_numpy(K)).numpy())
    cam_k = rng.uniform(0.5, 2.0, (7, 4)).astype(dtype)
    pts = rng.uniform(-1, 1, (7, 3)).astype(dtype)
    pts[:, 2] += 3.0
    pts[0, 2] = 0.0  # the z clamp
    uv_j, z_j = jgeo.project_k4(jnp.asarray(cam_k), jnp.asarray(pts))
    uv_t, z_t = tgeo.project_k4(torch.from_numpy(cam_k), torch.from_numpy(pts))
    np.testing.assert_allclose(np.asarray(uv_j)[1:], uv_t.numpy()[1:],
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(np.asarray(uv_j)[0], uv_t.numpy()[0], rtol=TOL[dtype])
    np.testing.assert_array_equal(np.asarray(z_j), z_t.numpy())


def test_fix_K_matches_the_jax_engine():
    from suo_slam_tpu.slam.engine import _fix_K_np as j_fix
    from suo_slam_tpu_torch.slam.engine import _fix_K_np as t_fix

    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]])
    for bbox in ([10.0, 20.0, 110.0, 220.0], [-5.0, 3.5, 40.25, 90.0]):
        np.testing.assert_array_equal(j_fix(K, bbox), t_fix(K, bbox))
