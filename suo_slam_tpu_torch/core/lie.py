"""Batched SO(3)/SE(3) Lie-group operations in PyTorch.

Port of `suo_slam_tpu/core/lie.py`: shape-polymorphic over leading batch
dimensions, dtype preserving (f32 on the card, f64 in the CPU tests), with
branch-free small-angle Taylor fallbacks (`torch.where`).

Conventions: rotations are 3x3; poses [..., 4, 4]; `se3_exp` takes the
tangent [omega, v] with t = V(omega) @ v.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe at theta ~ 0. [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.sqrt(safe_t2))
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    W = hat(w)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of SO(3) via the quaternion, [..., 3, 3] -> [..., 3]."""
    q = R_to_quat(R)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-8
    safe_n = torch.where(small, 1.0, n)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12), theta / safe_n)
    return scale[..., None] * qv


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    safe_t3 = safe_t2 * torch.sqrt(safe_t2)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    W = hat(w)
    return _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half))) / safe_t2,
    )
    W = hat(w)
    return _eye3_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # the row (0, 0, 0, 1) of an identity: a Python scalar assigned into a
    # CUDA tensor would be a blocking host-to-device copy
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def to_4x4(T: torch.Tensor) -> torch.Tensor:
    """Promote [..., 3, 4] to [..., 4, 4]; pass [..., 4, 4] through."""
    if T.shape[-2] == 4:
        return T
    return make_T(T[..., :3, :3], T[..., :3, 3])


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """T_a @ T_b for [..., 3/4, 4] poses, returns [..., 4, 4]."""
    return to_4x4(Ta) @ to_4x4(Tb)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] tangent [omega, v] -> [..., 4, 4] pose with t = V(omega) v."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] or [..., 3, 4] -> [..., 6] tangent [omega, v]."""
    w = so3_log(T[..., :3, :3])
    v = (_left_jacobian_inv(w) @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def invert_SE3(T: torch.Tensor) -> torch.Tensor:
    """Batched SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3][..., None])[..., 0])


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [..., 4] (w, x, y, z), branch-free
    Shepperd selection of the best-conditioned candidate."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(cands, dim=-1, keepdim=True)
    s = torch.sqrt(torch.clamp(torch.gather(cands, -1, idx)[..., 0], min=1e-12)) * 2.0
    q_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    q_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    q_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    q_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)
    all_q = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # [..., 4 candidates, 4]
    q = torch.gather(all_q, -2, idx[..., None].expand(idx.shape[:-1] + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def euler2R(euler_deg: torch.Tensor) -> torch.Tensor:
    """ZYX-style Euler [..., 3] = (gamma, beta, alpha) in degrees -> R
    [..., 3, 3], the convention that discretizes continuous symmetries."""
    g, b, a = torch.deg2rad(euler_deg).movedim(-1, 0)
    ca, cb, cg = torch.cos(a), torch.cos(b), torch.cos(g)
    sa, sb, sg = torch.sin(a), torch.sin(b), torch.sin(g)
    return torch.stack(
        [
            torch.stack([ca * cb, ca * sb * sg - sa * cg, ca * sb * cg + sa * sg], -1),
            torch.stack([sa * cb, sa * sb * sg + ca * cg, sa * sb * cg - ca * sg], -1),
            torch.stack([-sb, cb * sg, cb * cg], -1),
        ],
        dim=-2,
    )
