"""Object symmetry handling.

Port of `suo_slam_tpu/core/symmetry.py`. BOP `models_info.json` lists
discrete symmetries as 4x4 transforms and continuous symmetries as (axis,
offset); each continuous symmetry is discretized into 64 steps and the
identity is prepended, giving a fixed per-object stack of candidate
transforms (numpy, host side). The discretized rotations are computed in f32
and stored as f64, as the JAX package computes them.

`pick_symmetry_transform` selects, for a GT pose T_OtoC, the symmetry T_s
minimizing the mean distance between the mean-subtracted keypoints under
T_OtoC @ T_s and under the labeled view pose, over a padded [S_max, 4, 4]
stack with a validity mask (torch, batched over the stack). The module
imports torch only there: the training loader's worker processes build the
stacks and never import torch.
"""

from __future__ import annotations

import numpy as np

N_DISCRETIZE = 64  # continuous-symmetry discretization steps


def _euler2R_f32(euler_deg: np.ndarray) -> np.ndarray:
    """ZYX Euler (gamma, beta, alpha in degrees) -> R, in f32."""
    g, b, a = np.deg2rad(np.asarray(euler_deg, np.float32))
    ca, cb, cg = np.cos(a), np.cos(b), np.cos(g)
    sa, sb, sg = np.sin(a), np.sin(b), np.sin(g)
    return np.array(
        [
            [ca * cb, ca * sb * sg - sa * cg, ca * sb * cg + sa * sg],
            [sa * cb, sa * sb * sg + ca * cg, sa * sb * cg - ca * sg],
            [-sb, cb * sg, cb * cg],
        ],
        np.float32,
    )


def build_symmetry_stack(info: dict, n_discretize: int = N_DISCRETIZE) -> np.ndarray:
    """Build the [S, 4, 4] discrete symmetry stack for one object.

    `info` is one entry of BOP models_info.json. Identity is always first
    (BOP omits it from the file).
    """
    syms = [np.eye(4)]
    for sym in info.get("symmetries_discrete", []):
        syms.append(np.asarray(sym, dtype=np.float64).reshape(4, 4))
    for sym in info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64).reshape(3)
        offset = np.asarray(sym["offset"], dtype=np.float64).reshape(3)
        assert np.allclose(offset, 0), "Only zero-offset continuous symmetries supported"
        assert axis.sum() == 1, "Only axis-aligned continuous symmetries supported"
        for n in range(n_discretize):
            euler = axis * 360.0 * n / n_discretize
            T = np.eye(4)
            T[:3, :3] = _euler2R_f32(euler)
            syms.append(T)
    return np.stack(syms).astype(np.float64)


def pad_symmetry_stack(syms: np.ndarray, s_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad [S, 4, 4] -> ([s_max, 4, 4], [s_max] bool valid). Pads with I."""
    s = syms.shape[0]
    assert s <= s_max, f"Need s_max >= {s}"
    out = np.tile(np.eye(4), (s_max, 1, 1))
    out[:s] = syms
    valid = np.zeros((s_max,), dtype=bool)
    valid[:s] = True
    return out, valid


def pick_symmetry_transform(
    T_OtoC: torch.Tensor,
    syms: torch.Tensor,
    sym_valid: torch.Tensor,
    kp_avg: torch.Tensor,
    T_VtoC: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick the symmetry closest to the labeled view pose.

    T_OtoC [4, 4] or [3, 4] GT object->camera pose; syms [S, 4, 4] padded
    stack; sym_valid [S] bool; kp_avg [N, 3] labeled object-frame keypoints;
    T_VtoC [4, 4] labeled view pose. Returns (T_OtoC @ T_best [4, 4], best
    index).
    """
    import torch

    if T_OtoC.shape[-2] == 3:
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=T_OtoC.dtype, device=T_OtoC.device)
        T_OtoC = torch.cat([T_OtoC, bottom], dim=-2)

    def mean_sub(p):
        return p - torch.mean(p, dim=-2, keepdim=True)

    ref = mean_sub(kp_avg @ T_VtoC[:3, :3].T + T_VtoC[:3, 3])
    T = T_OtoC[None] @ syms                                   # [S, 4, 4]
    p = mean_sub(kp_avg[None] @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3])
    dists = torch.mean(torch.linalg.norm(p - ref[None], dim=-1), dim=-1)
    dists = torch.where(sym_valid, dists, torch.inf)
    i_best = torch.argmin(dists)
    return T_OtoC @ syms[i_best], i_best
