"""Drop-in for the reference's `lambdatwist` pybind module.

Port of `suo_slam_tpu/compat/lambdatwist.py`: ``pnp(xs_in, ys_in,
threshold=0.001)`` takes [N, 3] model points and [N, 2] pinhole-normalized
image points and returns the 4x4 ``T`` mapping model points into the
camera frame; the 4x4 identity signals failure (fewer than 4 points, or no
pose), as the reference caller tests it.

Backed by `solvers/pnp.pnp_ransac` (LambdaTwist P4P RANSAC and its
Gauss-Newton refinement): on the card one launch of kernel K15 in its draws
mode, on the CPU its plain version. Point counts are padded to power-of-two
buckets as in the JAX shim. The hypotheses' draws come from a
`torch.Generator` seeded from 7 and a per-process call counter: fresh
hypotheses a call, deterministic per process (the reference binding reseeds
its RNG per call); torch cannot replay `jax.random`'s stream, so a pose
agrees with the JAX shim's where the RANSAC's outcome does not depend on
the draws (clean points).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import _device
from ..solvers import pnp as pnp_mod

_call_counter = itertools.count()


def pnp(xs_in, ys_in, threshold: float = 0.001, device="cuda") -> np.ndarray:
    """RANSAC PnP; returns the 4x4 T_model_to_cam, the identity on failure."""
    x = np.asarray(xs_in, np.float32)
    y = np.asarray(ys_in, np.float32)
    if x.ndim != 2 or x.shape[1] != 3 or y.shape != (x.shape[0], 2):
        raise ValueError(f"pnp: bad shapes {x.shape} / {y.shape}")
    n = x.shape[0]
    if n < 4:
        return np.eye(4)
    dev = _device.resolve_device(device)
    nb = max(8, 1 << (n - 1).bit_length())
    xp = np.zeros((nb, 3), np.float32)
    yp = np.zeros((nb, 2), np.float32)
    m = np.zeros((nb,), bool)
    xp[:n], yp[:n], m[:n] = x, y, True
    mask = torch.from_numpy(m).to(dev)
    gen = torch.Generator(device=dev).manual_seed((7 << 32) | next(_call_counter))
    draws = pnp_mod.sample_draws(mask[None], pnp_mod.DEFAULT_HYPOTHESES, gen)
    res = pnp_mod.pnp_ransac(torch.from_numpy(xp).to(dev), torch.from_numpy(yp).to(dev), mask,
                             pnp_mod.Draws(draws.u[0]), threshold=float(threshold))
    if not bool(res.success):
        return np.eye(4)
    return res.T.cpu().numpy().astype(np.float64)
