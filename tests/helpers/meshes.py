"""Closed triangle meshes made from a seed, for the renderer and the
labeling tools' tests."""

import numpy as np


def torus_mesh(n_u=48, n_v=32, R=40.0, r=15.0, noise=0.1, seed=0):
    """A closed torus of 2 n_u n_v triangles about the z axis (mm), each
    vertex moved radially by up to `noise` of its distance from the tube's
    centre line. Returns (verts [V, 3] f64, faces [F, 3] int32)."""
    rng = np.random.default_rng(seed)
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")
    rr = r * (1.0 + noise * rng.uniform(-1, 1, uu.shape))
    verts = np.stack([(R + rr * np.cos(vv)) * np.cos(uu), (R + rr * np.cos(vv)) * np.sin(uu),
                      rr * np.sin(vv)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
    c, d = ((i + 1) % n_u) * n_v + (j + 1) % n_v, i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts, faces.astype(np.int32)
