"""suo-slam-tpu on PyTorch + CUDA: the single-view object-SLAM frame on an
NVIDIA Hopper card (ROI crop -> PkpNet -> heatmap readout -> PnP RANSAC ->
bundle adjustment).

A port of the JAX package `suo_slam_tpu` that keeps its subpaths and names,
so each function has an obvious counterpart there. This package imports
torch and numpy only — never `jax`, never `suo_slam_tpu` — so it runs on a
GPU host with no JAX installed. Kernels written by hand for `sm_90a` live in
`csrc/` and are built on first use by `kernels/_build.py`.

Entry points take `device=`, which defaults to "cuda" and raises when no card
is present; pass `device="cpu"` for the plain-PyTorch versions (the tests).
"""

__version__ = "0.1.0"

__all__ = ["core", "kernels", "kp", "models", "ops", "slam", "solvers"]
