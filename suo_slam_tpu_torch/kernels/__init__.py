"""Launch counters and build entry for the port's hand-written kernels.

Each kernel wrapper lives beside its plain PyTorch version (K1 `ops/roi.py`,
K2, K5 and K19 `ops/heatmap.py`, K3 and K15 `solvers/pnp.py`, K4 and K7
`solvers/ba.py`, K6 `slam/kernels.py`, K8, K9 and K16-K18
`models/hourglass.py`, K10 `eval/meter.py`, K11-K13
`models/int8_kernels.py`, K14 `solvers/ba.py`) and adds one to its counter
here where — and only where — it launches its CUDA kernel.

The kernels a training step reaches have their backward as kernels too:
K2's is K19, K8's K17 (with K16's batch statistics in train mode), K9's
K18, each pair one `torch.autograd.Function` that the wrapper takes where
`autograd_records` says autograd records the call.
"""

from __future__ import annotations

import torch

from ._build import build_all  # noqa: F401

# kernel name -> launches since the last `reset_counts()`
LAUNCHES: dict[str, int] = {
    "roi_crop": 0,      # K1
    "heatmap_readout": 0,  # K2
    "pnp_hypotheses": 0,   # K3
    "ba_edges": 0,      # K4
    "prior_render": 0,  # K5
    "chi2_counts": 0,   # K6
    "ba_schur": 0,      # K7
    "norm_relu": 0,     # K8
    "upsample_add": 0,  # K9
    "add_dists": 0,     # K10
    "int8_conv": 0,     # K11
    "int8_quant": 0,    # K12
    "int8_pool_junction": 0,  # K13 (max-pool and junction)
    "ba_lm": 0,         # K14
    "pnp_ransac": 0,    # K15
    "bn_stats": 0,      # K16
    "norm_relu_bwd": 0,  # K17
    "upsample_add_bwd": 0,  # K18
    "heatmap_readout_bwd": 0,  # K19
}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict[str, int]:
    return dict(LAUNCHES)


def plain_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a plain version computes in where the JAX package computes
    in f32: f32 for f32 and bf16 input, f64 for f64 input. The kernels take
    f32 and bf16; f64 runs only through the plain versions, on the CPU, for
    comparisons where f32 rounding would hide the result."""
    return torch.promote_types(dtype, torch.float32)


def autograd_records(*tensors) -> bool:
    """True where autograd would record a call on these inputs: grad mode
    on and an input that requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)

