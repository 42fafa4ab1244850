"""Launch counters and build entry for the port's hand-written kernels.

Each kernel wrapper lives beside its plain PyTorch version (K1 `ops/roi.py`,
K2 and K5 `ops/heatmap.py`, K3 and K15 `solvers/pnp.py`, K4 and K7
`solvers/ba.py`, K6 `slam/kernels.py`, K8 and K9 `models/hourglass.py`, K10
`eval/meter.py`, K11-K13 `models/int8_kernels.py`, K14 `solvers/ba.py`)
and adds one to its counter here where — and only
where — it launches its CUDA kernel.

No kernel has a backward yet (ROADMAP B13): the wrappers of the kernels that
a training step would reach (K2, K8, K9) call `refuse_autograd`, which
raises where autograd would record the call instead of returning an output
cut from the graph.
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
}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict[str, int]:
    return dict(LAUNCHES)


def autograd_records(*tensors) -> bool:
    """True where autograd would record a call on these inputs: grad mode
    on and an input that requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_autograd(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel call: the kernel writes a
    fresh tensor with no `grad_fn`, which would cut the graph silently."""
    if autograd_records(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward yet (ROADMAP B13); call it under "
            "torch.inference_mode() or torch.no_grad(), or on CPU tensors")
