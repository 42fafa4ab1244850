"""Launch counters and build entry for the port's hand-written kernels.

Each kernel wrapper lives beside its plain PyTorch version (K1 `ops/roi.py`,
K2 and K5 `ops/heatmap.py`, K3 `solvers/pnp.py`, K4 and K7 `solvers/ba.py`,
K6 `slam/kernels.py`, K8 and K9 `models/hourglass.py`, K10 `eval/meter.py`,
K11-K13 `models/int8_kernels.py`)
and adds one to its counter here where — and only
where — it launches its CUDA kernel.
"""

from __future__ import annotations

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
}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict[str, int]:
    return dict(LAUNCHES)
