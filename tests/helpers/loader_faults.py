"""Datasets that fail inside a loader's worker process, and a probe of what
a worker imported: picklable by import path and free of torch, for
`tests/test_torch_loader_modes.py`."""

import os
import sys


class FailingDataset:
    """`how="raise"`: every sample raises; `how="die"`: the worker process
    exits at once, as a crash would end it."""

    def __init__(self, n: int, how: str):
        self.n, self.how = n, how

    def __len__(self):
        return self.n

    def sample_seeded(self, i, seed):
        if self.how == "die":
            os._exit(3)
        raise RuntimeError(f"sample {i} failed in the worker")


def imported(_=None) -> list:
    """Which of torch and the JAX package this process has imported."""
    return sorted(m for m in ("torch", "jax", "suo_slam_tpu") if m in sys.modules)
