"""Device resolution for the port's entry points.

There is no fallback: asking for CUDA on a host without a card raises, and a
CUDA tensor handed to a kernel wrapper launches the kernel or raises. Only a
tensor that lies on the CPU takes the plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a `torch.device`, raising if it is CUDA and no card
    is available. On CUDA this also pins the slice to true f32 (see
    `set_f32_precision`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "suo_slam_tpu_torch: device='cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch versions"
            )
        set_f32_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_f32_precision() -> None:
    """Run this slice's convolutions and matmuls in true f32.

    cuDNN convolutions default to TF32 on Hopper (`cudnn.allow_tf32` is
    True), which keeps ~3 decimal digits and moves heatmap peaks by more
    than the port's parity tolerances. This is the one place the port sets
    the flags; a bf16/TF32 path is a later change.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def precision_flags() -> dict:
    """The precision flags as they stand (printed by chip_smoke.py)."""
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
