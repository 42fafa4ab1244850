"""Stacked-hourglass backbone in PyTorch (inference).

Port of `suo_slam_tpu/models/hourglass.py`: a stride-2 7x7 stem + maxpool
(256x256 in -> 64x64 heatmaps), pre-activation bottleneck residual blocks, a
depth-4 recursive hourglass repeated `n_stack` times with intermediate
heatmap re-injection. Tensors are NCHW with `channels_last` memory; the
convolutions are `F.conv2d` (cuDNN on the card), as the JAX package left them
to XLA. `MaskedBatchNorm` is the inference form only: a per-channel affine
from the running statistics (its masked training statistics are not ported).

`models/convert.py` maps the flax auto-names (`Conv_k`, `Norm_k`,
`Residual_k`, `Hourglass_k`), which follow the flax module's call order, onto
these submodules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsampling, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)


class MaskedBatchNorm(nn.Module):
    """BatchNorm at inference: y = x * inv + (bias - mean * inv) with
    inv = rsqrt(var + eps) * scale, per channel (the flax module's
    inference branch)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        shift = self.bias - self.mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class Residual(nn.Module):
    """Pre-activation bottleneck: norm-relu -> 1x1 (c/2) -> norm-relu ->
    3x3 (c/2) -> norm-relu -> 1x1 (c), with a 1x1 projection skip when the
    channel counts differ."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        mid = features // 2
        self.norm0 = MaskedBatchNorm(in_features)
        self.conv0 = nn.Conv2d(in_features, mid, 1)
        self.norm1 = MaskedBatchNorm(mid)
        self.conv1 = nn.Conv2d(mid, mid, 3, padding=1)
        self.norm2 = MaskedBatchNorm(mid)
        self.conv2 = nn.Conv2d(mid, features, 1)
        self.skip = (nn.Conv2d(in_features, features, 1)
                     if in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv0(F.relu(self.norm0(x)))
        y = self.conv1(F.relu(self.norm1(y)))
        y = self.conv2(F.relu(self.norm2(y)))
        if self.skip is not None:
            x = self.skip(x)
        return x + y


class Hourglass(nn.Module):
    """Recursive hourglass of depth `n`."""

    def __init__(self, n: int, n_modules: int, features: int):
        super().__init__()
        res = lambda: nn.ModuleList(
            Residual(features, features) for _ in range(n_modules)
        )
        self.up1 = res()
        self.low1 = res()
        self.low2 = Hourglass(n - 1, n_modules, features) if n > 1 else res()
        self.low3 = res()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = x
        for m in self.up1:
            up1 = m(up1)
        low = _max_pool2(x)
        for m in self.low1:
            low = m(low)
        if isinstance(self.low2, Hourglass):
            low = self.low2(low)
        else:
            for m in self.low2:
                low = m(low)
        for m in self.low3:
            low = m(low)
        return up1 + upsample2x(low)


class HourglassNet(nn.Module):
    """Stacked hourglass with intermediate re-injection.

    `with_extra`: the post-stem 1x1 projection of an [N, C_e, H/4, W/4]
    conditioning input (the prior keypoint heatmaps). `forward(x, extra=None)`
    with the projection present adds only its bias — exactly the JAX
    package's output on an all-zero prior, with the matmul skipped."""

    def __init__(self, in_features: int = 3 + 41, num_output: int = 41,
                 n_stack: int = 2, n_modules: int = 2, features: int = 256,
                 depth: int = 4, with_extra: bool = False, extra_features: int = 41):
        super().__init__()
        self.n_stack = n_stack
        self.stem = nn.Conv2d(in_features, 64, 7, stride=2, padding=3)
        self.stem_norm = MaskedBatchNorm(64)
        self.pre = nn.ModuleList([
            Residual(64, 128), Residual(128, 128), Residual(128, features)
        ])
        self.extra_proj = (nn.Conv2d(extra_features, features, 1)
                           if with_extra else None)
        self.hgs = nn.ModuleList(
            Hourglass(depth, n_modules, features) for _ in range(n_stack)
        )
        self.lls = nn.ModuleList(
            nn.ModuleList(Residual(features, features) for _ in range(n_modules))
            for _ in range(n_stack)
        )
        self.ll_convs = nn.ModuleList(
            nn.Conv2d(features, features, 1) for _ in range(n_stack)
        )
        self.ll_norms = nn.ModuleList(
            MaskedBatchNorm(features) for _ in range(n_stack)
        )
        self.heads = nn.ModuleList(
            nn.Conv2d(features, num_output, 1) for _ in range(n_stack)
        )
        self.ll_merges = nn.ModuleList(
            nn.Conv2d(features, features, 1) for _ in range(n_stack - 1)
        )
        self.out_merges = nn.ModuleList(
            nn.Conv2d(num_output, features, 1) for _ in range(n_stack - 1)
        )

    def forward(self, x: torch.Tensor, extra: torch.Tensor | None = None):
        """x [N, C, H, W] -> list of n_stack [N, num_output, H/4, W/4] logits."""
        x = F.relu(self.stem_norm(self.stem(x)))
        x = self.pre[0](x)
        x = _max_pool2(x)
        x = self.pre[1](x)
        x = self.pre[2](x)
        if self.extra_proj is not None:
            if extra is None:
                x = x + self.extra_proj.bias[None, :, None, None]
            else:
                x = x + self.extra_proj(extra)
        elif extra is not None:
            raise ValueError("this backbone has no post-stem projection")
        outs = []
        for i in range(self.n_stack):
            ll = self.hgs[i](x)
            for m in self.lls[i]:
                ll = m(ll)
            ll = F.relu(self.ll_norms[i](self.ll_convs[i](ll)))
            tmp_out = self.heads[i](ll)
            outs.append(tmp_out)
            if i < self.n_stack - 1:
                x = x + self.ll_merges[i](ll) + self.out_merges[i](tmp_out)
        return outs
