"""Stacked-hourglass backbone in PyTorch (inference), f32 or bf16.

Port of `suo_slam_tpu/models/hourglass.py`: a stride-2 7x7 stem + maxpool
(256x256 in -> 64x64 heatmaps), pre-activation bottleneck residual blocks, a
depth-4 recursive hourglass repeated `n_stack` times with intermediate
heatmap re-injection. Tensors are NCHW with `channels_last` memory; the
convolutions are `F.conv2d` (cuDNN on the card), as the JAX package left them
to XLA. `MaskedBatchNorm` is the inference form only: a per-channel affine
from the running statistics (its masked training statistics are not ported).

Working dtype (`HourglassNet(dtype=...)`, f32 or bf16), with the JAX
package's casts: parameters stay f32; the input is cast to the working dtype
(`hourglass.py:199`); convolutions run in it on a cached cast of their
weights; each norm computes in f32 and casts back (`:88-90`); the heatmap
heads are f32 convolutions of an f32 cast (`:225-227`), and the re-injection
of their logits casts back (`:231-233`).

Two kernels replace the elementwise epilogues on CUDA tensors (B4):
- K8 `norm_relu` (`csrc/norm_relu.cu`): every norm of the net is followed by
  a ReLU, so the pair is one pass, relu(cast(x * inv[c] + shift[c])) with
  inv = rsqrt(var + eps) * scale and shift = bias - mean * inv computed once
  per module in f32 and cached until the weights change;
- K9 `upsample_add` (`csrc/upsample_add.cu`): the hourglass junction
  up1 + nearest2x(low), without materialising the upsampled tensor.
Both take NHWC memory (NCHW `channels_last`) and raise on another layout.
On CPU tensors they run their plain versions, which the kernels match
exactly.

`models/convert.py` maps the flax auto-names (`Conv_k`, `Norm_k`,
`Residual_k`, `Hourglass_k`), which follow the flax module's call order, onto
these submodules.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels as kcount
from ..kernels import _build

_CL = torch.channels_last
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_nhwc(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dim() != 4 or not x.is_contiguous(memory_format=_CL):
            raise ValueError(f"{name}: expected a channels_last-contiguous NCHW tensor, "
                             f"got shape {tuple(x.shape)} strides {x.stride()}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{name}: f32 or bf16 only, got {x.dtype}")


# K8 ----------------------------------------------------------------------------
def norm_relu_plain(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """relu(cast(x * inv[c] + shift[c])), the affine in f32 whatever x's
    dtype, the result in x's dtype (JAX casts back, then applies relu)."""
    y = x.float() * inv[None, :, None, None] + shift[None, :, None, None]
    return torch.relu(y.to(x.dtype))


_NORM_RELU_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]


def _norm_relu_cuda(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    _check_nhwc("K8 norm_relu", x)
    C = x.shape[1]
    if inv.shape != (C,) or shift.shape != (C,) or inv.dtype != torch.float32 \
            or shift.dtype != torch.float32:
        raise ValueError("K8 norm_relu: inv and shift must be f32 [C]")
    if inv.device != x.device or shift.device != x.device:
        raise ValueError("K8 norm_relu: inputs must lie on one CUDA device")
    inv, shift = inv.contiguous(), shift.contiguous()
    out = torch.empty_like(x, memory_format=_CL)
    fn = _build.entry("norm_relu", _NORM_RELU_ARGTYPES)
    err = fn(_build.ptr(x), _build.ptr(inv), _build.ptr(shift), _build.ptr(out), x.numel(), C,
             _DTYPES[x.dtype], _build.stream())
    _build.check(err, "K8 norm_relu")
    kcount.count("norm_relu")
    return out


def norm_relu(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Fused BatchNorm affine + ReLU (see `norm_relu_plain`): K8 on CUDA
    tensors, the plain version on CPU tensors. x must be channels_last."""
    if x.device.type == "cpu":
        _check_nhwc("norm_relu", x)
        return norm_relu_plain(x, inv, shift)
    if x.device.type != "cuda":
        raise ValueError(f"norm_relu: unsupported device {x.device}")
    return _norm_relu_cuda(x, inv, shift)


# K9 ----------------------------------------------------------------------------
def upsample_add_plain(up1: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """up1 + nearest-neighbour 2x upsampling of low (NCHW), in their dtype."""
    return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


_UPSAMPLE_ADD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _upsample_add_cuda(up1: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    _check_nhwc("K9 upsample_add", up1, low)
    N, C, H, W = up1.shape
    if tuple(low.shape) != (N, C, H // 2, W // 2) or H % 2 or W % 2:
        raise ValueError(f"K9 upsample_add: low {tuple(low.shape)} is not half of "
                         f"up1 {tuple(up1.shape)}")
    if low.dtype != up1.dtype or low.device != up1.device:
        raise ValueError("K9 upsample_add: up1 and low must share dtype and device")
    out = torch.empty_like(up1, memory_format=_CL)
    fn = _build.entry("upsample_add", _UPSAMPLE_ADD_ARGTYPES)
    err = fn(_build.ptr(up1), _build.ptr(low), _build.ptr(out), N, H, W, C,
             _DTYPES[up1.dtype], _build.stream())
    _build.check(err, "K9 upsample_add")
    kcount.count("upsample_add")
    return out


def upsample_add(up1: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The hourglass junction up1 + nearest2x(low): K9 on CUDA tensors, the
    plain version on CPU tensors. Both must be channels_last."""
    if up1.device.type == "cpu":
        _check_nhwc("upsample_add", up1, low)
        return upsample_add_plain(up1, low)
    if up1.device.type != "cuda":
        raise ValueError(f"upsample_add: unsupported device {up1.device}")
    return _upsample_add_cuda(up1, low)


# modules -----------------------------------------------------------------------
def _weights_key(*ts: torch.Tensor) -> tuple:
    """Identifies the current values of some parameters: their storage and
    in-place version counters (a `load_state_dict` or `.to()` changes one).
    Tensors made under `torch.inference_mode` keep no version counter: for
    them only the storage counts."""
    return tuple((t.data_ptr(), -1 if t.is_inference() else t._version, t.device, t.dtype)
                 for t in ts)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    # channels_last in, channels_last out on both devices; `.contiguous` is
    # then a no-op that only guards K8's layout contract
    return F.max_pool2d(x, kernel_size=2, stride=2).contiguous(memory_format=_CL)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied in x's dtype: parameters stay f32 and are cast (once per
    weight update, cached on the module) when x is bf16."""
    if x.dtype == m.weight.dtype:
        return m(x)
    key = _weights_key(m.weight, m.bias) + (x.dtype,)
    cache = getattr(m, "_cast_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            cache = (key, m.weight.to(x.dtype, memory_format=_CL), m.bias.to(x.dtype))
        m._cast_cache = cache
    return F.conv2d(x, cache[1], cache[2], m.stride, m.padding)


class MaskedBatchNorm(nn.Module):
    """BatchNorm at inference with the ReLU that follows every norm of this
    net: relu(x * inv + (bias - mean * inv)) with inv = rsqrt(var + eps) *
    scale, per channel in f32 (the flax module's inference branch, then
    `nn.relu`), through K8 on the card."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self._affine = None

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift), f32 [C], computed once per weight update."""
        key = _weights_key(self.scale, self.bias, self.mean, self.var)
        if self._affine is None or self._affine[0] != key:
            with torch.no_grad():
                inv = torch.rsqrt(self.var + self.eps) * self.scale
                shift = self.bias - self.mean * inv
            self._affine = (key, inv, shift)
        return self._affine[1], self._affine[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_relu(x, *self.affine())


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
        y = conv(self.conv0, self.norm0(x))
        y = conv(self.conv1, self.norm1(y))
        y = conv(self.conv2, self.norm2(y))
        if self.skip is not None:
            x = conv(self.skip, x)
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
        return upsample_add(up1, low)


class HourglassNet(nn.Module):
    """Stacked hourglass with intermediate re-injection.

    `with_extra`: the post-stem 1x1 projection of an [N, C_e, H/4, W/4]
    conditioning input (the prior keypoint heatmaps). `forward(x, extra=None)`
    with the projection present adds only its bias — exactly the JAX
    package's output on an all-zero prior, with the matmul skipped."""

    def __init__(self, in_features: int = 3 + 41, num_output: int = 41,
                 n_stack: int = 2, n_modules: int = 2, features: int = 256,
                 depth: int = 4, with_extra: bool = False, extra_features: int = 41,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"working dtype must be f32 or bf16, got {dtype}")
        self.dtype = dtype
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
        """x [N, C, H, W] channels_last -> list of n_stack f32
        [N, num_output, H/4, W/4] logits."""
        dt = self.dtype
        x = self.stem_norm(conv(self.stem, x.to(dt)))
        x = self.pre[0](x)
        x = _max_pool2(x)
        x = self.pre[1](x)
        x = self.pre[2](x)
        if self.extra_proj is not None:
            if extra is None:
                x = x + self.extra_proj.bias.to(dt)[None, :, None, None]
            else:
                x = x + conv(self.extra_proj, extra.to(dt))
        elif extra is not None:
            raise ValueError("this backbone has no post-stem projection")
        outs = []
        for i in range(self.n_stack):
            ll = self.hgs[i](x)
            for m in self.lls[i]:
                ll = m(ll)
            ll = self.ll_norms[i](conv(self.ll_convs[i], ll))
            tmp_out = self.heads[i](ll.float())
            outs.append(tmp_out)
            if i < self.n_stack - 1:
                x = x + conv(self.ll_merges[i], ll) + conv(self.out_merges[i], tmp_out.to(dt))
        return outs
