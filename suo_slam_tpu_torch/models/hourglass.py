"""Stacked-hourglass backbone in PyTorch, f32 or bf16, for inference and
training.

Port of `suo_slam_tpu/models/hourglass.py`: a stride-2 7x7 stem + maxpool
(256x256 in -> 64x64 heatmaps), pre-activation bottleneck residual blocks, a
depth-4 recursive hourglass repeated `n_stack` times with intermediate
heatmap re-injection. Tensors are NCHW with `channels_last` memory; the
convolutions are `F.conv2d` (cuDNN on the card), as the JAX package left them
to XLA. `forward(x, train=False, row_mask=None)` threads the flax modules'
`train` and `row_mask` through every norm: `MaskedBatchNorm` normalizes with
its running statistics, or in train mode with the batch statistics of the
rows `row_mask` marks real (all rows without a mask) and updates the running
averages (momentum 0.9, biased variance, f32).

Working dtype (`HourglassNet(dtype=...)`, f32 or bf16; f64, with f64
parameters, runs the plain versions on the CPU), with the JAX package's
casts: parameters stay f32; the input is cast to the working dtype
(`hourglass.py:199`); convolutions run in it on a cast of their weights
(made in the autograd graph while autograd records the parameters, else
cached once per weight update); each norm computes in f32 and casts back
(`:88-90`); the heatmap
heads are f32 convolutions of an f32 cast (`:225-227`), and the re-injection
of their logits casts back (`:231-233`).

Kernels replace the norms' and the junction's elementwise work on CUDA
tensors (B4, B13):
- K8 `norm_relu` (`csrc/norm_relu.cu`): every norm of the net is followed by
  a ReLU, so the pair is one pass, relu(cast(x * inv[c] + shift[c])) with
  inv = rsqrt(var + eps) * scale and shift = bias - mean * inv (running
  statistics: computed once per module in f32 and cached until the weights
  change; train mode: from K16's batch statistics);
- K16 `bn_stats` (`csrc/bn_train.cu`): the masked batch mean and biased
  variance of train mode;
- K17 `norm_relu_bwd` (`csrc/bn_train.cu`): the backward of the norm + ReLU,
  through the batch statistics in train mode, with fixed ones otherwise;
- K9 `upsample_add` (`csrc/upsample_add.cu`): the hourglass junction
  up1 + nearest2x(low), without materialising the upsampled tensor;
- K18 `upsample_add_bwd` (`csrc/upsample_add.cu`): low's gradient, the 2x2
  sums of the output's (up1's is the output's itself).
Each forward with its backward is one `torch.autograd.Function`, taken where
autograd records the call. All take NHWC memory (NCHW `channels_last`) and
raise on another layout. On CPU tensors they run their plain versions,
which the kernels match exactly (K16 and K17 up to the order of f64 sums).
The max-pools and the convolutions keep torch's autograd, as the JAX
package left them to XLA.

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


def _check_nhwc(name: str, *xs: torch.Tensor, plain: bool = False) -> None:
    """Layout and dtype contract: f32 or bf16, and f64 for a plain version
    (`plain`)."""
    for x in xs:
        if x.dim() != 4 or not x.is_contiguous(memory_format=_CL):
            raise ValueError(f"{name}: expected a channels_last-contiguous NCHW tensor, "
                             f"got shape {tuple(x.shape)} strides {x.stride()}")
        if x.dtype not in _DTYPES and not (plain and x.dtype == torch.float64):
            raise ValueError(f"{name}: f32 or bf16 only, got {x.dtype}")


# K8 ----------------------------------------------------------------------------
def norm_relu_plain(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """relu(cast(x * inv[c] + shift[c])), the affine in f32 (f64 for f64 x),
    the result in x's dtype (JAX casts back, then applies relu)."""
    y = x.to(kcount.plain_dtype(x.dtype)) * inv[None, :, None, None] + shift[None, :, None, None]
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


def _norm_relu_fwd(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K8 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        _check_nhwc("norm_relu", x, plain=True)
        return norm_relu_plain(x, inv, shift)
    if x.device.type != "cuda":
        raise ValueError(f"norm_relu: unsupported device {x.device}")
    return _norm_relu_cuda(x, inv, shift)


def norm_relu(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Fused BatchNorm affine + ReLU (see `norm_relu_plain`): K8 on CUDA
    tensors, the plain version on CPU tensors; where autograd records the
    call, its backward is K17 with fixed statistics. x must be
    channels_last."""
    if kcount.autograd_records(x, inv, shift):
        return _NormRelu.apply(x, inv, shift)
    return _norm_relu_fwd(x, inv, shift)


# K16 ---------------------------------------------------------------------------
def _row_mask_u8(row_mask: torch.Tensor | None, N: int, dev) -> torch.Tensor | None:
    if row_mask is None:
        return None
    if row_mask.shape != (N,):
        raise ValueError(f"row_mask must be [{N}], got {tuple(row_mask.shape)}")
    return row_mask.to(device=dev, dtype=torch.uint8).contiguous()


def _masked_count(row_mask: torch.Tensor | None, N: int, hw: int, dev) -> torch.Tensor:
    """M = max(sum(mask) * H * W, 1) in f64 (all rows without a mask)."""
    if row_mask is None:
        return torch.tensor(float(N * hw), dtype=torch.float64, device=dev)
    return torch.clamp(row_mask.to(torch.float64).sum() * hw, min=1.0)


def bn_stats_plain(x: torch.Tensor, row_mask: torch.Tensor | None = None):
    """Plain K16: per-channel mean and biased variance, f32 [C] (f64 for f64
    x), over the rows `row_mask` marks (all rows without one): f64 sums of x
    and x^2, mean = sum / M, var = sum2 / M - mean^2 with
    M = max(rows * H * W, 1)."""
    N, C, H, W = x.shape
    xd = x.to(torch.float64)
    if row_mask is not None:
        xd = xd * row_mask.to(torch.float64)[:, None, None, None]
    M = _masked_count(row_mask, N, H * W, x.device)
    mean = xd.sum((0, 2, 3)) / M
    var = torch.clamp((xd * xd).sum((0, 2, 3)) / M - mean * mean, min=0.0)
    out = kcount.plain_dtype(x.dtype)
    return mean.to(out), var.to(out)


_BN_STATS_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])


def _bn_partials(x: torch.Tensor, dy=None, dx=None) -> torch.Tensor:
    """K16 / K17's f64 scratch: one [C, 2] partial per block of the partial
    pass (the blocks depend on the vector width the pointers allow)."""
    N, C, H, W = x.shape
    fn = _build.entry("bn_train", [ctypes.c_longlong] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p] * 3, "suo_bn_chunks")
    chunks = fn(N * H * W, C, _DTYPES[x.dtype], _build.ptr(x),
                *(None if t is None else _build.ptr(t) for t in (dy, dx)))
    return torch.empty((chunks, C, 2), dtype=torch.float64, device=x.device)


def _bn_stats_cuda(x: torch.Tensor, row_mask: torch.Tensor | None = None):
    _check_nhwc("K16 bn_stats", x)
    N, C, H, W = x.shape
    dev = x.device
    mask = _row_mask_u8(row_mask, N, dev)
    part = _bn_partials(x)
    mean = torch.empty(C, dtype=torch.float32, device=dev)
    var = torch.empty(C, dtype=torch.float32, device=dev)
    fn = _build.entry("bn_train", _BN_STATS_ARGTYPES, "suo_bn_stats")
    err = fn(_build.ptr(x), None if mask is None else _build.ptr(mask), N, H * W, C,
             _build.ptr(part), _build.ptr(mean), _build.ptr(var), _DTYPES[x.dtype],
             _build.stream())
    _build.check(err, "K16 bn_stats")
    kcount.count("bn_stats")
    return mean, var


def bn_stats(x: torch.Tensor, row_mask: torch.Tensor | None = None):
    """Masked batch statistics of train mode (see `bn_stats_plain`): K16 on
    CUDA tensors, the plain version on CPU tensors. x must be channels_last."""
    if x.device.type == "cpu":
        _check_nhwc("bn_stats", x, plain=True)
        return bn_stats_plain(x, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: unsupported device {x.device}")
    return _bn_stats_cuda(x, row_mask)


# K17 ---------------------------------------------------------------------------
def norm_relu_bwd_plain(x, dy, inv, shift, mean=None, rstd=None, row_mask=None):
    """Plain K17: the backward of y = relu(cast(x * inv + shift)).

    g = dy * [y > 0] in f32; sum_g = sum over all rows of g; sum_gc = sum of
    g * (x - mean) (mean = 0 when None). With `mean` and `rstd` (train mode,
    inv = rstd * scale) dx runs through the statistics of the rows
    `row_mask` marks: dx = inv g - m_n (inv sum_g / M + (x - mean) inv rstd^2
    sum_gc / M); without them (fixed statistics) dx = inv g. dx in x's dtype,
    channels_last; sum_g and sum_gc f32 [C] (f64 sums; all f64 for f64 x)."""
    train = mean is not None
    N, C, H, W = x.shape
    c4 = lambda t: t[None, :, None, None]
    f = kcount.plain_dtype(x.dtype)
    xf = x.to(f)
    on = (xf * c4(inv) + c4(shift)).to(x.dtype) > 0
    g = torch.where(on, dy.to(f), torch.zeros((), device=x.device))
    xc = xf - c4(mean) if train else xf
    sum_g = g.to(torch.float64).sum((0, 2, 3))
    sum_gc = (g.to(torch.float64) * xc.to(torch.float64)).sum((0, 2, 3))
    d = c4(inv) * g
    if train:
        M = _masked_count(row_mask, N, H * W, x.device)
        ivd = inv.to(torch.float64)
        b = (ivd * sum_g / M).to(f)
        rd = rstd.to(torch.float64)
        c = (ivd * rd * rd * sum_gc / M).to(f)
        corr = c4(b) + xc * c4(c)
        if row_mask is not None:
            corr = torch.where(row_mask[:, None, None, None], corr,
                               torch.zeros((), device=x.device))
        d = d - corr
    dx = d.to(x.dtype).contiguous(memory_format=_CL)
    return dx, sum_g.to(f), sum_gc.to(f)


_NORM_RELU_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.c_void_p])


def _norm_relu_bwd_cuda(x, dy, inv, shift, mean=None, rstd=None, row_mask=None):
    _check_nhwc("K17 norm_relu_bwd", x, dy)
    N, C, H, W = x.shape
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("K17 norm_relu_bwd: dy must match x's shape and dtype")
    train = mean is not None
    if not train:
        mean = torch.zeros(C, dtype=torch.float32, device=dev)
    mask = _row_mask_u8(row_mask, N, dev) if train else None
    vecs = [t.contiguous() for t in (inv, shift, mean, rstd if train else inv)]
    if any(v.shape != (C,) or v.dtype != torch.float32 or v.device != dev for v in vecs):
        raise ValueError("K17 norm_relu_bwd: inv, shift, mean and rstd must be f32 [C] "
                         "on x's device")
    dx = torch.empty_like(x, memory_format=_CL)
    part = _bn_partials(x, dy, dx)
    sum_g = torch.empty(C, dtype=torch.float32, device=dev)
    sum_gc = torch.empty(C, dtype=torch.float32, device=dev)
    coef = torch.empty(C * 3, dtype=torch.float32, device=dev)
    fn = _build.entry("bn_train", _NORM_RELU_BWD_ARGTYPES, "suo_norm_relu_bwd")
    err = fn(_build.ptr(x), _build.ptr(dy), None if mask is None else _build.ptr(mask),
             *(_build.ptr(v) for v in vecs), N, H * W, C, int(train), _build.ptr(part),
             _build.ptr(sum_g), _build.ptr(sum_gc), _build.ptr(coef), _build.ptr(dx),
             _DTYPES[x.dtype], _build.stream())
    _build.check(err, "K17 norm_relu_bwd")
    kcount.count("norm_relu_bwd")
    return dx, sum_g, sum_gc


def norm_relu_bwd(x, dy, inv, shift, mean=None, rstd=None, row_mask=None):
    """The backward of the norm + ReLU (see `norm_relu_bwd_plain`): K17 on
    CUDA tensors, the plain version on CPU tensors. dy is made
    channels_last."""
    dy = dy.contiguous(memory_format=_CL)
    if x.device.type == "cpu":
        _check_nhwc("norm_relu_bwd", x, dy, plain=True)
        return norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"norm_relu_bwd: unsupported device {x.device}")
    return _norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, row_mask)


class _NormRelu(torch.autograd.Function):
    """K8 with fixed statistics, its backward K17 (stat terms off):
    d inv = sum g x, d shift = sum g."""

    @staticmethod
    def forward(ctx, x, inv, shift):
        ctx.save_for_backward(x, inv, shift)
        return _norm_relu_fwd(x, inv, shift)

    @staticmethod
    def backward(ctx, dy):
        x, inv, shift = ctx.saved_tensors
        dx, sum_g, sum_gx = norm_relu_bwd(x, dy, inv, shift)
        return dx, sum_gx, sum_g


class _NormReluTrain(torch.autograd.Function):
    """Train-mode norm + ReLU: K16's masked batch statistics, K8 applies
    them; backward K17 through the statistics. Returns (y, mean, var), the
    statistics for the running update (not differentiable)."""

    @staticmethod
    def forward(ctx, x, scale, bias, row_mask, eps):
        mean, var = bn_stats(x, row_mask)
        rstd = torch.rsqrt(var + eps)
        inv = rstd * scale
        shift = bias - mean * inv
        y = _norm_relu_fwd(x, inv, shift)
        ctx.save_for_backward(x, inv, shift, mean, rstd,
                              row_mask if row_mask is not None else torch.empty(0))
        ctx.has_mask = row_mask is not None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, inv, shift, mean, rstd, row_mask = ctx.saved_tensors
        dx, sum_g, sum_gc = norm_relu_bwd(x, dy, inv, shift, mean, rstd,
                                          row_mask if ctx.has_mask else None)
        return dx, sum_gc * rstd, sum_g, None, None



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


def _upsample_add_fwd(up1: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    if up1.device.type == "cpu":
        _check_nhwc("upsample_add", up1, low, plain=True)
        return upsample_add_plain(up1, low)
    if up1.device.type != "cuda":
        raise ValueError(f"upsample_add: unsupported device {up1.device}")
    return _upsample_add_cuda(up1, low)


def upsample_add(up1: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The hourglass junction up1 + nearest2x(low): K9 on CUDA tensors, the
    plain version on CPU tensors; where autograd records the call, low's
    gradient is K18. Both must be channels_last."""
    if kcount.autograd_records(up1, low):
        return _UpsampleAdd.apply(up1, low)
    return _upsample_add_fwd(up1, low)


# K18 ---------------------------------------------------------------------------
def upsample_add_bwd_plain(dy: torch.Tensor) -> torch.Tensor:
    """Plain K18: low's gradient, the 2x2 block sums of dy [N, C, H, W] in
    f32 (f64 for f64 dy), (top-left + top-right) + (bottom-left +
    bottom-right), rounded once to dy's dtype; channels_last."""
    N, C, H, W = dy.shape
    d = dy.to(kcount.plain_dtype(dy.dtype)).reshape(N, C, H // 2, 2, W // 2, 2)
    s = (d[:, :, :, 0, :, 0] + d[:, :, :, 0, :, 1]) + (d[:, :, :, 1, :, 0] + d[:, :, :, 1, :, 1])
    return s.to(dy.dtype).contiguous(memory_format=_CL)


_UPSAMPLE_ADD_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _upsample_add_bwd_cuda(dy: torch.Tensor) -> torch.Tensor:
    _check_nhwc("K18 upsample_add_bwd", dy)
    N, C, H, W = dy.shape
    if H % 2 or W % 2:
        raise ValueError(f"K18 upsample_add_bwd: odd size {tuple(dy.shape)}")
    dlow = torch.empty((N, C, H // 2, W // 2), dtype=dy.dtype, device=dy.device,
                       memory_format=_CL)
    fn = _build.entry("upsample_add", _UPSAMPLE_ADD_BWD_ARGTYPES, "suo_upsample_add_bwd")
    err = fn(_build.ptr(dy), _build.ptr(dlow), N, H, W, C, _DTYPES[dy.dtype], _build.stream())
    _build.check(err, "K18 upsample_add_bwd")
    kcount.count("upsample_add_bwd")
    return dlow


def upsample_add_bwd(dy: torch.Tensor) -> torch.Tensor:
    """low's gradient at the junction (see `upsample_add_bwd_plain`): K18 on
    CUDA tensors, the plain version on CPU tensors. dy is made
    channels_last."""
    dy = dy.contiguous(memory_format=_CL)
    if dy.device.type == "cpu":
        _check_nhwc("upsample_add_bwd", dy, plain=True)
        return upsample_add_bwd_plain(dy)
    if dy.device.type != "cuda":
        raise ValueError(f"upsample_add_bwd: unsupported device {dy.device}")
    return _upsample_add_bwd_cuda(dy)


class _UpsampleAdd(torch.autograd.Function):
    """K9 forward; backward: up1's gradient is dy itself, low's K18."""

    @staticmethod
    def forward(ctx, up1, low):
        return _upsample_add_fwd(up1, low)

    @staticmethod
    def backward(ctx, dy):
        return dy, upsample_add_bwd(dy)


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


def _in_graph(*params: torch.Tensor) -> bool:
    """True when autograd records this call for a parameter: then a derived
    tensor (a weight cast, a norm's affine) is computed in the graph on
    every call, never cached, so that the gradient reaches the parameter."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


def _cache_key(*ts: torch.Tensor) -> tuple:
    """`_weights_key` plus the inference-mode flag: a tensor made under
    `torch.inference_mode` is an inference tensor, which autograd may not
    save, so it is never reused outside that mode (nor the reverse)."""
    return _weights_key(*ts) + (torch.is_inference_mode_enabled(),)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` applied in x's dtype: parameters stay f32 and are cast when x is
    bf16 — in the autograd graph while it records the parameters, otherwise
    once per weight update, cached on the module."""
    if x.dtype == m.weight.dtype:
        return m(x)
    if _in_graph(m.weight, m.bias):
        return F.conv2d(x, m.weight.to(x.dtype, memory_format=_CL), m.bias.to(x.dtype),
                        m.stride, m.padding)
    key = _cache_key(m.weight, m.bias) + (x.dtype,)
    cache = getattr(m, "_cast_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            cache = (key, m.weight.to(x.dtype, memory_format=_CL), m.bias.to(x.dtype))
        m._cast_cache = cache
    return F.conv2d(x, cache[1], cache[2], m.stride, m.padding)


class MaskedBatchNorm(nn.Module):
    """BatchNorm with the ReLU that follows every norm of this net:
    relu(x * inv + (bias - mean * inv)) with inv = rsqrt(var + eps) * scale,
    per channel in f32, then `nn.relu` (the flax module). At inference the
    statistics are the running averages (K8 on the card); in train mode
    they are the batch's over the rows `row_mask` marks (K16, then K8;
    backward K17), and the running averages move towards them with
    momentum 0.9."""

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self._affine = None

    def _inv_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return inv, self.bias - self.mean * inv

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift), f32 [C]: in the autograd graph while it records
        `scale` / `bias`, otherwise computed once per weight update."""
        if _in_graph(self.scale, self.bias):
            return self._inv_shift()
        key = _cache_key(self.scale, self.bias, self.mean, self.var)
        if self._affine is None or self._affine[0] != key:
            with torch.no_grad():
                self._affine = (key, *self._inv_shift())
        return self._affine[1], self._affine[2]

    def forward(self, x: torch.Tensor, train: bool = False,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
        if not train:
            return norm_relu(x, *self.affine())
        y, mean, var = _NormReluTrain.apply(x, self.scale, self.bias, row_mask, self.eps)
        with torch.no_grad():  # flax: m * ra + (1 - m) * batch, each product rounded
            self.mean.copy_(self.mean * self.MOMENTUM + mean * (1 - self.MOMENTUM))
            self.var.copy_(self.var * self.MOMENTUM + var * (1 - self.MOMENTUM))
        return y


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

    def forward(self, x: torch.Tensor, train: bool = False,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
        y = conv(self.conv0, self.norm0(x, train, row_mask))
        y = conv(self.conv1, self.norm1(y, train, row_mask))
        y = conv(self.conv2, self.norm2(y, train, row_mask))
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

    def forward(self, x: torch.Tensor, train: bool = False,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
        up1 = x
        for m in self.up1:
            up1 = m(up1, train, row_mask)
        low = _max_pool2(x)
        for m in self.low1:
            low = m(low, train, row_mask)
        if isinstance(self.low2, Hourglass):
            low = self.low2(low, train, row_mask)
        else:
            for m in self.low2:
                low = m(low, train, row_mask)
        for m in self.low3:
            low = m(low, train, row_mask)
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
        if dtype not in _DTYPES and dtype != torch.float64:
            raise ValueError(f"working dtype must be f32 or bf16 (f64 on the CPU), got {dtype}")
        self.dtype = dtype
        self.n_stack = n_stack
        self.depth = depth
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

    def forward(self, x: torch.Tensor, extra: torch.Tensor | None = None, train: bool = False,
                row_mask: torch.Tensor | None = None):
        """x [N, C, H, W] channels_last -> list of n_stack f32
        [N, num_output, H/4, W/4] logits. `train`: batch statistics over the
        rows `row_mask` [N] marks real (all rows without it), and the
        running averages' update."""
        dt = self.dtype
        t = (train, row_mask)
        x = self.stem_norm(conv(self.stem, x.to(dt)), *t)
        x = self.pre[0](x, *t)
        x = _max_pool2(x)
        x = self.pre[1](x, *t)
        x = self.pre[2](x, *t)
        if self.extra_proj is not None:
            if extra is None:
                x = x + self.extra_proj.bias.to(dt)[None, :, None, None]
            else:
                x = x + conv(self.extra_proj, extra.to(dt))
        elif extra is not None:
            raise ValueError("this backbone has no post-stem projection")
        outs = []
        for i in range(self.n_stack):
            ll = self.hgs[i](x, *t)
            for m in self.lls[i]:
                ll = m(ll, *t)
            ll = self.ll_norms[i](conv(self.ll_convs[i], ll), *t)
            tmp_out = self.heads[i](ll.to(kcount.plain_dtype(dt)))
            outs.append(tmp_out)
            if i < self.n_stack - 1:
                x = x + conv(self.ll_merges[i], ll) + conv(self.out_merges[i], tmp_out.to(dt))
        return outs
