"""The int8 engine's kernels (B5), each beside its plain PyTorch version.

Port of the device operations of `suo_slam_tpu/models/int8_forward.py`
`_Int8Engine`. Activations are NHWC s8 codes with an f32 scale; every
floating step follows JAX's bf16 operation order, rounding after each
product, sum and quotient as XLA does on the CPU:

- K11 `int8_conv` (`csrc/int8_conv.cu`): s8 x s8 convolution with exact s32
  sums, rounded once to bf16, then z = bf16(bf16(y * e1) + e2) per output
  channel, written as bf16 (`conv_raw`) or as s8 codes
  clip(rint(max(z, 0))) (`conv_nrq`);
- K12 `int8_quant` (`csrc/int8_quant.cu`): the quantize family — raw codes
  clip(rint(x / div)), normalised codes clip(rint(max(x * m + c, 0))), or
  both in one pass (`quant`, `nrq`, `quant_pair`), on f32, bf16 or s8 input;
- K13 `int8_maxpool` / `int8_upsample_add` (`csrc/int8_pool_junction.cu`):
  the s8 2x2 max-pool and the junction bf16(up1 * e_up) + bf16(low * e_low)
  with `low` upsampled 2x through indices.

The per-channel vectors (e1, e2, div, m, c, e_up, e_low) are f32 tensors on
the activations' device holding values of the operation's dtype; the engine
folds them from the scales. A CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. The plain convolution sums the codes
in f64 — exact: every partial sum is an integer far below 2^53 — and rounds
the integer to bf16 once, as the kernel does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels as kcount
from ..kernels import _build

CIN_ALIGN = 16  # K11 reads 16-byte vectors of input channels


class QConv(NamedTuple):
    """A convolution's weights quantized for K11: s8 codes [Cout, KH, KW,
    Cin_p] (Cin zero-padded to a multiple of CIN_ALIGN) on the activations'
    device, and host f32 per-output-channel scales and bias."""

    wq: torch.Tensor
    s_w: torch.Tensor
    bias: torch.Tensor
    stride: int
    pad: int
    cin: int


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _check(name: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _vec(name: str, v: torch.Tensor, C: int, dev) -> torch.Tensor:
    _check(name, v.shape == (C,) and v.dtype == torch.float32 and v.device == dev,
           f"per-channel vectors must be f32 [{C}] on {dev}, got {tuple(v.shape)} "
           f"{v.dtype} {v.device}")
    return v.contiguous()


# K11 ---------------------------------------------------------------------------
def out_hw(h: int, w: int, qc: QConv) -> tuple[int, int]:
    kh, kw = qc.wq.shape[1:3]
    return ((h + 2 * qc.pad - kh) // qc.stride + 1, (w + 2 * qc.pad - kw) // qc.stride + 1)


def s32_to_bf16(y: torch.Tensor) -> torch.Tensor:
    """Integer-valued f64 / int64 -> bf16 with one round to nearest even:
    truncate to f32, set a sticky bit when that was inexact, then round (the
    kernel's `s32_to_bf16`)."""
    v = y.to(torch.int64)
    f = v.to(torch.float32)
    over = f.to(torch.int64).abs() > v.abs()
    f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    sticky = (f.to(torch.int64) != v).to(torch.int32)
    return (f.view(torch.int32) | sticky).view(torch.float32).to(torch.bfloat16)


def int8_conv_plain(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
                    out_s8: bool) -> torch.Tensor:
    """Plain K11 on NHWC s8 codes x [N, H, W, Cin]: the convolution in f64,
    then the epilogue in bf16 operations."""
    w = qc.wq[..., : x.shape[-1]].permute(0, 3, 1, 2).to(torch.float64)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), w, None, qc.stride, qc.pad)
    yb = s32_to_bf16(torch.round(y).permute(0, 2, 3, 1))
    z = yb * e1.to(torch.bfloat16) + e2.to(torch.bfloat16)
    if not out_s8:
        return z.contiguous()
    return torch.clamp(torch.round(torch.relu(z)), -127, 127).to(torch.int8).contiguous()


_CONV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _int8_conv_cuda(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
                    out_s8: bool) -> torch.Tensor:
    name = "K11 int8_conv"
    dev = x.device
    _check(name, x.dtype == torch.int8 and x.dim() == 4 and x.is_contiguous(),
           f"expected contiguous NHWC s8 codes, got {tuple(x.shape)} {x.dtype}")
    N, H, W, cin = x.shape
    Cout, KH, KW, cin_p = qc.wq.shape
    _check(name, cin == qc.cin and qc.wq.dtype == torch.int8 and qc.wq.device == dev
           and qc.wq.is_contiguous() and cin_p % CIN_ALIGN == 0,
           f"weights {tuple(qc.wq.shape)} {qc.wq.dtype} on {qc.wq.device} do not fit "
           f"input {tuple(x.shape)} on {dev}")
    if cin != cin_p:
        x = F.pad(x, (0, cin_p - cin))
    e1, e2 = _vec(name, e1, Cout, dev), _vec(name, e2, Cout, dev)
    Ho, Wo = out_hw(H, W, qc)
    out = torch.empty((N, Ho, Wo, Cout), dtype=torch.int8 if out_s8 else torch.bfloat16,
                      device=dev)
    fn = _build.entry("int8_conv", _CONV_ARGTYPES)
    err = fn(_build.ptr(x), _build.ptr(qc.wq), _build.ptr(e1), _build.ptr(e2), _build.ptr(out),
             N, H, W, cin_p, Cout, KH, KW, qc.stride, qc.pad, Ho, Wo, int(out_s8),
             _build.stream())
    _build.check(err, name)
    kcount.count("int8_conv")
    return out


def int8_conv(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
              out_s8: bool) -> torch.Tensor:
    """s8 convolution with the folded epilogue (see `int8_conv_plain`): K11
    on CUDA tensors, the plain version on CPU tensors. Returns NHWC bf16
    (out_s8=False) or s8 codes."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, qc, e1, e2, out_s8)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    return _int8_conv_cuda(x, qc, e1, e2, out_s8)


# K12 ---------------------------------------------------------------------------
_QUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def op_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the quantize family computes in: x's own, bf16 for codes."""
    return torch.bfloat16 if x.dtype == torch.int8 else x.dtype


def int8_quant_plain(x: torch.Tensor, div: torch.Tensor | None, m: torch.Tensor | None = None,
                     c: torch.Tensor | None = None):
    """Plain K12 on an NHWC tensor (f32, bf16 or s8 codes): (raw codes
    clip(rint(x / div)) or None, normalised codes clip(rint(max(x * m + c,
    0))) or None), each operation in the op dtype."""
    dt = op_dtype(x)
    xd = x.to(dt)
    raw = norm = None
    if div is not None:
        raw = torch.clamp(torch.round(xd / div.to(dt)), -127, 127).to(torch.int8)
    if m is not None:
        y = torch.relu(xd * m.to(dt) + c.to(dt))
        norm = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return raw, norm


_QUANT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 6)


def _int8_quant_cuda(x: torch.Tensor, div: torch.Tensor | None, m: torch.Tensor | None = None,
                     c: torch.Tensor | None = None):
    name = "K12 int8_quant"
    dev = x.device
    _check(name, x.dtype in _QUANT_DTYPES and x.is_contiguous() and x.dim() >= 1,
           f"expected a contiguous f32, bf16 or s8 tensor, got {x.dtype}")
    _check(name, div is not None or m is not None, "no output requested")
    _check(name, div is None or x.dtype != torch.int8, "s8 codes take no raw output")
    C = x.shape[-1]
    null = ctypes.c_void_p(None)
    raw = norm = None
    p_div = p_m = p_c = p_raw = p_norm = null
    if div is not None:
        div = _vec(name, div, C, dev)
        raw = torch.empty(x.shape, dtype=torch.int8, device=dev)
        p_div, p_raw = _build.ptr(div), _build.ptr(raw)
    if m is not None:
        m, c = _vec(name, m, C, dev), _vec(name, c, C, dev)
        norm = torch.empty(x.shape, dtype=torch.int8, device=dev)
        p_m, p_c, p_norm = _build.ptr(m), _build.ptr(c), _build.ptr(norm)
    fn = _build.entry("int8_quant", _QUANT_ARGTYPES)
    err = fn(_build.ptr(x), _QUANT_DTYPES[x.dtype], x.numel(), C, p_div, p_m, p_c, p_raw,
             p_norm, _build.stream())
    _build.check(err, name)
    kcount.count("int8_quant")
    return raw, norm


def int8_quant(x: torch.Tensor, div: torch.Tensor | None, m: torch.Tensor | None = None,
               c: torch.Tensor | None = None):
    """The quantize family (see `int8_quant_plain`): K12 on CUDA tensors, the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int8_quant_plain(x, div, m, c)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quant: unsupported device {x.device}")
    return _int8_quant_cuda(x, div, m, c)


# K13 ---------------------------------------------------------------------------
def int8_maxpool_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain K13 pool: VALID 2x2 / stride-2 max of NHWC s8 codes."""
    N, H, W, C = x.shape
    Ho, Wo = H // 2, W // 2
    return x[:, : 2 * Ho, : 2 * Wo].reshape(N, Ho, 2, Wo, 2, C).amax(dim=(2, 4)).contiguous()


def int8_upsample_add_plain(up1: torch.Tensor, low: torch.Tensor, e_up: torch.Tensor,
                            e_low: torch.Tensor) -> torch.Tensor:
    """Plain K13 junction: bf16(up1 * e_up) + bf16(nearest2x(low) * e_low) in
    bf16 operations (NHWC)."""
    bf = torch.bfloat16
    lo = low.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return (up1.to(bf) * e_up.to(bf) + lo.to(bf) * e_low.to(bf)).contiguous()


def _codes4(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        _check(name, x.dtype == torch.int8 and x.dim() == 4 and x.is_contiguous()
               and x.shape[-1] % 4 == 0,
               f"expected contiguous NHWC s8 codes with C % 4 == 0, got {tuple(x.shape)} "
               f"{x.dtype}")


def _int8_maxpool_cuda(x: torch.Tensor) -> torch.Tensor:
    name = "K13 int8_maxpool"
    _codes4(name, x)
    N, H, W, C = x.shape
    out = torch.empty((N, H // 2, W // 2, C), dtype=torch.int8, device=x.device)
    fn = _build.entry("int8_pool_junction", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p], symbol="suo_int8_maxpool")
    _build.check(fn(_build.ptr(x), _build.ptr(out), N, H, W, C, _build.stream()), name)
    kcount.count("int8_pool_junction")
    return out


def _int8_upsample_add_cuda(up1: torch.Tensor, low: torch.Tensor, e_up: torch.Tensor,
                            e_low: torch.Tensor) -> torch.Tensor:
    name = "K13 int8_upsample_add"
    _codes4(name, up1, low)
    N, H, W, C = up1.shape
    _check(name, tuple(low.shape) == (N, H // 2, W // 2, C) and H % 2 == 0 and W % 2 == 0
           and low.device == up1.device,
           f"low {tuple(low.shape)} is not half of up1 {tuple(up1.shape)}")
    e_up, e_low = _vec(name, e_up, C, up1.device), _vec(name, e_low, C, up1.device)
    out = torch.empty((N, H, W, C), dtype=torch.bfloat16, device=up1.device)
    fn = _build.entry("int8_pool_junction", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p], symbol="suo_int8_upsample_add")
    err = fn(_build.ptr(up1), _build.ptr(low), _build.ptr(e_up), _build.ptr(e_low),
             _build.ptr(out), N, H, W, C, _build.stream())
    _build.check(err, name)
    kcount.count("int8_pool_junction")
    return out


def int8_maxpool(x: torch.Tensor) -> torch.Tensor:
    """s8 2x2 max-pool: K13 on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return int8_maxpool_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"int8_maxpool: unsupported device {x.device}")
    return _int8_maxpool_cuda(x)


def int8_upsample_add(up1: torch.Tensor, low: torch.Tensor, e_up: torch.Tensor,
                      e_low: torch.Tensor) -> torch.Tensor:
    """The s8 hourglass junction (see `int8_upsample_add_plain`): K13 on CUDA
    tensors, the plain version on CPU tensors."""
    if up1.device.type == "cpu":
        return int8_upsample_add_plain(up1, low, e_up, e_low)
    if up1.device.type != "cuda":
        raise ValueError(f"int8_upsample_add: unsupported device {up1.device}")
    return _int8_upsample_add_cuda(up1, low, e_up, e_low)
