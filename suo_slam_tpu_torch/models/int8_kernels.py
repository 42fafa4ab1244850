"""The int8 engine's kernels (B5), each beside its plain PyTorch version.

Port of the device operations of `suo_slam_tpu/models/int8_forward.py`
`_Int8Engine`. Activations are NHWC s8 codes with an f32 scale; every
floating step follows JAX's bf16 operation order, rounding after each
product, sum and quotient as XLA does on the CPU:

- K11 `int8_conv` (`csrc/int8_conv.cu`): s8 x s8 convolution with exact s32
  sums, rounded once to bf16, then z = bf16(bf16(y * e1) + e2) per output
  channel, written as bf16 (`conv_raw`) or as s8 codes
  clip(rint(max(z, 0))) (`conv_nrq`); or, for the quantized PkpNet's
  `QuantConv` (`models/quant.py`), the f32 epilogue z = f32(y) * e1 + e2
  (e1 = s_x * s_w, e2 = the bias) cast once to f32 or bf16
  (`f32_epilogue`); `plan_conv` picks its route (`wgmma` fed by a TMA ring
  in persistent blocks for every stride-1 convolution, `mma.sync` for the
  stride-2 stems), tiles and ring on the host;
- K12 `int8_quant` (`csrc/int8_quant.cu`): the quantize family — raw codes
  clip(rint(x / div)), normalised codes clip(rint(max(x * m + c, 0))), or
  both in one pass (`quant`, `nrq`, `quant_pair`), on f32, bf16 or s8 input,
  or on the prologue bf16(q1 * s1) [+ bf16(q2 * s2)] [+ t] of s8 operands
  (`Deq`): JAX's dequantize-and-add before a quantize, formed in the pass;
  with `f32_ops`, a bf16 input's raw codes in f32 operations (`QuantConv`
  widens its input to f32 before the division);
  and two prologue modes that take the hourglass's max-pool and junction
  into the pass (`plan_quant`): `pool=True` reads the s8 input as the max of
  its 2x2 windows and writes the pooled codes as the raw output beside their
  nrq; a `Deq` with `up=True` as the second operand is read at (h/2, w/2),
  so the junction's bf16 sum feeds the quantize without being written;
- K13 `int8_maxpool` / `int8_upsample_add` (`csrc/int8_pool_junction.cu`),
  the earlier design of those two, off the int8 forward since K12 took
  them: the s8 2x2 max-pool and the junction bf16(up1 * e_up) +
  bf16(low * e_low) with `low` upsampled 2x through indices.

The per-channel vectors (e1, e2, div, m, c, e_up, e_low) are f32 tensors on
the activations' device holding values of the operation's dtype; the engine
folds them from the scales. A CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. The plain convolution sums the codes
in f64 — exact: every partial sum is an integer far below 2^53 — and rounds
the integer to bf16 once, as the kernel does.
"""

from __future__ import annotations

import ctypes
import functools
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
    kernel's `acc_f32`)."""
    v = y.to(torch.int64)
    f = v.to(torch.float32)
    over = f.to(torch.int64).abs() > v.abs()
    f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    sticky = (f.to(torch.int64) != v).to(torch.int32)
    return (f.view(torch.int32) | sticky).view(torch.float32).to(torch.bfloat16)


def int8_conv_plain(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
                    out_s8: bool = False, f32_epilogue: torch.dtype | None = None
                    ) -> torch.Tensor:
    """Plain K11 on NHWC s8 codes x [N, H, W, Cin]: the convolution in f64,
    then the epilogue in bf16 operations; with `f32_epilogue` (f32 or bf16)
    the f32 epilogue f32(y) * e1 + e2, each operation rounded in f32, cast
    to that dtype."""
    w = qc.wq[..., : x.shape[-1]].permute(0, 3, 1, 2).to(torch.float64)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), w, None, qc.stride, qc.pad)
    y = torch.round(y).permute(0, 2, 3, 1)
    if f32_epilogue is not None:  # (an exact integer: one rounding to f32, as from s32)
        return (y.to(torch.float32) * e1 + e2).to(f32_epilogue).contiguous()
    yb = s32_to_bf16(y)
    z = yb * e1.to(torch.bfloat16) + e2.to(torch.bfloat16)
    if not out_s8:
        return z.contiguous()
    return torch.clamp(torch.round(torch.relu(z)), -127, 127).to(torch.int8).contiguous()


WG_ROWS = 128          # K11's wgmma route: output pixels per tile (two warpgroups of 64)
WG_MAX_STAGES = 6      # the deepest ring of TMA stages it plans
WG_MAX_COUT = 512      # its e1 / e2 are staged whole in shared memory
WG_SMEM = 115712       # shared memory of one of two blocks on an SM (228 KB, 1 KB reserved each)


class ConvPlan(NamedTuple):
    """How K11 runs one convolution (`plan_conv`): route "wgmma" (persistent
    blocks, a TMA ring of `stages`, `wgmma` s8) with its pixel tile (Nt, Ht,
    Wt), channel box `cbox` (bytes of Cin per stage; its swizzle is as
    wide), N tile `bn`, the count of (pixel, N) tiles and dynamic shared
    memory; or route "mma_sync" (the stride-2 stem: `mma.sync` with a
    `cp.async` double buffer, one block per 128 x 64 tile)."""

    route: str
    tile: tuple
    cbox: int
    bn: int
    grid: tuple
    smem: int
    stages: int


# K11's epilogue modes (`mode` in `csrc/int8_conv.cu`): the engine's bf16
# epilogue written as bf16 or as s8 codes; the f32 epilogue written as f32 or
# cast to bf16
MODE_BF16, MODE_S8, MODE_F32, MODE_F32_TO_BF16 = range(4)


def conv_mode(out_s8: bool, f32_epilogue: torch.dtype | None) -> int:
    if f32_epilogue is None:
        return MODE_S8 if out_s8 else MODE_BF16
    if out_s8 or f32_epilogue not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K11: the f32 epilogue writes f32 or bf16, got out_s8={out_s8}, "
                         f"{f32_epilogue}")
    return MODE_F32 if f32_epilogue == torch.float32 else MODE_F32_TO_BF16


def wg_smem(stages: int, bn: int, cbox: int, n_cols: int, mode: int = MODE_BF16) -> int:
    """Dynamic shared memory of K11's wgmma route (`wg_smem` in
    `csrc/int8_conv.cu`): alignment, the ring, the output tile (f32 rows in
    MODE_F32, else at the bf16 pitch), the barriers, e1 / e2 for every N
    tile (bf16x2 pairs, or f32 for the f32 epilogue), the rows' offsets."""
    tile = 4 if mode == MODE_F32 else 2
    e = 8 if mode >= MODE_F32 else 4
    return (1024 + stages * (WG_ROWS + bn) * cbox + WG_ROWS * (tile * bn + 16) + 16 * stages
            + e * n_cols * bn + 8 * WG_ROWS)


def wg_smem_stage(bn: int, cbox: int) -> int:
    """Shared memory of one stage of the ring: its A and B boxes and its
    two barriers."""
    return (WG_ROWS + bn) * cbox + 16


@functools.lru_cache(maxsize=None)
def plan_conv(N: int, H: int, W: int, cin_p: int, cout: int, kh: int, kw: int, stride: int,
              pad: int, mode: int = MODE_BF16) -> ConvPlan:
    """K11's host-side plan for an NHWC [N, H, W, cin_p] s8 input. Every
    stride-1 "SAME" convolution with cout <= WG_MAX_COUT takes the wgmma
    route: the pixel tile is whole rows of the image (Wt = W up to 128),
    then rows (Ht), then images (Nt), at most WG_ROWS pixels, so one TMA box
    per tap holds the tile's inputs at every hourglass level (8 x 4 x 4 at
    4x4, 1 x 2 x 64 at 64x64, 1 x 1 x 128 at 128x128); N tiles of 64 or 128
    columns (Cout 256: two, on neighbouring tiles); a channel box of 128
    bytes where cin_p is a multiple of 128 and a ring of two such stages
    fits beside the epilogue `mode`'s output tile, else 64 (cin_p 48: the
    box's tail is TMA's zero fill; on the card 128-byte boxes in a ring of
    2 beat 64-byte ones in a ring of 4); the ring as deep as two blocks on
    an SM allow (at most WG_MAX_STAGES)."""
    cdiv = lambda a, b: -(-a // b)
    ho, wo = (H + 2 * pad - kh) // stride + 1, (W + 2 * pad - kw) // stride + 1
    if (stride == 1 and (ho, wo) == (H, W) and cin_p % CIN_ALIGN == 0
            and cout <= WG_MAX_COUT):
        wt = min(W, WG_ROWS)
        ht = min(H, max(1, WG_ROWS // wt))
        nt = min(N, max(1, WG_ROWS // (wt * ht)))
        bn = min(128, 64 * cdiv(cout, 64))
        n_cols = cdiv(cout, bn)
        fits = lambda cb: (WG_SMEM - wg_smem(0, bn, cb, n_cols, mode)) // wg_smem_stage(bn, cb)
        cbox = 128 if cin_p % 128 == 0 and fits(128) >= 2 else 64
        stages = min(WG_MAX_STAGES, fits(cbox))
        if stages >= 2:  # (a ring of one stage would deadlock)
            grid = (cdiv(N, nt) * cdiv(H, ht) * cdiv(W, wt), n_cols)
            return ConvPlan("wgmma", (nt, ht, wt), cbox, bn, grid,
                            wg_smem(stages, bn, cbox, n_cols, mode), stages)
    return ConvPlan("mma_sync", (0, 0, 0), 0, 0, (cdiv(N * ho * wo, 128), cdiv(cout, 64)), 0, 0)


_ROUTES = {"mma_sync": 0, "wgmma": 1}
_CONV_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_void_p]


def _int8_conv_cuda(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
                    out_s8: bool = False, f32_epilogue: torch.dtype | None = None
                    ) -> torch.Tensor:
    name = "K11 int8_conv"
    dev = x.device
    mode = conv_mode(out_s8, f32_epilogue)
    _check(name, x.dtype == torch.int8 and x.dim() == 4 and x.is_contiguous(),
           f"expected contiguous NHWC s8 codes, got {tuple(x.shape)} {x.dtype}")
    N, H, W, cin = x.shape
    Cout, KH, KW, cin_p = qc.wq.shape
    _check(name, cin in (qc.cin, cin_p) and qc.wq.dtype == torch.int8 and qc.wq.device == dev
           and qc.wq.is_contiguous() and cin_p % CIN_ALIGN == 0,
           f"weights {tuple(qc.wq.shape)} {qc.wq.dtype} on {qc.wq.device} do not fit "
           f"input {tuple(x.shape)} on {dev}")
    if cin != cin_p:  # codes not written CIN_ALIGN wide by K12 (the engine's are)
        x = F.pad(x, (0, cin_p - cin))
    e1, e2 = _vec(name, e1, Cout, dev), _vec(name, e2, Cout, dev)
    Ho, Wo = out_hw(H, W, qc)
    dtype = {MODE_S8: torch.int8, MODE_F32: torch.float32}.get(mode, torch.bfloat16)
    out = torch.empty((N, Ho, Wo, Cout), dtype=dtype, device=dev)
    plan = plan_conv(N, H, W, cin_p, Cout, KH, KW, qc.stride, qc.pad, mode)
    fn = _build.entry("int8_conv", _CONV_ARGTYPES)
    err = fn(_build.ptr(x), _build.ptr(qc.wq), _build.ptr(e1), _build.ptr(e2), _build.ptr(out),
             N, H, W, cin_p, Cout, KH, KW, qc.stride, qc.pad, Ho, Wo, mode,
             _ROUTES[plan.route], *plan.tile, plan.cbox, plan.bn, plan.stages, _build.stream())
    _build.check(err, name)
    kcount.count("int8_conv")
    return out


def int8_conv(x: torch.Tensor, qc: QConv, e1: torch.Tensor, e2: torch.Tensor,
              out_s8: bool = False, f32_epilogue: torch.dtype | None = None) -> torch.Tensor:
    """s8 convolution with the folded epilogue (see `int8_conv_plain`): K11
    on CUDA tensors, the plain version on CPU tensors. Returns NHWC bf16
    (out_s8=False) or s8 codes; with `f32_epilogue`, the f32 epilogue's
    result in that dtype."""
    if x.device.type == "cpu":
        conv_mode(out_s8, f32_epilogue)
        return int8_conv_plain(x, qc, e1, e2, out_s8, f32_epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    return _int8_conv_cuda(x, qc, e1, e2, out_s8, f32_epilogue)


# K12 ---------------------------------------------------------------------------
_QUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
QUANT_MAX_C = 1024  # K12 stages its per-channel vectors in shared memory


class Deq(NamedTuple):
    """An operand of K12's prologue, dequantized as bf16(q * s): NHWC s8
    codes q and their scale s, an f32 [C] vector of bf16 values (a
    per-tensor scale expanded). `up`: the second operand of a junction, q
    at half the first's resolution, read nearest-2x upsampled."""

    q: torch.Tensor
    s: torch.Tensor
    up: bool = False


def op_dtype(x) -> torch.dtype:
    """The dtype the quantize family computes in: x's own, bf16 for codes
    and for a prologue."""
    return torch.bfloat16 if isinstance(x, Deq) or x.dtype == torch.int8 else x.dtype


def padded(c: int) -> int:
    """Channels rounded up to K11's CIN_ALIGN."""
    return -(-c // CIN_ALIGN) * CIN_ALIGN


def upsample2x(q: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample of NHWC codes."""
    return q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def prologue_plain(x, x2: Deq | None = None, add: torch.Tensor | None = None) -> torch.Tensor:
    """K12's input: x itself (f32, bf16 or s8 codes), or for a `Deq` x the
    sum bf16(q * s) [+ bf16(q2 * s2)] [+ add] left to right in bf16, `add` a
    bf16 tensor of x's shape or an f32 [C] vector of bf16 values; q2 read
    upsampled where x2.up."""
    if not isinstance(x, Deq):
        if x2 is not None or add is not None:
            raise ValueError("int8_quant: a prologue starts from a Deq operand")
        return x
    bf = torch.bfloat16
    v = x.q.to(bf) * x.s.to(bf)
    if x2 is not None:
        v = v + (upsample2x(x2.q) if x2.up else x2.q).to(bf) * x2.s.to(bf)
    if add is not None:
        v = v + add.to(bf)
    return v


# K12's prologue modes (`mode` in `csrc/int8_quant.cu`)
QUANT_PLAIN, QUANT_POOL, QUANT_UP = range(3)


class QuantPlan(NamedTuple):
    """How K12 runs a call (`plan_quant`): its prologue mode, the output
    pixels P, channels C and output row width c_out, the spatial extents
    the mode reads (pool: the unpooled input's; junction: the output's; 0
    in the plain mode) and whether it takes the vector path."""

    mode: int
    P: int
    C: int
    c_out: int
    H: int
    W: int
    vec: bool


def plan_quant(shape, c_out: int | None = None, *, pool: bool = False,
               up_shape: tuple | None = None, ptrs=()) -> QuantPlan:
    """K12's launch for an input of `shape` (the codes of a `Deq`, or the
    tensor): the pool mode for `pool`, the junction mode where the second
    operand is read upsampled (`up_shape`, its codes' shape: [N, H/2, W/2,
    C] of an [N, H, W, C] input); `ptrs` the addresses of every tensor the
    kernel reads or writes. The vector path (one 16-byte load or store per
    16 channels, no tail) needs c_out == C, C % 16 == 0 and every address
    16-byte aligned. Raises where a mode cannot take the shapes (as the
    plain version does)."""
    C = shape[-1]
    c_out = C if c_out is None else c_out
    _check("K12 int8_quant", 0 < C <= QUANT_MAX_C and c_out >= C, f"C = {C}, c_out = {c_out}")
    mode, H, W = QUANT_PLAIN, 0, 0
    P = 1
    for d in shape[:-1]:
        P *= d
    if pool or up_shape is not None:
        _check("K12 int8_quant", len(shape) == 4 and not (pool and up_shape is not None),
               f"the pool and junction modes take one NHWC input, got {tuple(shape)}")
        N, H, W, _ = shape
    if pool:
        mode = QUANT_POOL
        _check("K12 int8_quant", H >= 2 and W >= 2, f"a 2x2 pool of {tuple(shape)}")
        P = N * (H // 2) * (W // 2)
    elif up_shape is not None:
        mode = QUANT_UP
        _check("K12 int8_quant", H % 2 == 0 and W % 2 == 0
               and tuple(up_shape) == (N, H // 2, W // 2, C),
               f"a junction's second operand {tuple(up_shape)} is not half of {tuple(shape)}")
    vec = c_out == C and C % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return QuantPlan(mode, P, C, c_out, H, W, vec)


def _mode_check(x, div, x2, add, f32_ops, pool) -> None:
    """The operands the pool and junction modes take (plain and kernel)."""
    name = "K12 int8_quant"
    if pool:
        _check(name, not isinstance(x, Deq) and x.dtype == torch.int8 and x2 is None
               and add is None and div is None and not f32_ops,
               "the pool mode takes s8 codes alone (no prologue operand, no divisor: its raw "
               "output is the pooled codes)")
    if x2 is not None and x2.up:
        _check(name, isinstance(x, Deq), "a junction starts from a Deq operand")
        plan_quant(x.q.shape, up_shape=x2.q.shape)


def int8_quant_plain(x, div: torch.Tensor | None, m: torch.Tensor | None = None,
                     c: torch.Tensor | None = None, *, x2: Deq | None = None,
                     add: torch.Tensor | None = None, c_out: int | None = None,
                     f32_ops: bool = False, pool: bool = False):
    """Plain K12 on an NHWC input (f32, bf16, s8 codes, or the prologue
    `prologue_plain(x, x2, add)`): (raw codes clip(rint(x / div)) or None,
    normalised codes clip(rint(max(x * m + c, 0))) or None), each operation
    in the op dtype (f32 with `f32_ops`, for f32 or bf16 x alone); both
    outputs c_out (default C) channels wide, zero beyond C. `pool`: x (s8
    codes) is 2x2 max-pooled first and the raw output is the pooled codes."""
    if f32_ops and (isinstance(x, Deq) or x.dtype == torch.int8):
        raise ValueError("int8_quant: f32_ops takes an f32 or bf16 input, no prologue")
    _mode_check(x, div, x2, add, f32_ops, pool)
    if pool:
        xp = int8_maxpool_plain(x)
        C = xp.shape[-1]
        _, norm = int8_quant_plain(xp, None, m, c, c_out=c_out)
        raw = xp if c_out in (None, C) else F.pad(xp, (0, c_out - C)).contiguous()
        return raw, norm
    xd = prologue_plain(x, x2, add)
    dt = torch.float32 if f32_ops else op_dtype(xd)
    xd = xd.to(dt)
    C = xd.shape[-1]
    c_out = C if c_out is None else c_out
    raw = norm = None
    if div is not None:
        raw = torch.clamp(torch.round(xd / div.to(dt)), -127, 127).to(torch.int8)
    if m is not None:
        y = torch.relu(xd * m.to(dt) + c.to(dt))
        norm = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    if c_out != C:
        raw, norm = (None if t is None else F.pad(t, (0, c_out - C)).contiguous()
                     for t in (raw, norm))
    return raw, norm


_QUANT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _int8_quant_cuda(x, div: torch.Tensor | None, m: torch.Tensor | None = None,
                     c: torch.Tensor | None = None, *, x2: Deq | None = None,
                     add: torch.Tensor | None = None, c_out: int | None = None,
                     f32_ops: bool = False, pool: bool = False):
    name = "K12 int8_quant"
    p_s1 = p_x2 = p_s2 = p_add = p_addv = None  # a null pointer where unused
    if isinstance(x, Deq):
        xq = x.q
        _check(name, xq.dtype == torch.int8 and xq.is_contiguous(),
               f"a Deq operand holds contiguous s8 codes, got {xq.dtype}")
        C = xq.shape[-1]
        s1 = _vec(name, x.s, C, xq.device)  # kept alive until the launch
        p_s1 = _build.ptr(s1)
        if x2 is not None:
            _check(name, x2.q.dtype == torch.int8 and x2.q.is_contiguous()
                   and x2.q.device == xq.device and (x2.up or x2.q.shape == xq.shape),
                   f"second operand {tuple(x2.q.shape)} {x2.q.dtype} does not fit "
                   f"{tuple(xq.shape)}")
            s2 = _vec(name, x2.s, C, xq.device)
            p_x2, p_s2 = _build.ptr(x2.q), _build.ptr(s2)
        if add is not None and add.dim() == 1:
            add = _vec(name, add, C, xq.device)
            p_addv = _build.ptr(add)
        elif add is not None:
            _check(name, add.dtype == torch.bfloat16 and add.shape == xq.shape
                   and add.is_contiguous() and add.device == xq.device,
                   f"the addend must be a contiguous bf16 {tuple(xq.shape)} tensor or an f32 "
                   f"[C] vector, got {tuple(add.shape)} {add.dtype}")
            p_add = _build.ptr(add)
    else:
        xq = x
        _check(name, x2 is None and add is None, "a prologue starts from a Deq operand")
        _check(name, xq.dtype in _QUANT_DTYPES and xq.is_contiguous() and xq.dim() >= 1,
               f"expected a contiguous f32, bf16 or s8 tensor, got {xq.dtype}")
        _check(name, div is None or xq.dtype != torch.int8, "s8 codes take no raw output")
    _check(name, not f32_ops or (p_s1 is None and xq.dtype != torch.int8),
           "f32_ops takes an f32 or bf16 input, no prologue")
    _mode_check(x, div, x2, add, f32_ops, pool)
    dev = xq.device
    _check(name, pool or div is not None or m is not None, "no output requested")
    C = xq.shape[-1]
    c_out = C if c_out is None else c_out
    lead = tuple(xq.shape[:-1])
    if pool:
        lead = (lead[0], lead[1] // 2, lead[2] // 2)
    shape = lead + (c_out,)
    raw = norm = None
    p_div = p_m = p_c = p_raw = p_norm = None
    if div is not None or pool:
        raw = torch.empty(shape, dtype=torch.int8, device=dev)
        p_raw = _build.ptr(raw)
    if div is not None:
        div = _vec(name, div, C, dev)
        p_div = _build.ptr(div)
    if m is not None:
        m, c = _vec(name, m, C, dev), _vec(name, c, C, dev)
        norm = torch.empty(shape, dtype=torch.int8, device=dev)
        p_m, p_c, p_norm = _build.ptr(m), _build.ptr(c), _build.ptr(norm)
    up = x2 is not None and x2.up
    plan = plan_quant(xq.shape, c_out, pool=pool, up_shape=tuple(x2.q.shape) if up else None,
                      ptrs=[q for q in (_build.ptr(xq), p_x2, p_add, p_raw, p_norm) if q])
    fn = _build.entry("int8_quant", _QUANT_ARGTYPES)
    err = fn(_build.ptr(xq), _QUANT_DTYPES[xq.dtype], p_s1, p_x2, p_s2, p_add, p_addv,
             plan.P, C, c_out, p_div, p_m, p_c, p_raw, p_norm, int(f32_ops), plan.mode,
             plan.H, plan.W, int(plan.vec), _build.stream())
    _build.check(err, name)
    kcount.count("int8_quant")
    if plan.mode == QUANT_POOL:
        kcount.count("int8_quant_pool")
    elif plan.mode == QUANT_UP:
        kcount.count("int8_quant_junction")
    return raw, norm


def int8_quant(x, div: torch.Tensor | None, m: torch.Tensor | None = None,
               c: torch.Tensor | None = None, *, x2: Deq | None = None,
               add: torch.Tensor | None = None, c_out: int | None = None,
               f32_ops: bool = False, pool: bool = False):
    """The quantize family with its prologue (see `int8_quant_plain`): K12
    on CUDA tensors, the plain version on CPU tensors."""
    d = (x.q if isinstance(x, Deq) else x).device
    kw = dict(x2=x2, add=add, c_out=c_out, f32_ops=f32_ops, pool=pool)
    if d.type == "cpu":
        return int8_quant_plain(x, div, m, c, **kw)
    if d.type != "cuda":
        raise ValueError(f"int8_quant: unsupported device {d}")
    return _int8_quant_cuda(x, div, m, c, **kw)


# K13 ---------------------------------------------------------------------------
def int8_maxpool_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain K13 pool (and K12's pool prologue): VALID 2x2 / stride-2 max of
    NHWC s8 codes."""
    N, H, W, C = x.shape
    Ho, Wo = H // 2, W // 2
    return x[:, : 2 * Ho, : 2 * Wo].reshape(N, Ho, 2, Wo, 2, C).amax(dim=(2, 4)).contiguous()


def int8_upsample_add_plain(up1: torch.Tensor, low: torch.Tensor, e_up: torch.Tensor,
                            e_low: torch.Tensor) -> torch.Tensor:
    """Plain K13 junction: bf16(up1 * e_up) + bf16(nearest2x(low) * e_low) in
    bf16 operations (NHWC)."""
    bf = torch.bfloat16
    return (up1.to(bf) * e_up.to(bf) + upsample2x(low).to(bf) * e_low.to(bf)).contiguous()


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
