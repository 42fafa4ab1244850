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
  variance of train mode, with the norm's rstd / inv / shift and the running
  averages' update (one launch: `bn_train_stats`);
- K17 `norm_relu_bwd` (`csrc/bn_train.cu`): the backward of the norm + ReLU,
  through the batch statistics in train mode (with the scale's gradient),
  with fixed ones otherwise (one launch);
- K9 `upsample_add` (`csrc/upsample_add.cu`): the hourglass junction
  up1 + nearest2x(low), without materialising the upsampled tensor;
- K18 `upsample_add_bwd` (`csrc/upsample_add.cu`): low's gradient, the 2x2
  sums of the output's (up1's is the output's itself); 16-byte vectors of
  channels where C and the pointers allow, one value a thread otherwise
  (`plan_upsample_bwd` picks the route by shape and alignment);
- K20 `group_norm_relu` (`csrc/group_norm.cu`): the GroupNorm net's
  (`norm="group"`) norm + ReLU, per-sample group statistics and the affine
  in one call; K21 `group_norm_relu_bwd` its backward through the
  statistics, with the scale's and bias's gradients.
Each forward with its backward is one `torch.autograd.Function`, taken where
autograd records the call. All take NHWC memory (NCHW `channels_last`) and
raise on another layout. On CPU tensors they run their plain versions,
which the kernels match exactly (K16, K17, K20 and K21 up to the order of
their sums; K16's affine and running averages and K17's scale gradient bit
for bit). K16 and K17 have two designs (`design=`): "fused", the main path,
one cooperative launch of a persistent grid per call (`plan_bn`, scratch and
grid-barrier counters in a per-stream workspace, `_bn_workspace`), and
"split", the first design, kept for comparison. K20 and K21 take one of
two routes by shape: the cluster design, one launch per call of a
persistent grid of thread-block clusters, a cluster a sample (`plan_gn`;
`_gn_rows` asks the card how many run at once; K21's rows and arrival
counters in a per-stream workspace, `_gn_workspace`), wherever a CTA's
threads cover a pixel's channel vectors (every shape of the net); the split
design, the first one (three and four launches), for wider pixels. The
max-pools and the convolutions keep torch's autograd, as the JAX package
left them to XLA.

The net's kinds of norm and convolution are chosen at construction, as the
JAX package's `norm` and `conv_cls`: `norm="batch"` builds `MaskedBatchNorm`
everywhere, `"group"` `GroupNormRelu`; `conv_cls` builds every convolution
but the heads (`nn.Conv2d`, or the quantized net's `models/quant.QuantConv`),
which stay `nn.Conv2d` in f32.

`models/convert.py` maps the flax auto-names (`Conv_k`, `Norm_k`,
`Residual_k`, `Hourglass_k`), which follow the flax module's call order, onto
these submodules.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels as kcount
from ..kernels import _build
from ..parallel import mesh as _mesh

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


# K16 / K17: plans, workspace ---------------------------------------------------
# `csrc/bn_train.cu`'s constants: the fused design's CTA and its loads in
# flight; the split design's blocks (`channel_vec.cuh` kThreads, kIters).
# tests/test_torch_bn_train_plan.py reads them from the sources.
FUSED_THREADS = 512
STATS_UNROLL = 8
BWD_UNROLL = 4
SPLIT_THREADS = 256
SPLIT_ITERS = 16
MIN_ITERS = 2        # a fused CTA gets at least this many iterations of its loop
SMEM_LIMIT = 232448  # dynamic shared memory a block can use on sm_90
# the phases whose SM clock cycles `cycles=` takes (a row per block)
BN_STATS_PHASES = ("load", "math", "reduce", "barrier", "finalize")
BN_BWD_PHASES = BN_STATS_PHASES + ("barrier2", "dx")
DESIGNS = ("fused", "split")


class BnPlan(NamedTuple):
    """A fused K16 / K17 call's geometry (`bn_train.cu` `FLayout`): V
    channels a thread's vector, lanes_c channel-vector lanes x lanes_p
    pixel lanes, q pixel lanes a warp folds by shuffles, `rows` rows of
    the cross-warp reduction, `grid` co-resident CTAs (at most one a
    multiprocessor), `smem` bytes of dynamic shared memory, `part` f64 words
    of partial sums (a [C, 2] row per CTA)."""
    V: int
    lanes_c: int
    lanes_p: int
    q: int
    rows: int
    grid: int
    smem: int
    part: int


@functools.lru_cache(maxsize=512)
def plan_bn(kind: str, N: int, HW: int, C: int, itemsize: int, vec: bool, n_sm: int) -> BnPlan:
    """The fused design's plan of a K16 (`kind="stats"`) or K17 (`"bwd"`)
    call on [N, HW, C] values of `itemsize` bytes, 16-byte vectors when
    `vec`, on a card of `n_sm` multiprocessors: each CTA gets a slab of at
    least MIN_ITERS iterations of its loop (K16's slabs split the real rows'
    pixels, which the host does not know, so its grid is planned on all)."""
    if kind not in ("stats", "bwd"):
        raise ValueError(f"plan_bn: unknown kind {kind!r}")
    V = 16 // itemsize if vec else 1
    cv = C // V
    lanes_c = min(max(cv, 1), FUSED_THREADS)
    lanes_p = FUSED_THREADS // lanes_c
    q = 32 // lanes_c if lanes_c <= 32 and 32 % lanes_c == 0 else 1
    rows = lanes_p // q
    step = lanes_p * (STATS_UNROLL if kind == "stats" else BWD_UNROLL)
    grid = max(1, min(n_sm, -(-N * HW // (step * MIN_ITERS))))
    # the reduction rows, then K16's real-row indices or K17's five dx
    # coefficients of a channel block
    red = rows * lanes_c * V * 2 * 8
    smem = red + (4 * N if kind == "stats" else 5 * lanes_c * V * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K16 / K17: {N} rows x {C} channels need {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_LIMIT}")
    return BnPlan(V, lanes_c, lanes_p, q, rows, grid, smem, grid * C * 2)


def plan_split(N: int, HW: int, C: int, itemsize: int, vec: bool) -> int:
    """The split design's partial rows: its partial pass's blocks
    (`channel_vec.cuh` `Layout`: SPLIT_ITERS pixels a pixel lane)."""
    V = 16 // itemsize if vec else 1
    lanes_c = min(C // V, SPLIT_THREADS)
    per_block = (SPLIT_THREADS // max(lanes_c, 1)) * SPLIT_ITERS
    return -(-N * HW // per_block)


def _vectorizable(C: int, itemsize: int, *ts: torch.Tensor) -> bool:
    """16-byte vectors: C a multiple of a vector and every pointer aligned."""
    return C % (16 // itemsize) == 0 and all(t.data_ptr() % 16 == 0 for t in ts)


_n_sm: dict[int, int] = {}


def _multiprocessors(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _n_sm.get(i)
    if n is None:
        n = _n_sm[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return n


_bn_work: dict[tuple, tuple] = {}
_bn_work_lock = threading.Lock()


def _bn_workspace(dev: torch.device, stream: int, n_part: int, n_coef: int):
    """The fused design's scratch on `stream`: (uint32 [2] grid-barrier
    counters at zero, f64 [>= n_part] partials, f32 [>= n_coef] dx
    coefficients). Every launch leaves the counters at zero, so one set
    serves every call on the stream (and a captured graph); it grows by
    fresh allocations."""
    key = (dev.index, stream)
    w = _bn_work.get(key)
    if w is None or w[1].numel() < n_part or w[2].numel() < n_coef:
        with _bn_work_lock:
            w = _bn_work.get(key)
            if w is None or w[1].numel() < n_part or w[2].numel() < n_coef:
                size = lambda i, k: max(k, 0 if w is None else w[i].numel())
                w = (torch.zeros(2, dtype=torch.int32, device=dev) if w is None else w[0],
                     torch.empty(size(1, n_part), dtype=torch.float64, device=dev),
                     torch.empty(size(2, n_coef), dtype=torch.float32, device=dev))
                _bn_work[key] = w
    return w


def row_mask_u8(row_mask: torch.Tensor | None) -> torch.Tensor | None:
    """A row mask as the kernels read it (uint8 [N]), made once per step by
    `HourglassNet.forward`; the plain versions take it too."""
    if row_mask is None or row_mask.dtype == torch.uint8:
        return row_mask
    return row_mask.to(torch.uint8)


def _row_mask_u8(row_mask: torch.Tensor | None, N: int, dev) -> torch.Tensor | None:
    if row_mask is None:
        return None
    if row_mask.shape != (N,):
        raise ValueError(f"row_mask must be [{N}], got {tuple(row_mask.shape)}")
    if row_mask.dtype == torch.uint8 and row_mask.device == dev and row_mask.is_contiguous():
        return row_mask
    return row_mask.to(device=dev, dtype=torch.uint8).contiguous()


def _check_vectors(name: str, dev, C: int, *vs: torch.Tensor) -> list:
    vs = [v.contiguous() for v in vs]
    if any(v.shape != (C,) or v.dtype != torch.float32 or v.device != dev for v in vs):
        raise ValueError(f"{name}: per-channel vectors must be f32 [{C}] on x's device")
    return vs


def _bump(*ts: torch.Tensor) -> None:
    """Tell autograd (and `_cache_key`) that a kernel wrote these in place."""
    ts = [t for t in ts if not t.is_inference()]
    if ts:
        torch.autograd.graph.increment_version(ts)


# K16 ---------------------------------------------------------------------------
def _masked_count(row_mask: torch.Tensor | None, N: int, hw: int, dev) -> torch.Tensor:
    """M = max(sum(mask) * H * W, 1) in f64 (all rows without a mask)."""
    if row_mask is None:
        return torch.tensor(float(N * hw), dtype=torch.float64, device=dev)
    return torch.clamp((row_mask != 0).to(torch.float64).sum() * hw, min=1.0)


def _pack_sums(s1: torch.Tensor, s2: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """f64 [2C + 1]: (s1[c], s2[c]) interleaved per channel, then the count:
    the layout of the cross-rank modes' sums (`bn_train.cu`)."""
    return torch.cat([torch.stack([s1, s2], 1).reshape(-1), count.reshape(1)])


def _unpack_sums(sums: torch.Tensor):
    """(s1 [C], s2 [C], M = max(count, 1)) of `_pack_sums`' layout."""
    C = (sums.numel() - 1) // 2
    s = sums[: 2 * C].reshape(C, 2)
    return s[:, 0], s[:, 1], torch.clamp(sums[2 * C], min=1.0)


def bn_stats_partial_plain(x: torch.Tensor, row_mask: torch.Tensor | None = None):
    """Plain K16 partial mode: this rank's f64 [2C + 1] sums, (sum x, sum x^2)
    per channel over the rows `row_mask` (bool or uint8) marks (all rows
    without one), then their count of values, rows x H x W."""
    N, C, H, W = x.shape
    xd = x.to(torch.float64)
    if row_mask is None:
        count = torch.tensor(float(N * H * W), dtype=torch.float64, device=x.device)
    else:
        m = (row_mask != 0).to(torch.float64)
        xd = xd * m[:, None, None, None]
        count = m.sum() * (H * W)
    return _pack_sums(xd.sum((0, 2, 3)), (xd * xd).sum((0, 2, 3)), count)


def _bn_moments(sums: torch.Tensor, out: torch.dtype):
    """mean = s1 / M, var = max(s2 / M - mean^2, 0) in f64, rounded to `out`."""
    s1, s2, M = _unpack_sums(sums)
    mean = s1 / M
    var = torch.clamp(s2 / M - mean * mean, min=0.0)
    return mean.to(out), var.to(out)


def bn_stats_plain(x: torch.Tensor, row_mask: torch.Tensor | None = None):
    """Plain K16: per-channel mean and biased variance, f32 [C] (f64 for f64
    x), over the rows `row_mask` (bool or uint8) marks (all rows without
    one): f64 sums of x and x^2, mean = sum / M, var = sum2 / M - mean^2 with
    M = max(rows * H * W, 1)."""
    return _bn_moments(bn_stats_partial_plain(x, row_mask), kcount.plain_dtype(x.dtype))


def _bn_affine_plain(mean, var, scale, bias, eps, run_mean, run_var, momentum):
    rstd = torch.rsqrt(var + eps)
    inv = rstd * scale
    shift = bias - mean * inv
    if run_mean is not None:
        run_mean.copy_(run_mean * momentum + mean * (1 - momentum))
        run_var.copy_(run_var * momentum + var * (1 - momentum))
    return mean, var, rstd, inv, shift


def bn_train_stats_plain(x, row_mask, scale, bias, eps, run_mean=None, run_var=None,
                         momentum=0.9):
    """Plain fused K16: `bn_stats_plain`'s (mean, var), then the train-mode
    norm's epilogue in its eager operations: rstd = rsqrt(var + eps), inv =
    rstd * scale, shift = bias - mean * inv, and (given the buffers) the
    running averages updated in place as flax does, m * running + (1 - m) *
    batch with each product rounded. Returns (mean, var, rstd, inv, shift)."""
    mean, var = bn_stats_plain(x, row_mask)
    return _bn_affine_plain(mean, var, scale, bias, eps, run_mean, run_var, momentum)


def bn_stats_finalize_plain(sums, scale, bias, eps, run_mean=None, run_var=None, momentum=0.9,
                            dtype=torch.float32):
    """Plain K16 finalize mode: `bn_train_stats_plain`'s outputs from
    all-reduced sums (`bn_stats_partial_plain`'s layout summed over the
    ranks), M = max(the summed count, 1); mean and var in `dtype` (f64 for
    f64 activations)."""
    mean, var = _bn_moments(sums, dtype)
    return _bn_affine_plain(mean, var, scale, bias, eps, run_mean, run_var, momentum)


_BN_STATS_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                     ctypes.c_void_p, ctypes.c_int]
                            + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
_BN_STATS_FUSED_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                            + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 3
                            + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def _bn_stats_fused(x, mask, scale=None, bias=None, eps=1e-5, run_mean=None, run_var=None,
                    momentum=0.9, cycles=None):
    """One launch of the fused K16 (see `bn_train_stats_plain`; without
    scale and bias only mean and var are written)."""
    N, C, H, W = x.shape
    dev = x.device
    it = x.element_size()
    plan = plan_bn("stats", N, H * W, C, it, _vectorizable(C, it, x), _multiprocessors(dev))
    st = _build.stream(dev.index)
    bar, part, _ = _bn_workspace(dev, st, plan.part, 0)
    out = torch.empty((5, C), dtype=torch.float32, device=dev)
    affine = scale is not None
    if affine:
        vs = _check_vectors("K16 bn_stats", dev, C, scale, bias,
                            *(() if run_mean is None else (run_mean, run_var)))
        if run_mean is not None and (vs[2].data_ptr() != run_mean.data_ptr()
                                     or vs[3].data_ptr() != run_var.data_ptr()):
            raise ValueError("K16 bn_stats: the running averages must be contiguous")
    fn = _build.entry("bn_train", _BN_STATS_FUSED_ARGTYPES, "suo_bn_stats_fused")
    p = _build.ptr
    err = fn(p(x), None if mask is None else p(mask), N, H * W, C,
             p(vs[0]) if affine else None, p(vs[1]) if affine else None,
             eps, momentum, 1 - momentum,
             None if run_mean is None else p(run_mean), None if run_var is None else p(run_var),
             p(part), p(bar), *(p(out[i]) for i in range(5)), _DTYPES[x.dtype],
             int(plan.V > 1), plan.grid, plan.smem, None if cycles is None else p(cycles), st)
    _build.check(err, "K16 bn_stats")
    kcount.count("bn_stats")
    if run_mean is not None:
        _bump(run_mean, run_var)
    return tuple(out)


def _bn_stats_split(x, mask, cycles=None):
    """The split design: the partial pass and the finalize (two launches)."""
    N, C, H, W = x.shape
    dev = x.device
    it = x.element_size()
    n_part = plan_split(N, H * W, C, it, _vectorizable(C, it, x))
    part = torch.empty((n_part, C, 2), dtype=torch.float64, device=dev)
    mean = torch.empty(C, dtype=torch.float32, device=dev)
    var = torch.empty(C, dtype=torch.float32, device=dev)
    fn = _build.entry("bn_train", _BN_STATS_SPLIT_ARGTYPES, "suo_bn_stats")
    err = fn(_build.ptr(x), None if mask is None else _build.ptr(mask), N, H * W, C,
             _build.ptr(part), n_part, _build.ptr(mean), _build.ptr(var), _DTYPES[x.dtype],
             None if cycles is None else _build.ptr(cycles), _build.stream(dev.index))
    _build.check(err, "K16 bn_stats (split design)")
    kcount.count("bn_stats")
    return mean, var


def _bn_stats_cuda(x: torch.Tensor, row_mask: torch.Tensor | None = None, design: str = "fused",
                   cycles: torch.Tensor | None = None):
    """K16's bare statistics (mean, var) in either design; `cycles`: int64
    zeros [rows, len(BN_STATS_PHASES)] that take SM clock cycles per phase
    (rows: the fused plan's grid, or the split design's partial rows)."""
    _check_nhwc("K16 bn_stats", x)
    if design not in DESIGNS:
        raise ValueError(f"K16 bn_stats: unknown design {design!r}")
    mask = _row_mask_u8(row_mask, x.shape[0], x.device)
    if design == "split":
        return _bn_stats_split(x, mask, cycles)
    return _bn_stats_fused(x, mask, cycles=cycles)[:2]


def _bn_train_stats_cuda(x, row_mask, scale, bias, eps, run_mean=None, run_var=None,
                         momentum=0.9, cycles=None):
    _check_nhwc("K16 bn_stats", x)
    mask = _row_mask_u8(row_mask, x.shape[0], x.device)
    return _bn_stats_fused(x, mask, scale, bias, eps, run_mean, run_var, momentum, cycles)


def bn_train_stats(x, row_mask, scale, bias, eps, run_mean=None, run_var=None, momentum=0.9):
    """The train-mode norm's statistics and affine (see
    `bn_train_stats_plain`), the running averages updated in place: one
    launch of K16 on CUDA tensors, the plain version on CPU tensors. x must
    be channels_last."""
    if x.device.type == "cpu":
        _check_nhwc("bn_stats", x, plain=True)
        return bn_train_stats_plain(x, row_mask, scale, bias, eps, run_mean, run_var, momentum)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: unsupported device {x.device}")
    return _bn_train_stats_cuda(x, row_mask, scale, bias, eps, run_mean, run_var, momentum)


# K17 ---------------------------------------------------------------------------
def _bwd_g_plain(x, dy, inv, shift, mean):
    """(f, x in f, g = dy [y > 0] in f, xc = x - mean (x when mean is None)),
    f the plain versions' dtype (f32; f64 for f64 x)."""
    c4 = lambda t: t[None, :, None, None]
    f = kcount.plain_dtype(x.dtype)
    xf = x.to(f)
    on = (xf * c4(inv) + c4(shift)).to(x.dtype) > 0
    g = torch.where(on, dy.to(f), torch.zeros((), device=x.device))
    return f, g, xf - c4(mean) if mean is not None else xf


def _bwd_sums_plain(g, xc):
    """f64 [C] sums of g and g * xc over all rows."""
    gd = g.to(torch.float64)
    return gd.sum((0, 2, 3)), (gd * xc.to(torch.float64)).sum((0, 2, 3))


def _bwd_dx_plain(x, g, xc, inv, rstd, row_mask, s1, s2, M, f):
    """dx = inv g - m_n (inv s1 / M + xc inv rstd^2 s2 / M), the coefficients
    from f64 sums rounded once to f; dx in x's dtype, channels_last."""
    c4 = lambda t: t[None, :, None, None]
    ivd = inv.to(torch.float64)
    rd = rstd.to(torch.float64)
    b = (ivd * s1 / M).to(f)
    c = (ivd * rd * rd * s2 / M).to(f)
    corr = c4(b) + xc * c4(c)
    if row_mask is not None:
        corr = torch.where(row_mask[:, None, None, None] != 0, corr,
                           torch.zeros((), device=x.device))
    return (c4(inv) * g - corr).to(x.dtype).contiguous(memory_format=_CL)


def norm_relu_bwd_plain(x, dy, inv, shift, mean=None, rstd=None, row_mask=None):
    """Plain K17: the backward of y = relu(cast(x * inv + shift)).

    g = dy * [y > 0] in f32; sum_g = sum over all rows of g; sum_gc = sum of
    g * (x - mean) (mean = 0 when None). With `mean` and `rstd` (train mode,
    inv = rstd * scale) dx runs through the statistics of the rows
    `row_mask` marks: dx = inv g - m_n (inv sum_g / M + (x - mean) inv rstd^2
    sum_gc / M); without them (fixed statistics) dx = inv g. dx in x's dtype,
    channels_last; sum_g and sum_gc f32 [C] (f64 sums; all f64 for f64 x).
    Returns (dx, sum_g, sum_gc, dscale): dscale = sum_gc * rstd, the scale's
    gradient in train mode, in the f32 (f64) operation the norm's backward
    ran; sum_gc itself (d inv) with fixed statistics."""
    train = mean is not None
    N, C, H, W = x.shape
    f, g, xc = _bwd_g_plain(x, dy, inv, shift, mean)
    sum_g, sum_gc = _bwd_sums_plain(g, xc)
    if train:
        M = _masked_count(row_mask, N, H * W, x.device)
        dx = _bwd_dx_plain(x, g, xc, inv, rstd, row_mask, sum_g, sum_gc, M, f)
    else:
        dx = (inv[None, :, None, None] * g).to(x.dtype).contiguous(memory_format=_CL)
    sum_g, sum_gc = sum_g.to(f), sum_gc.to(f)
    return dx, sum_g, sum_gc, sum_gc * rstd if train else sum_gc


def norm_relu_bwd_sums_plain(x, dy, inv, shift, mean, rstd, row_mask=None):
    """Plain K17 sums mode (train mode): (sums, sum_g, sum_gc, dscale) with
    sums this rank's f64 [2C + 1] (sum g, sum g * xc per channel, then the
    count of values of the rows `row_mask` marks, as K16's) and the other
    three `norm_relu_bwd_plain`'s, over this rank's rows."""
    N, C, H, W = x.shape
    f, g, xc = _bwd_g_plain(x, dy, inv, shift, mean)
    s1, s2 = _bwd_sums_plain(g, xc)
    if row_mask is None:
        count = torch.tensor(float(N * H * W), dtype=torch.float64, device=x.device)
    else:
        count = (row_mask != 0).to(torch.float64).sum() * (H * W)
    sum_gc = s2.to(f)
    return _pack_sums(s1, s2, count), s1.to(f), sum_gc, sum_gc * rstd


def norm_relu_bwd_dx_plain(x, dy, inv, shift, mean, rstd, row_mask, sums):
    """Plain K17 dx mode: `norm_relu_bwd_plain`'s train-mode dx through the
    all-reduced sums (`norm_relu_bwd_sums_plain`'s layout summed over the
    ranks), M = max(the summed count, 1)."""
    f, g, xc = _bwd_g_plain(x, dy, inv, shift, mean)
    s1, s2, M = _unpack_sums(sums)
    return _bwd_dx_plain(x, g, xc, inv, rstd, row_mask, s1, s2, M, f)


_NORM_RELU_BWD_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong]
                                 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                                 + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
_NORM_RELU_BWD_FUSED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                                           ctypes.c_int]
                                 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p] * 2)


def _norm_relu_bwd_cuda(x, dy, inv, shift, mean=None, rstd=None, row_mask=None,
                        design: str = "fused", cycles: torch.Tensor | None = None):
    """K17 in either design (see `norm_relu_bwd_plain`); `cycles`: int64
    zeros [rows, len(BN_BWD_PHASES)] (rows: the fused plan's grid, or the
    split design's partial rows)."""
    _check_nhwc("K17 norm_relu_bwd", x, dy)
    N, C, H, W = x.shape
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("K17 norm_relu_bwd: dy must match x's shape and dtype")
    if design not in DESIGNS:
        raise ValueError(f"K17 norm_relu_bwd: unknown design {design!r}")
    train = mean is not None
    mask = _row_mask_u8(row_mask, N, dev) if train else None
    vs = _check_vectors("K17 norm_relu_bwd", dev, C, inv, shift, *((mean, rstd) if train else ()))
    dx = torch.empty_like(x, memory_format=_CL)
    it = x.element_size()
    vec = _vectorizable(C, it, x, dy, dx)
    out = torch.empty((3, C), dtype=torch.float32, device=dev)
    p = _build.ptr
    st = _build.stream(dev.index)
    cyc = None if cycles is None else p(cycles)
    if design == "split":
        n_part = plan_split(N, H * W, C, it, vec)
        part = torch.empty((n_part, C, 2), dtype=torch.float64, device=dev)
        coef = torch.empty(C * 3, dtype=torch.float32, device=dev)
        zeros = None if train else torch.zeros(C, dtype=torch.float32, device=dev)
        fn = _build.entry("bn_train", _NORM_RELU_BWD_SPLIT_ARGTYPES, "suo_norm_relu_bwd")
        err = fn(p(x), p(dy), None if mask is None else p(mask), p(vs[0]), p(vs[1]),
                 p(vs[2]) if train else p(zeros), p(vs[3]) if train else p(vs[0]), N, H * W, C,
                 int(train), p(part), n_part, p(out[0]), p(out[1]), p(coef), p(dx),
                 _DTYPES[x.dtype], cyc, st)
        _build.check(err, "K17 norm_relu_bwd (split design)")
        kcount.count("norm_relu_bwd")
        return dx, out[0], out[1], out[1] * vs[3] if train else out[1]
    plan = plan_bn("bwd", N, H * W, C, it, vec, _multiprocessors(dev))
    bar, part, coef = _bn_workspace(dev, st, plan.part, 3 * C)
    fn = _build.entry("bn_train", _NORM_RELU_BWD_FUSED_ARGTYPES, "suo_norm_relu_bwd_fused")
    err = fn(p(x), p(dy), None if mask is None else p(mask), p(vs[0]), p(vs[1]),
             p(vs[2]) if train else None, p(vs[3]) if train else None, N, H * W, C,
             p(part), p(bar), p(coef), p(out[0]), p(out[1]), p(out[2]), p(dx),
             _DTYPES[x.dtype], int(vec), plan.grid, plan.smem, cyc, st)
    _build.check(err, "K17 norm_relu_bwd")
    kcount.count("norm_relu_bwd")
    return dx, out[0], out[1], out[2] if train else out[1]


def norm_relu_bwd(x, dy, inv, shift, mean=None, rstd=None, row_mask=None):
    """The backward of the norm + ReLU (see `norm_relu_bwd_plain`): one
    launch of K17 on CUDA tensors, the plain version on CPU tensors. dy is
    made channels_last."""
    dy = dy.contiguous(memory_format=_CL)
    if x.device.type == "cpu":
        _check_nhwc("norm_relu_bwd", x, dy, plain=True)
        return norm_relu_bwd_plain(x, dy, inv, shift, mean, rstd, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"norm_relu_bwd: unsupported device {x.device}")
    return _norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, row_mask)


# K16 / K17 across ranks ------------------------------------------------------------
# Data parallelism (`parallel/`, `train/harness.make_sharded_train_step`) runs
# one process a card; the masked train-mode norm's statistics and their
# gradient's two sums are the global batch's. Inside `cross_rank(group)`
# every `MaskedBatchNorm(train=True)` runs K16 as partial sums, an
# all-reduce over `group` and a finalize, and its backward K17 as sums, an
# all-reduce and a dx pass: one collective each way, a norm. Outside it the
# one-launch fused paths run, as on one card.
_cross = threading.local()


class cross_rank:
    """Context: the train-mode norms entered inside it take their statistics
    across the ranks of `group` (a `torch.distributed` process group; their
    backward keeps it, wherever autograd runs it)."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        self._prev = getattr(_cross, "group", None)
        _cross.group = self.group
        return self

    def __exit__(self, *exc):
        _cross.group = self._prev
        return False


def cross_rank_group():
    """The process group of the innermost `cross_rank`, or None."""
    return getattr(_cross, "group", None)


_BN_PARTIAL_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BN_FINALIZE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 8)
_BWD_SUMS_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                      + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_DX_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                    + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _bn_stats_partial_cuda(x, row_mask=None):
    """K16's partial mode: this rank's f64 [2C + 1] sums (see
    `bn_stats_partial_plain`), one cooperative launch on the fused plan."""
    _check_nhwc("K16 bn_stats (partial)", x)
    N, C, H, W = x.shape
    dev = x.device
    mask = _row_mask_u8(row_mask, N, dev)
    it = x.element_size()
    plan = plan_bn("stats", N, H * W, C, it, _vectorizable(C, it, x), _multiprocessors(dev))
    st = _build.stream(dev.index)
    bar, part, _ = _bn_workspace(dev, st, plan.part, 0)
    sums = torch.empty(2 * C + 1, dtype=torch.float64, device=dev)
    p = _build.ptr
    fn = _build.entry("bn_train", _BN_PARTIAL_ARGTYPES, "suo_bn_stats_partial")
    err = fn(p(x), None if mask is None else p(mask), N, H * W, C, p(part), p(bar), p(sums),
             _DTYPES[x.dtype], int(plan.V > 1), plan.grid, plan.smem, st)
    _build.check(err, "K16 bn_stats (partial)")
    kcount.count("bn_stats_partial")
    return sums


def _bn_stats_finalize_cuda(sums, scale, bias, eps, run_mean=None, run_var=None, momentum=0.9):
    """K16's finalize mode: (mean, var, rstd, inv, shift) f32 [C] from the
    all-reduced sums, the running averages updated in place."""
    dev = sums.device
    C = (sums.numel() - 1) // 2
    if sums.dtype != torch.float64 or sums.shape != (2 * C + 1,) or not sums.is_contiguous():
        raise ValueError("K16 bn_stats (finalize): sums must be contiguous f64 [2C + 1]")
    vs = _check_vectors("K16 bn_stats (finalize)", dev, C, scale, bias,
                        *(() if run_mean is None else (run_mean, run_var)))
    if run_mean is not None and (vs[2].data_ptr() != run_mean.data_ptr()
                                 or vs[3].data_ptr() != run_var.data_ptr()):
        raise ValueError("K16 bn_stats (finalize): the running averages must be contiguous")
    out = torch.empty((5, C), dtype=torch.float32, device=dev)
    p = _build.ptr
    fn = _build.entry("bn_train", _BN_FINALIZE_ARGTYPES, "suo_bn_stats_finalize")
    err = fn(p(sums), C, p(vs[0]), p(vs[1]), eps, momentum, 1 - momentum,
             None if run_mean is None else p(run_mean), None if run_var is None else p(run_var),
             *(p(out[i]) for i in range(5)), _build.stream(dev.index))
    _build.check(err, "K16 bn_stats (finalize)")
    kcount.count("bn_stats_finalize")
    if run_mean is not None:
        _bump(run_mean, run_var)
    return tuple(out)


def _norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, row_mask=None):
    """K17's sums mode (train mode): (sums f64 [2C + 1], sum_g, sum_gc,
    dscale), one cooperative launch on the fused plan (see
    `norm_relu_bwd_sums_plain`)."""
    _check_nhwc("K17 norm_relu_bwd (sums)", x, dy)
    N, C, H, W = x.shape
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("K17 norm_relu_bwd (sums): dy must match x's shape and dtype")
    mask = _row_mask_u8(row_mask, N, dev)
    vs = _check_vectors("K17 norm_relu_bwd (sums)", dev, C, inv, shift, mean, rstd)
    it = x.element_size()
    plan = plan_bn("bwd", N, H * W, C, it, _vectorizable(C, it, x, dy), _multiprocessors(dev))
    st = _build.stream(dev.index)
    bar, part, _ = _bn_workspace(dev, st, plan.part, 0)
    sums = torch.empty(2 * C + 1, dtype=torch.float64, device=dev)
    out = torch.empty((3, C), dtype=torch.float32, device=dev)
    p = _build.ptr
    fn = _build.entry("bn_train", _BWD_SUMS_ARGTYPES, "suo_norm_relu_bwd_sums")
    err = fn(p(x), p(dy), None if mask is None else p(mask), *(p(v) for v in vs), N, H * W, C,
             p(part), p(bar), p(sums), p(out[0]), p(out[1]), p(out[2]), _DTYPES[x.dtype],
             int(plan.V > 1), plan.grid, plan.smem, st)
    _build.check(err, "K17 norm_relu_bwd (sums)")
    kcount.count("norm_relu_bwd_sums")
    return sums, out[0], out[1], out[2]


def _norm_relu_bwd_dx_cuda(x, dy, inv, shift, mean, rstd, row_mask, sums):
    """K17's dx mode: train-mode dx from the all-reduced sums, on the fused
    plan's grid (see `norm_relu_bwd_dx_plain`)."""
    _check_nhwc("K17 norm_relu_bwd (dx)", x, dy)
    N, C, H, W = x.shape
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("K17 norm_relu_bwd (dx): dy must match x's shape and dtype")
    if sums.dtype != torch.float64 or sums.shape != (2 * C + 1,) or sums.device != dev:
        raise ValueError(f"K17 norm_relu_bwd (dx): sums must be f64 [{2 * C + 1}] on x's device")
    mask = _row_mask_u8(row_mask, N, dev)
    vs = _check_vectors("K17 norm_relu_bwd (dx)", dev, C, inv, shift, mean, rstd)
    dx = torch.empty_like(x, memory_format=_CL)
    it = x.element_size()
    plan = plan_bn("bwd", N, H * W, C, it, _vectorizable(C, it, x, dy, dx),
                   _multiprocessors(dev))
    p = _build.ptr
    fn = _build.entry("bn_train", _BWD_DX_ARGTYPES, "suo_norm_relu_bwd_dx")
    err = fn(p(x), p(dy), None if mask is None else p(mask), *(p(v) for v in vs),
             p(sums.contiguous()), N, H * W, C, p(dx), _DTYPES[x.dtype], int(plan.V > 1),
             plan.grid, plan.smem, _build.stream(dev.index))
    _build.check(err, "K17 norm_relu_bwd (dx)")
    kcount.count("norm_relu_bwd_dx")
    return dx


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); raises on another device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def bn_stats_partial(x, row_mask=None):
    """K16's partial mode on CUDA tensors, its plain version on CPU ones."""
    if _on(x, "bn_stats_partial"):
        return _bn_stats_partial_cuda(x, row_mask)
    _check_nhwc("bn_stats_partial", x, plain=True)
    return bn_stats_partial_plain(x, row_mask)


def bn_stats_finalize(sums, scale, bias, eps, run_mean=None, run_var=None, momentum=0.9,
                      dtype=torch.float32):
    """K16's finalize mode on CUDA tensors, its plain version on CPU ones."""
    if _on(sums, "bn_stats_finalize"):
        return _bn_stats_finalize_cuda(sums, scale, bias, eps, run_mean, run_var, momentum)
    return bn_stats_finalize_plain(sums, scale, bias, eps, run_mean, run_var, momentum, dtype)


def norm_relu_bwd_sums(x, dy, inv, shift, mean, rstd, row_mask=None):
    """K17's sums mode on CUDA tensors, its plain version on CPU ones."""
    if _on(x, "norm_relu_bwd_sums"):
        return _norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, row_mask)
    _check_nhwc("norm_relu_bwd_sums", x, dy, plain=True)
    return norm_relu_bwd_sums_plain(x, dy, inv, shift, mean, rstd, row_mask)


def norm_relu_bwd_dx(x, dy, inv, shift, mean, rstd, row_mask, sums):
    """K17's dx mode on CUDA tensors, its plain version on CPU ones."""
    if _on(x, "norm_relu_bwd_dx"):
        return _norm_relu_bwd_dx_cuda(x, dy, inv, shift, mean, rstd, row_mask, sums)
    _check_nhwc("norm_relu_bwd_dx", x, dy, plain=True)
    return norm_relu_bwd_dx_plain(x, dy, inv, shift, mean, rstd, row_mask, sums)


def bn_train_stats_cross(x, row_mask, scale, bias, eps, run_mean=None, run_var=None,
                         momentum=0.9, group=None):
    """`bn_train_stats` over the global batch of `group`'s ranks: K16's
    partial sums of this rank's real rows, one all-reduce (SUM) of them and
    their counts, K16's finalize (the plain versions on CPU tensors). Every
    rank gets the same statistics and running averages."""
    sums = bn_stats_partial(x, row_mask)
    _mesh.all_reduce_sum(sums, group)
    return bn_stats_finalize(sums, scale, bias, eps, run_mean, run_var, momentum,
                             kcount.plain_dtype(x.dtype))


def norm_relu_bwd_cross(x, dy, inv, shift, mean, rstd, row_mask=None, group=None):
    """The train-mode `norm_relu_bwd` through the global batch's sums: K17's
    sums, one all-reduce of them, K17's dx pass. Returns (dx, sum_g, sum_gc,
    dscale) with the last three this rank's (the parameters' gradients,
    which the step sums over the ranks)."""
    dy = dy.contiguous(memory_format=_CL)
    sums, sum_g, sum_gc, dscale = norm_relu_bwd_sums(x, dy, inv, shift, mean, rstd, row_mask)
    _mesh.all_reduce_sum(sums, group)
    return norm_relu_bwd_dx(x, dy, inv, shift, mean, rstd, row_mask, sums), sum_g, sum_gc, dscale


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
        dx, sum_g, sum_gx, _ = norm_relu_bwd(x, dy, inv, shift)
        return dx, sum_gx, sum_g


class _NormReluTrain(torch.autograd.Function):
    """Train-mode norm + ReLU on K16's statistics and affine (computed
    before the call, `MaskedBatchNorm.forward`): K8 applies inv and shift;
    backward K17 through the statistics, which also gives the scale's
    gradient (dscale) and the bias's (sum_g)."""

    @staticmethod
    def forward(ctx, x, scale, bias, inv, shift, mean, rstd, row_mask, group=None):
        ctx.save_for_backward(x, inv, shift, mean, rstd,
                              row_mask if row_mask is not None else torch.empty(0))
        ctx.has_mask = row_mask is not None
        ctx.group = group
        return _norm_relu_fwd(x, inv, shift)

    @staticmethod
    def backward(ctx, dy):
        x, inv, shift, mean, rstd, row_mask = ctx.saved_tensors
        m = row_mask if ctx.has_mask else None
        if ctx.group is not None:
            dx, sum_g, _, dscale = norm_relu_bwd_cross(x, dy, inv, shift, mean, rstd, m,
                                                       ctx.group)
        else:
            dx, sum_g, _, dscale = norm_relu_bwd(x, dy, inv, shift, mean, rstd, m)
        return dx, dscale, sum_g, None, None, None, None, None, None


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


# K18's routes (`csrc/upsample_add.cu`): a thread per 16-byte vector of
# channels, or per value
K18_VECTOR, K18_SCALAR = "vector", "scalar"


def plan_upsample_bwd(shape, itemsize: int, *ptrs: int) -> str:
    """K18's route for a dy of NCHW `shape` and `itemsize` bytes a value,
    given the data pointers of dy and d_low: the vector route where C is a
    multiple of a 16-byte vector and every pointer is 16-byte aligned, else
    the scalar route. Raises on what the kernel refuses: odd H or W, a dy
    row pair of 2^31 values or more (its offsets are 32-bit)."""
    N, C, H, W = shape
    if H % 2 or W % 2:
        raise ValueError(f"K18 upsample_add_bwd: odd size {tuple(shape)}")
    if 2 * W * C >= 2 ** 31 or N * (H // 2) >= 2 ** 31:
        raise ValueError(f"K18 upsample_add_bwd: {tuple(shape)} exceeds 32-bit row offsets")
    if C % (16 // itemsize) == 0 and all(q % 16 == 0 for q in ptrs):
        return K18_VECTOR
    return K18_SCALAR


_UPSAMPLE_ADD_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _upsample_add_bwd_cuda(dy: torch.Tensor) -> torch.Tensor:
    """K18 on the route `plan_upsample_bwd` picks."""
    _check_nhwc("K18 upsample_add_bwd", dy)
    N, C, H, W = dy.shape
    dlow = torch.empty((N, C, H // 2, W // 2), dtype=dy.dtype, device=dy.device,
                       memory_format=_CL)
    route = plan_upsample_bwd(tuple(dy.shape), dy.element_size(), dy.data_ptr(),
                              dlow.data_ptr())
    fn = _build.entry("upsample_add", _UPSAMPLE_ADD_BWD_ARGTYPES, "suo_upsample_add_bwd")
    err = fn(_build.ptr(dy), _build.ptr(dlow), N, H, W, C, _DTYPES[dy.dtype],
             int(route == K18_VECTOR), _build.stream())
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


# K20 ---------------------------------------------------------------------------
GN_EPS = 1e-6  # flax GroupNorm's epsilon


def num_groups(channels: int, groups: int = 32) -> int:
    """The JAX `Norm(kind="group")`'s group count: min(groups, C), lowered
    until it divides C."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def _group_c(t: torch.Tensor, cpg: int) -> torch.Tensor:
    """[N, G] per-group values -> [N, C, 1, 1] per channel."""
    return t.repeat_interleave(cpg, dim=1)[:, :, None, None]


def group_norm_relu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                          eps: float = GN_EPS):
    """Plain K20: (y, mean, rstd). Per sample and group of C / groups
    channels, f64 sums of x and x^2 give mean = sum / M and var = max(sum2
    / M - mean^2, 0), rstd = 1 / sqrt(var + eps), rounded once to f32 [N, G]
    (f64 for f64 x); y = relu(cast((x - mean) * (rstd * scale[c]) +
    bias[c])) with each operation in f32, flax GroupNorm's order, channels_last."""
    N, C, H, W = x.shape
    cpg = C // groups
    f = kcount.plain_dtype(x.dtype)
    xd = x.to(torch.float64).reshape(N, groups, cpg * H * W)
    M = cpg * H * W
    mean = xd.sum(2) / M
    var = torch.clamp((xd * xd).sum(2) / M - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mean, rstd = mean.to(f), rstd.to(f)
    mul = _group_c(rstd, cpg) * scale.to(f)[None, :, None, None]
    z = (x.to(f) - _group_c(mean, cpg)) * mul + bias.to(f)[None, :, None, None]
    y = torch.relu(z.to(x.dtype)).contiguous(memory_format=_CL)
    return y, mean, rstd


# K20 / K21: plans, workspace -------------------------------------------------
# `csrc/group_norm.cu`'s constants of the cluster design
# (tests/test_torch_gn_plan.py reads them from the source)
GN_THREADS = 256         # threads of a CTA
GN_MAX_CLUSTER = 16      # CTAs of a sample's cluster
GN_MAX_TEAMS = 8         # samples of a CTA (k = 1)
GN_TAIL_UNROLL = 4       # tail pixels a thread loads together
GN_KEEP_BATCH = 4        # kept pixels in one cp.async group of a thread
GN_SMEM_BUDGET = 231424  # dynamic shared memory of a CTA
GN_MIN_SLICE = 32768     # bytes a slice keeps when k grows to fill the card
# the phases whose SM clock cycles `cycles=` takes (a row per CTA)
GN_FWD_PHASES = ("load", "math", "fold", "cluster", "apply")
GN_BWD_PHASES = ("load", "math", "fold", "cluster", "dx", "final")


class GnPlan(NamedTuple):
    """A cluster-design K20 / K21 call's plan (`group_norm.cu` `GGeom`,
    `g_layout`): V channels a thread's vector, k CTAs a sample's cluster,
    spp samples a CTA (teams of GN_THREADS / spp threads, k = 1), cv
    channel-vector lanes x lanes_p pixel lanes a team, q pixel lanes a warp
    folds by shuffles, `rows` rows of the cross-warp fold, `iters` pixels of
    a sample for the busiest thread, `keep` of them kept in shared memory,
    `slots` pixels in the thread's ring there (more than `keep` where the
    next sample's copies can start early), `blocks` blocks of spp samples
    (the grid is (k, CTA rows), rows taking blocks in turn), `smem` bytes of
    dynamic shared memory."""
    V: int
    k: int
    spp: int
    cv: int
    lanes_p: int
    q: int
    rows: int
    iters: int
    keep: int
    slots: int
    blocks: int
    smem: int


def gn_geom(C: int, V: int, spp: int) -> tuple:
    """`group_norm.cu` `GGeom`: (cv, a team's threads, lanes_p, q, rows)."""
    cv = C // V
    tt = GN_THREADS // spp
    lanes_p = tt // cv
    q = 32 // cv if cv <= 32 and 32 % cv == 0 else 1
    return cv, tt, lanes_p, q, (tt // 32 if q > 1 else lanes_p)


def gn_smem(spp: int, rows: int, lanes_p: int, C: int, G: int, itemsize: int, slots: int,
            bwd: bool) -> int:
    """`group_norm.cu` `g_layout`'s total: the fold rows (at least
    GN_THREADS f64 pairs), the per-channel rows and group partials (f64
    pairs a team, two sets), the ring slots of x (and dy), the group
    statistics (f32 pairs a team)."""
    kept = spp * slots * lanes_p * C * itemsize
    return (16 * max(spp * rows * C, GN_THREADS) + 32 * spp * C + 32 * spp * G
            + kept * (2 if bwd else 1) + 8 * spp * G)


@functools.lru_cache(maxsize=512)
def plan_gn(kind: str, N: int, HW: int, C: int, itemsize: int, vec: bool, n_sm: int,
            max_cluster: int, groups: int | None = None) -> GnPlan | None:
    """The cluster design's plan of a K20 (`kind="fwd"`) or K21 (`"bwd"`)
    call on [N, HW, C] values of `itemsize` bytes in `groups` groups
    (`num_groups(C)` by default), 16-byte vectors when `vec`, on a card of
    `n_sm` multiprocessors that co-schedules clusters of up to
    `max_cluster` CTAs; None where a pixel holds more channel vectors than
    a CTA has threads (the split design's shapes). k, a power of two,
    doubles while a sample's slice
    (x, and K21's dy) does not fit a CTA's shared memory, then while the k N
    CTAs do not fill the card and a slice would keep GN_MIN_SLICE bytes.
    With k = 1, samples share a CTA (spp doubles, up to GN_MAX_TEAMS) while a
    team still covers its sample with at most two pixels a thread. Where a
    slice does not fit, each thread keeps its first `keep` pixels on chip
    and reads the rest again; where it fits and the blocks outnumber what
    one wave of CTAs holds, the ring takes up to twice a slice, so the
    next block's copies start while the current one is reduced."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"plan_gn: unknown kind {kind!r}")
    G = num_groups(C) if groups is None else groups
    bwd = kind == "bwd"
    V = 16 // itemsize if vec else 1
    cv = C // V
    if C % V:
        raise ValueError(f"K20 / K21: {C} channels are no whole number of {V}-vectors")
    if cv > GN_THREADS:
        return None
    px = C * itemsize * (2 if bwd else 1)  # bytes a pixel keeps
    cap = 1
    while cap * 2 <= min(max_cluster, GN_MAX_CLUSTER):
        cap *= 2

    def fit(k, spp):  # (iters, keep, slots, smem) of a layout
        _, _, lanes_p, _, rows = gn_geom(C, V, spp)
        iters = -(-(-(-HW // k)) // lanes_p)
        fixed = gn_smem(spp, rows, lanes_p, C, G, itemsize, 0, bwd)
        room = max(0, (GN_SMEM_BUDGET - fixed) // (spp * lanes_p * px)) if vec else 0
        keep = min(iters, room)
        slots = min(room, 2 * iters) if keep == iters and -(-N // spp) * k > n_sm else keep
        return iters, keep, slots, gn_smem(spp, rows, lanes_p, C, G, itemsize, slots, bwd)

    k = 1
    while k < cap:
        iters, keep, _, _ = fit(k, 1)
        if (keep < iters and vec) or (N * k < n_sm and -(-HW // (2 * k)) * px >= GN_MIN_SLICE):
            k *= 2
        else:
            break
    spp = 1
    while k == 1 and 2 * spp <= min(GN_MAX_TEAMS, N):
        tt = GN_THREADS // (2 * spp)
        if tt < max(32, cv) or HW > 2 * (tt // cv):
            break
        iters, keep, _, _ = fit(1, 2 * spp)
        if keep < iters and vec:
            break
        spp *= 2
    _, _, lanes_p, q, rows = gn_geom(C, V, spp)
    iters, keep, slots, smem = fit(k, spp)
    if smem > GN_SMEM_BUDGET:
        raise ValueError(f"K20 / K21: {C} channels need {smem} bytes of shared memory, more "
                         f"than a CTA's {GN_SMEM_BUDGET}")
    return GnPlan(V, k, spp, cv, lanes_p, q, rows, iters, keep, slots, -(-N // spp), smem)


_gn_caps: dict[int, int] = {}  # device -> the largest cluster it co-schedules


def _gn_cluster_cap(dev: torch.device) -> int:
    """The largest cluster of the cluster design's CTAs this card
    co-schedules (`suo_group_norm_max_cluster`: at the whole shared-memory
    budget), at most GN_MAX_CLUSTER; asked once per device."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = _gn_caps.get(i)
    if cap is None:
        fn = _build.entry("group_norm", [ctypes.POINTER(ctypes.c_int)],
                          "suo_group_norm_max_cluster")
        out = ctypes.c_int(0)
        with torch.cuda.device(i):
            _build.check(fn(ctypes.byref(out)), "K20 / K21 group_norm (cluster size)")
        if out.value < 1:
            raise RuntimeError("K20 / K21: this card co-schedules no cluster of their CTAs")
        cap = _gn_caps[i] = min(GN_MAX_CLUSTER, out.value)
    return cap


_gn_active: dict[tuple, int] = {}  # (device, kind, dtype, vec, k, smem) -> clusters at once


def _gn_rows(dev: torch.device, kind: str, dtype: int, plan: GnPlan) -> int:
    """The CTA rows a cluster-design launch takes: the clusters of its plan
    the card runs at once (`suo_group_norm_active_clusters`, asked once per
    device and plan), at most its blocks."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (i, kind, dtype, plan.V > 1, plan.k, plan.smem)
    n = _gn_active.get(key)
    if n is None:
        fn = _build.entry("group_norm", [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)],
                          "suo_group_norm_active_clusters")
        out = ctypes.c_int(0)
        with torch.cuda.device(i):
            _build.check(fn(plan.k, plan.smem, int(kind == "bwd"), dtype, int(plan.V > 1),
                            ctypes.byref(out)), "K20 / K21 group_norm (clusters at once)")
        if out.value < 1:
            raise RuntimeError(f"K20 / K21: the card runs no cluster of {plan.k} CTAs of "
                               f"{plan.smem} bytes")
        n = _gn_active[key] = out.value
    return min(n, plan.blocks)


_gn_work: dict[tuple, tuple] = {}


def _gn_workspace(dev: torch.device, stream: int, n_rows: int):
    """K21's cluster-design scratch on `stream`: (uint32 [GN_MAX_CLUSTER]
    arrival counters at zero, f64 [>= n_rows] rows). Every launch leaves the
    counters at zero, so one set serves every call on the stream (and a
    captured graph); the rows grow by fresh allocations."""
    key = (dev.index, stream)
    w = _gn_work.get(key)
    if w is None or w[1].numel() < n_rows:
        with _bn_work_lock:
            w = _gn_work.get(key)
            if w is None or w[1].numel() < n_rows:
                w = (torch.zeros(GN_MAX_CLUSTER, dtype=torch.int32, device=dev)
                     if w is None else w[0],
                     torch.empty(max(n_rows, 0 if w is None else w[1].numel()),
                                 dtype=torch.float64, device=dev))
                _gn_work[key] = w
    return w


def _gn_plan(kind: str, x: torch.Tensor, groups: int, *ts: torch.Tensor) -> GnPlan | None:
    """The cluster design's plan of a call on x (vectors where x and ts
    allow; the outputs, fresh allocations, are aligned), None for the split
    design."""
    N, C, H, W = x.shape
    it = x.element_size()
    dev = x.device
    return plan_gn(kind, N, H * W, C, it, _vectorizable(C, it, x, *ts), _multiprocessors(dev),
                   _gn_cluster_cap(dev), groups)


_GN_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_double]
                      + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
_GN_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_double]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)


def _gn_vectors(name: str, x: torch.Tensor, *vs: torch.Tensor) -> list:
    C = x.shape[1]
    vs = [v.contiguous() for v in vs]
    if any(v.dtype != torch.float32 or v.device != x.device for v in vs):
        raise ValueError(f"{name}: scale, bias, mean and rstd must be f32 on x's device")
    if any(v.shape != (C,) for v in vs[:2]):
        raise ValueError(f"{name}: scale and bias must be [{C}]")
    return vs


def _gn_fwd_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int):
    name = "K20 group_norm_relu"
    _check_nhwc(name, x)
    if x.shape[1] % groups:
        raise ValueError(f"{name}: {groups} groups do not divide {x.shape[1]} channels")
    return _gn_vectors(name, x, scale, bias)


def _group_norm_relu_split(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           groups: int, eps: float = GN_EPS):
    """K20's split design (see `group_norm_relu_plain`): a partial pass, the
    statistics and the apply pass, three launches; `_group_norm_relu_cuda`'s
    route where `plan_gn` gives no plan."""
    scale, bias = _gn_fwd_args(x, scale, bias, groups)
    N, C, H, W = x.shape
    y = torch.empty_like(x, memory_format=_CL)
    stats = torch.empty((2, N, groups), dtype=torch.float32, device=x.device)  # mean, rstd
    it = x.element_size()
    spans = plan_split(1, H * W, C, it, _vectorizable(C, it, x, y))
    part = torch.empty((N, spans, C, 2), dtype=torch.float64, device=x.device)
    p = _build.ptr
    fn = _build.entry("group_norm", _GN_SPLIT_ARGTYPES, "suo_group_norm_relu")
    err = fn(p(x), p(scale), p(bias), N, H * W, C, groups, eps, p(part), p(stats[0]),
             p(stats[1]), p(y), _DTYPES[x.dtype], _build.stream())
    _build.check(err, "K20 group_norm_relu (split design)")
    kcount.count("group_norm_relu")
    return y, stats[0], stats[1]


def _group_norm_relu_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                          eps: float = GN_EPS, cycles: torch.Tensor | None = None):
    """K20 (see `group_norm_relu_plain`): one launch of the cluster design
    where `plan_gn` gives a plan, else the split design; `cycles`: int64
    zeros [k * rows, len(GN_FWD_PHASES)] that take the cluster design's SM
    clock cycles per phase (a row per CTA launched, `_gn_rows`)."""
    scale, bias = _gn_fwd_args(x, scale, bias, groups)
    plan = _gn_plan("fwd", x, groups)
    if plan is None:
        if cycles is not None:
            raise ValueError("K20 group_norm_relu: the split design takes no cycles")
        return _group_norm_relu_split(x, scale, bias, groups, eps)
    N, C, H, W = x.shape
    y = torch.empty_like(x, memory_format=_CL)
    stats = torch.empty((2, N, groups), dtype=torch.float32, device=x.device)  # mean, rstd
    p = _build.ptr
    rows = _gn_rows(x.device, "fwd", _DTYPES[x.dtype], plan)
    fn = _build.entry("group_norm", _GN_CLUSTER_ARGTYPES, "suo_group_norm_relu_cluster")
    err = fn(p(x), p(scale), p(bias), N, H * W, C, groups, eps, p(stats[0]), p(stats[1]),
             p(y), _DTYPES[x.dtype], int(plan.V > 1), plan.k, plan.spp, plan.keep, plan.slots,
             rows, plan.smem, None if cycles is None else p(cycles), _build.stream())
    _build.check(err, "K20 group_norm_relu")
    kcount.count("group_norm_relu")
    return y, stats[0], stats[1]


def group_norm_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
                    eps: float = GN_EPS):
    """GroupNorm + ReLU with its statistics (see `group_norm_relu_plain`):
    K20 on CUDA tensors (one launch of the cluster design at every shape of
    the net), the plain version on CPU tensors. x must be channels_last."""
    if x.device.type == "cpu":
        _check_nhwc("group_norm_relu", x, plain=True)
        return group_norm_relu_plain(x, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_relu: unsupported device {x.device}")
    return _group_norm_relu_cuda(x, scale, bias, groups, eps)


# K21 ---------------------------------------------------------------------------
def group_norm_relu_bwd_plain(x, dy, scale, bias, mean, rstd):
    """Plain K21: (dx, dscale, dbias) of y = relu(cast((x - mean) * mul +
    bias)), mul = rstd * scale, through the statistics. With g = dy * [y >
    0], xc = x - mean and h = scale g in f32 (f64 for f64 x), per sample and
    group (f64 sums over its M values): hbar = sum(h) / M and Q = rstd^3 *
    sum(h xc) / M, dx = rstd (h - hbar) - xc Q cast to x's dtype
    (channels_last; 0 in a group of one value, as autodiff's); dbias =
    sum g, dscale = sum over n of rstd * sum g xc (f64 sums)."""
    N, C, H, W = x.shape
    groups = mean.shape[1]
    cpg = C // groups
    f = kcount.plain_dtype(x.dtype)
    sc = scale.to(f)
    mul = _group_c(rstd, cpg) * sc[None, :, None, None]
    xc = x.to(f) - _group_c(mean, cpg)
    on = (xc * mul + bias.to(f)[None, :, None, None]).to(x.dtype) > 0
    g = torch.where(on, dy.to(f), torch.zeros((), dtype=f, device=x.device))
    s_g = g.to(torch.float64).sum((2, 3))                                   # [N, C]
    s_gc = (g.to(torch.float64) * xc.to(torch.float64)).sum((2, 3))
    r = rstd.to(torch.float64)
    dbias = s_g.sum(0)
    dscale = (s_gc * r.repeat_interleave(cpg, dim=1)).sum(0)
    sd = sc.to(torch.float64)
    A = (s_g * sd).reshape(N, groups, cpg).sum(2)
    B = (s_gc * sd).reshape(N, groups, cpg).sum(2)
    M = cpg * H * W
    hbar, Q = (A / M).to(f), (r * r * r * B / M).to(f)
    h = sc[None, :, None, None] * g
    dx = _group_c(rstd, cpg) * (h - _group_c(hbar, cpg)) - xc * _group_c(Q, cpg)
    return dx.to(x.dtype).contiguous(memory_format=_CL), dscale.to(f), dbias.to(f)


_GN_BWD_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_int]
                          + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])
_GN_BWD_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int]
                            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)


def _gn_bwd_args(x, dy, scale, bias, mean, rstd):
    name = "K21 group_norm_relu_bwd"
    _check_nhwc(name, x, dy)
    N, C = x.shape[:2]
    groups = mean.shape[1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dy must match x's shape and dtype")
    if mean.shape != (N, groups) or rstd.shape != (N, groups) or C % groups:
        raise ValueError(f"{name}: mean and rstd must be [{N}, G], G | {C}")
    return _gn_vectors(name, x, scale, bias, mean, rstd)


def _group_norm_relu_bwd_split(x, dy, scale, bias, mean, rstd):
    """K21's split design (see `group_norm_relu_bwd_plain`): a partial pass,
    per-sample and per-channel sums, the dx pass, four launches;
    `_group_norm_relu_bwd_cuda`'s route where `plan_gn` gives no plan."""
    scale, bias, mean, rstd = _gn_bwd_args(x, dy, scale, bias, mean, rstd)
    N, C, H, W = x.shape
    groups = mean.shape[1]
    dev = x.device
    dx = torch.empty_like(x, memory_format=_CL)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)  # dscale, dbias
    it = x.element_size()
    spans = plan_split(1, H * W, C, it, _vectorizable(C, it, x, dy, dx))
    part = torch.empty((N, spans, C, 2), dtype=torch.float64, device=dev)
    sums = torch.empty((N, C, 2), dtype=torch.float64, device=dev)
    coef = torch.empty((N, groups, 2), dtype=torch.float32, device=dev)
    p = _build.ptr
    fn = _build.entry("group_norm", _GN_BWD_SPLIT_ARGTYPES, "suo_group_norm_relu_bwd")
    err = fn(*(p(t) for t in (x, dy, scale, bias, mean, rstd)), N, H * W, C, groups,
             *(p(t) for t in (part, sums, coef, out[0], out[1], dx)), _DTYPES[x.dtype],
             _build.stream())
    _build.check(err, "K21 group_norm_relu_bwd (split design)")
    kcount.count("group_norm_relu_bwd")
    return dx, out[0], out[1]


def _group_norm_relu_bwd_cuda(x, dy, scale, bias, mean, rstd,
                              cycles: torch.Tensor | None = None):
    """K21 (see `group_norm_relu_bwd_plain`): one launch of the cluster
    design where `plan_gn` gives a plan, else the split design; `cycles`:
    int64 zeros [k * rows, len(GN_BWD_PHASES)] (the cluster design's CTAs)."""
    scale, bias, mean, rstd = _gn_bwd_args(x, dy, scale, bias, mean, rstd)
    groups = mean.shape[1]
    plan = _gn_plan("bwd", x, groups, dy)
    if plan is None:
        if cycles is not None:
            raise ValueError("K21 group_norm_relu_bwd: the split design takes no cycles")
        return _group_norm_relu_bwd_split(x, dy, scale, bias, mean, rstd)
    N, C, H, W = x.shape
    dev = x.device
    dx = torch.empty_like(x, memory_format=_CL)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)  # dscale, dbias
    p = _build.ptr
    st = _build.stream(dev.index)
    count, sums = _gn_workspace(dev, st, plan.blocks * C * 2)
    fn = _build.entry("group_norm", _GN_BWD_CLUSTER_ARGTYPES, "suo_group_norm_relu_bwd_cluster")
    err = fn(*(p(t) for t in (x, dy, scale, bias, mean, rstd)), N, H * W, C, groups,
             *(p(t) for t in (sums, count, out[0], out[1], dx)), _DTYPES[x.dtype],
             int(plan.V > 1), plan.k, plan.spp, plan.keep, plan.slots,
             _gn_rows(dev, "bwd", _DTYPES[x.dtype], plan), plan.smem,
             None if cycles is None else p(cycles), st)
    _build.check(err, "K21 group_norm_relu_bwd")
    kcount.count("group_norm_relu_bwd")
    return dx, out[0], out[1]


def group_norm_relu_bwd(x, dy, scale, bias, mean, rstd):
    """The backward of the GroupNorm + ReLU (see `group_norm_relu_bwd_plain`):
    K21 on CUDA tensors (one launch of the cluster design at every shape of
    the net), the plain version on CPU tensors. dy is made channels_last."""
    dy = dy.contiguous(memory_format=_CL)
    if x.device.type == "cpu":
        _check_nhwc("group_norm_relu_bwd", x, dy, plain=True)
        return group_norm_relu_bwd_plain(x, dy, scale, bias, mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_relu_bwd: unsupported device {x.device}")
    return _group_norm_relu_bwd_cuda(x, dy, scale, bias, mean, rstd)


class _GroupNormRelu(torch.autograd.Function):
    """K20 forward, K21 backward (through the statistics)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        y, mean, rstd = group_norm_relu(x, scale, bias, groups, eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = group_norm_relu_bwd(x, dy, scale, bias, mean, rstd)
        return dx, dscale, dbias, None, None


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
    """`m` applied in x's dtype (see `float_conv`); a convolution of another
    kind (`models/quant.QuantConv`) runs its own forward."""
    if type(m) is not nn.Conv2d:
        return m(x)
    return float_conv(m, x)


def float_conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m`'s convolution in x's dtype: parameters stay f32 and are cast when
    x is bf16 — in the autograd graph while it records the parameters,
    otherwise once per weight update, cached on the module."""
    if x.dtype == m.weight.dtype:
        return F.conv2d(x, m.weight, m.bias, m.stride, m.padding)
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
    they are the batch's over the rows `row_mask` marks (K16, which also
    moves the running averages towards them with momentum 0.9 and computes
    the affine; then K8; backward K17) — inside `cross_rank(group)` the
    global batch's over the ranks (K16 / K17's cross-rank modes)."""

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
        group = cross_rank_group()
        with torch.no_grad():  # K16, with the running averages' update in place
            if group is None:
                mean, _, rstd, inv, shift = bn_train_stats(x, row_mask, self.scale, self.bias,
                                                           self.eps, self.mean, self.var,
                                                           self.MOMENTUM)
            else:
                mean, _, rstd, inv, shift = bn_train_stats_cross(
                    x, row_mask, self.scale, self.bias, self.eps, self.mean, self.var,
                    self.MOMENTUM, group)
        return _NormReluTrain.apply(x, self.scale, self.bias, inv, shift, mean, rstd, row_mask,
                                    group)


class GroupNormRelu(nn.Module):
    """GroupNorm with the ReLU that follows every norm of this net: flax's
    `GroupNorm(num_groups=g, epsilon=1e-6)` on f32(x) with g =
    `num_groups(C)`, cast back, then `nn.relu` (the JAX `Norm(kind="group")`).
    Its statistics are each sample's, in train mode and at inference alike,
    so `train` and `row_mask` change nothing (they are taken for
    `MaskedBatchNorm`'s signature). K20 on the card; backward K21."""

    def __init__(self, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.eps = eps
        self.groups = num_groups(channels)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
        if kcount.autograd_records(x, self.scale, self.bias):
            return _GroupNormRelu.apply(x, self.scale, self.bias, self.groups, self.eps)
        return group_norm_relu(x, self.scale, self.bias, self.groups, self.eps)[0]


NORMS = {"batch": MaskedBatchNorm, "group": GroupNormRelu}


def norm_cls(norm: str):
    """The module class of a `norm` kind."""
    if norm not in NORMS:
        raise ValueError(f"unknown norm kind {norm!r}")
    return NORMS[norm]


class Residual(nn.Module):
    """Pre-activation bottleneck: norm-relu -> 1x1 (c/2) -> norm-relu ->
    3x3 (c/2) -> norm-relu -> 1x1 (c), with a 1x1 projection skip when the
    channel counts differ."""

    def __init__(self, in_features: int, features: int, norm: str = "batch",
                 conv_cls=nn.Conv2d):
        super().__init__()
        mid = features // 2
        nc = norm_cls(norm)
        self.norm0 = nc(in_features)
        self.conv0 = conv_cls(in_features, mid, 1)
        self.norm1 = nc(mid)
        self.conv1 = conv_cls(mid, mid, 3, padding=1)
        self.norm2 = nc(mid)
        self.conv2 = conv_cls(mid, features, 1)
        self.skip = (conv_cls(in_features, features, 1)
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

    def __init__(self, n: int, n_modules: int, features: int, norm: str = "batch",
                 conv_cls=nn.Conv2d):
        super().__init__()
        res = lambda: nn.ModuleList(
            Residual(features, features, norm, conv_cls) for _ in range(n_modules)
        )
        self.up1 = res()
        self.low1 = res()
        self.low2 = (Hourglass(n - 1, n_modules, features, norm, conv_cls) if n > 1
                     else res())
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
    package's output on an all-zero prior, with the matmul skipped (the
    quantized projection too: zero codes give a zero sum).
    `norm` ("batch" or "group") and `conv_cls` (the class of every
    convolution but the f32 heads) follow the JAX `HourglassNet`."""

    def __init__(self, in_features: int = 3 + 41, num_output: int = 41,
                 n_stack: int = 2, n_modules: int = 2, features: int = 256,
                 depth: int = 4, with_extra: bool = False, extra_features: int = 41,
                 dtype: torch.dtype = torch.float32, norm: str = "batch",
                 conv_cls=nn.Conv2d):
        super().__init__()
        if dtype not in _DTYPES and dtype != torch.float64:
            raise ValueError(f"working dtype must be f32 or bf16 (f64 on the CPU), got {dtype}")
        self.dtype = dtype
        self.n_stack = n_stack
        self.depth = depth
        self.norm = norm
        nc = norm_cls(norm)
        res = lambda cin, cout: Residual(cin, cout, norm, conv_cls)
        self.stem = conv_cls(in_features, 64, 7, stride=2, padding=3)
        self.stem_norm = nc(64)
        self.pre = nn.ModuleList([res(64, 128), res(128, 128), res(128, features)])
        self.extra_proj = (conv_cls(extra_features, features, 1)
                           if with_extra else None)
        self.hgs = nn.ModuleList(
            Hourglass(depth, n_modules, features, norm, conv_cls) for _ in range(n_stack)
        )
        self.lls = nn.ModuleList(
            nn.ModuleList(res(features, features) for _ in range(n_modules))
            for _ in range(n_stack)
        )
        self.ll_convs = nn.ModuleList(
            conv_cls(features, features, 1) for _ in range(n_stack)
        )
        self.ll_norms = nn.ModuleList(nc(features) for _ in range(n_stack))
        self.heads = nn.ModuleList(
            nn.Conv2d(features, num_output, 1) for _ in range(n_stack)
        )
        self.ll_merges = nn.ModuleList(
            conv_cls(features, features, 1) for _ in range(n_stack - 1)
        )
        self.out_merges = nn.ModuleList(
            conv_cls(num_output, features, 1) for _ in range(n_stack - 1)
        )

    def forward(self, x: torch.Tensor, extra: torch.Tensor | None = None, train: bool = False,
                row_mask: torch.Tensor | None = None):
        """x [N, C, H, W] channels_last -> list of n_stack f32
        [N, num_output, H/4, W/4] logits. `train`: batch statistics over the
        rows `row_mask` [N] marks real (all rows without it), and the
        running averages' update."""
        dt = self.dtype
        t = (train, row_mask_u8(row_mask) if train else row_mask)
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
