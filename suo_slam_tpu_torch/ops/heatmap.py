"""Heatmap readout (kernel K2, its backward K19) and prior-keypoint
rendering (kernel K5), each beside its plain version.

Port of `suo_slam_tpu/ops/heatmap.py` (`ndc_grid`, `spatial_softmax`,
`soft_argmax`, `soft_argmax_from_logits`, `heatmap_variance`,
`prior_sigma_for`, `render_prior_heatmaps`, `max_merge_priors`). Heatmaps keep the JAX package's
public NHWC layout [N, H, W, K]; the readout grid has columns carrying u and
rows carrying v (v up), matching `pixels_to_ndc`.

`heatmap_readout` is what PkpNet calls: per (crop, keypoint) a max-shifted
softmax over H x W, the f32 moments (1, u, v, u^2, v^2, uv) -> uv and
cov = E[pp^T] - mu mu^T + min_var I, and the mean-pooled raw logit for the
validity head. Logits are f32, or bf16 from the int8 engine: then the shift
l - max rounds to bf16 before the f32 exp, as JAX subtracts in the logits'
dtype, and the pooled mean is taken in f32 (`int8_forward.py:535`). On the
card `plan_readout` sends the head's channels-last logits (a contiguous
slab per crop) to K2's dense path, a thread-block cluster per crop, and any
other strides to its strided path.
Where autograd records the readout (training), it is one
`torch.autograd.Function` whose backward is K19: the logits' gradient from
those of uv, cov and pooled (the gradient of the JAX net's train-time
`spatial_softmax` -> `soft_argmax` and mean pool). `plan_readout_bwd` sends
K19 to its dense path (K2's cluster design, the gradient written in the
slab's storage order) wherever K2 takes the dense path, else to its strided
path.
`render_prior_heatmaps` draws the peak-1 Gaussians of the SLAM engine's
projected prior keypoints. A CPU tensor takes the plain
version; a CUDA tensor launches `csrc/heatmap_readout.cu` /
`csrc/prior_render.cu` or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..kernels import _build

# Effective sigma of the reference's prior Gaussian: a 91-pixel GaussianBlur
# with sigma 0 derives 0.3 * ((91 - 1) * 0.5 - 1) + 0.8 = 14.0 pixels.
PRIOR_SIGMA_PX = 14.0
PRIOR_SIGMA_REF_H = 256  # sigma above is defined at this map height


def prior_sigma_for(hw: tuple[int, int]) -> float:
    """The reference prior sigma scaled to another map resolution (the prior
    is a fixed fraction ~5.5% of the ROI span)."""
    return PRIOR_SIGMA_PX * hw[0] / PRIOR_SIGMA_REF_H


def ndc_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(u, v) NDC value of every pixel centre; each [h, w]."""
    ru = (torch.arange(w, dtype=dtype, device=device) + 0.5) / (w / 2.0) - 1.0
    rv = 1.0 - (torch.arange(h, dtype=dtype, device=device) + 0.5) / (h / 2.0)
    return ru[None, :].expand(h, w), rv[:, None].expand(h, w)


def spatial_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Per-channel softmax over the spatial dims of [..., H, W, K]."""
    h, w, k = logits.shape[-3:]
    flat = logits.reshape(logits.shape[:-3] + (h * w, k))
    return torch.softmax(flat, dim=-2).reshape(logits.shape)


def _cov_from_moments(eu, ev, euu, evv, euv, min_var):
    cuu = euu - eu * eu + min_var
    cvv = evv - ev * ev + min_var
    cuv = euv - eu * ev
    return torch.stack(
        [torch.stack([cuu, cuv], -1), torch.stack([cuv, cvv], -1)], dim=-2
    )


def soft_argmax(prob: torch.Tensor, calc_cov: bool = True, min_var: float = 1e-6):
    """Expected uv [..., K, 2] (and cov [..., K, 2, 2]) of [..., H, W, K]
    probability maps."""
    h, w, k = prob.shape[-3:]
    u, v = ndc_grid(h, w, prob.dtype, prob.device)
    feats = torch.stack([u, v, u * u, v * v, u * v], dim=-1).reshape(h * w, 5)
    flat = prob.reshape(prob.shape[:-3] + (h * w, k))
    m = torch.einsum("...pk,pf->...kf", flat, feats)
    mu = m[..., :2]
    if not calc_cov:
        return mu, None
    return mu, _cov_from_moments(m[..., 0], m[..., 1], m[..., 2], m[..., 3],
                                 m[..., 4], min_var)


def heatmap_variance(prob: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """E[|p - uv|^2] per channel: [..., H, W, K], [..., K, 2] -> [..., K]
    (the spread term of the no-covariance loss)."""
    h, w, k = prob.shape[-3:]
    u, v = ndc_grid(h, w, prob.dtype, prob.device)
    feats = torch.stack([torch.ones_like(u), u, v, u * u + v * v], -1).reshape(h * w, 4)
    flat = prob.reshape(prob.shape[:-3] + (h * w, k))
    m = torch.einsum("...pk,pf->...kf", flat, feats)
    # E[|p|^2] - 2 uv . E[p] + |uv|^2 E[1]
    return (m[..., 3] - 2.0 * (uv[..., 0] * m[..., 1] + uv[..., 1] * m[..., 2])
            + torch.sum(uv * uv, -1) * m[..., 0])


def soft_argmax_from_logits(logits: torch.Tensor, calc_cov: bool = True,
                            min_var: float = 1e-6):
    """Softmax + soft-argmax in one moment contraction with the normalizer as
    a ones-column. Returns (uv [..., K, 2], cov [..., K, 2, 2] | None,
    prob like logits)."""
    h, w, k = logits.shape[-3:]
    f = kernels.plain_dtype(logits.dtype)
    flat = logits.reshape(logits.shape[:-3] + (h * w, k))
    shift = torch.amax(flat, dim=-2, keepdim=True)
    e = torch.exp((flat - shift).to(f))
    u, v = ndc_grid(h, w, f, logits.device)
    feats = torch.stack(
        [torch.ones_like(u), u, v, u * u, v * v, u * v], dim=-1
    ).reshape(h * w, 6)
    m = torch.einsum("...pk,pf->...kf", e, feats)
    z = torch.clamp(m[..., :1], min=torch.finfo(f).tiny)
    m = m[..., 1:] / z
    prob = (e / z[..., 0][..., None, :]).to(logits.dtype).reshape(logits.shape)
    mu = m[..., :2]
    if not calc_cov:
        return mu, None, prob
    cov = _cov_from_moments(m[..., 0], m[..., 1], m[..., 2], m[..., 3],
                            m[..., 4], min_var)
    return mu, cov, prob


def heatmap_readout_plain(logits: torch.Tensor, min_var: float = 1e-6):
    """Plain PyTorch K2 on [N, H, W, K] logits -> (uv [N, K, 2],
    cov [N, K, 2, 2], pooled [N, K]), f32 (f64 for f64 logits)."""
    uv, cov, _ = soft_argmax_from_logits(logits, True, min_var)
    return uv, cov, torch.mean(logits.to(kernels.plain_dtype(logits.dtype)), dim=(1, 2))


# K2's paths and the dense path's geometry; mirror `csrc/heatmap_readout.cu`
DENSE, STRIDED = 0, 1
READOUT_MAX_THREADS = 1024  # kMaxDenseThreads
READOUT_CLUSTER = 8         # kCluster: CTAs per crop (the portable cluster size)
READOUT_PER = 8             # kPer: inner positions of a row per thread
READOUT_MAX_ROWS = 32       # kMaxStripRows
READOUT_MAX_K = 64          # kMaxK
READOUT_STRIP_BYTES = 160 * 1024  # dynamic shared memory of a CTA's strip, at most
# static shared memory of K19's dense kernel: the rows' mbarriers, the
# per-thread maxima, the per-channel coefficients (11 x kMaxK) and the rows'
# coordinates; a CTA has 227 KB (232,448 bytes) on an H100
READOUT_BWD_STATIC = 8 * READOUT_MAX_ROWS + 4 * READOUT_MAX_THREADS + 4 * 11 * READOUT_MAX_K \
    + 4 * READOUT_MAX_ROWS
CTA_SMEM = 232448


class ReadoutPlan(NamedTuple):
    path: int          # DENSE or STRIDED
    transposed: bool   # dense: storage [W, H, K] (transpose_heatmaps) rather than [H, W, K]
    A: int             # dense: outer storage extent (H, or W when transposed)
    Bd: int            # dense: inner storage extent
    rows: int          # dense: storage rows per CTA
    threads: int       # dense: threads of a CTA
    smem: int          # dense: dynamic shared memory of a CTA (strip, exchange buffers)


def plan_readout(shape, strides, elem_size: int, data_ptr: int,
                 path: int | None = None) -> ReadoutPlan:
    """K2's launch for [N, H, W, K] logits with these strides (elements).
    The dense path takes a crop whose [H, W, K] slab — or [W, H, K], the
    transpose_heatmaps view — is contiguous with K innermost, 16-byte aligned
    rows and crops (TMA bulk copies), K <= READOUT_MAX_K, an inner extent
    that READOUT_PER divides into Bd / READOUT_PER threads a channel, at most
    READOUT_MAX_THREADS a CTA and at least 6 K (the moments' reduction), and
    a strip of ceil(outer / READOUT_CLUSTER) rows that fits READOUT_MAX_ROWS
    and READOUT_STRIP_BYTES; anything else takes the strided path (`path`
    forces one, or raises where the dense path cannot take the shape)."""
    N, H, W, K = shape
    sn, sh, sw, sk = strides
    strided = ReadoutPlan(STRIDED, False, 0, 0, 0, 0, 0)
    natural = sk == 1 and sw == K and sh == W * K
    transposed = not natural and sk == 1 and sh == K and sw == H * K
    why = None
    if not (natural or transposed):
        why = f"strides {tuple(strides)} are not a dense channels-last crop"
    else:
        A, Bd = (W, H) if transposed else (H, W)
        rows = -(-A // READOUT_CLUSTER)
        row_bytes = Bd * K * elem_size
        threads = -(-(Bd // READOUT_PER) * K // 32) * 32
        if K > READOUT_MAX_K or rows > READOUT_MAX_ROWS:
            why = f"K = {K} or {rows} rows a CTA exceed the dense limits"
        elif Bd % READOUT_PER or not 6 * K <= threads <= READOUT_MAX_THREADS:
            why = f"no split of the inner extent {Bd} over threads for K = {K}"
        elif rows * row_bytes > READOUT_STRIP_BYTES:
            why = f"a strip of {rows * row_bytes} bytes exceeds {READOUT_STRIP_BYTES}"
        elif row_bytes % 16 or data_ptr % 16 or (N > 1 and (sn * elem_size) % 16):
            why = "rows or crops are not 16-byte aligned"
    if why is None:
        plan = ReadoutPlan(DENSE, transposed, A, Bd, rows, threads,
                           max(rows * row_bytes, 6 * threads * 4) + READOUT_CLUSTER * K * 8 * 4)
    else:
        plan = strided
    if path is None or path == plan.path:
        return plan
    if path == STRIDED:
        return strided
    if path == DENSE:
        raise ValueError(f"K2's dense path cannot take {tuple(shape)}: {why}")
    raise ValueError(f"K2 has no path {path}")


def plan_readout_bwd(shape, strides, elem_size: int, data_ptr: int,
                     path: int | None = None) -> ReadoutPlan:
    """K19's launch: its dense path wherever K2's takes the logits
    (`plan_readout`, the same geometry and the same `path` rule), with the
    backward's dynamic shared memory — the strip, kept whole for the third
    pass, the per-thread moments [6][threads] beside it, the moments' and
    maxima's exchange buffers [cluster][7][K] — else the strided path."""
    plan = plan_readout(shape, strides, elem_size, data_ptr, path)
    if plan.path != DENSE:
        return plan
    K = shape[3]
    smem = (plan.rows * plan.Bd * K * elem_size + 6 * plan.threads * 4
            + READOUT_CLUSTER * K * 7 * 4)
    return plan._replace(smem=smem)


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_DENSE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_LOGIT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _heatmap_readout_cuda(logits: torch.Tensor, min_var: float, path: int | None = None):
    """K2, one launch on the path `plan_readout` picks (`path` forces one:
    STRIDED is the earlier design, kept for comparisons)."""
    if logits.dtype not in _LOGIT_DTYPES or logits.dim() != 4:
        raise ValueError(f"K2 takes [N,H,W,K] f32 or bf16 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    N, H, W, K = logits.shape
    sn, sh, sw, sk = logits.stride()
    dev = logits.device
    uv = torch.empty((N, K, 2), dtype=torch.float32, device=dev)
    cov = torch.empty((N, K, 2, 2), dtype=torch.float32, device=dev)
    pooled = torch.empty((N, K), dtype=torch.float32, device=dev)
    plan = plan_readout(logits.shape, logits.stride(), logits.element_size(),
                        logits.data_ptr(), path)
    dt = _LOGIT_DTYPES[logits.dtype]
    if plan.path == DENSE:
        fn = _build.entry("heatmap_readout", _DENSE_ARGTYPES, "suo_heatmap_readout_dense")
        err = fn(_build.ptr(logits), sn, N, plan.A, plan.Bd, K, int(plan.transposed),
                 float(min_var), _build.ptr(uv), _build.ptr(cov), _build.ptr(pooled), dt,
                 _build.stream())
    else:
        fn = _build.entry("heatmap_readout", _ARGTYPES)
        err = fn(_build.ptr(logits), sn, sh, sw, sk, N, H, W, K, float(min_var),
                 _build.ptr(uv), _build.ptr(cov), _build.ptr(pooled), dt, _build.stream())
    _build.check(err, "K2 heatmap_readout")
    kernels.count("heatmap_readout")
    return uv, cov, pooled


def _heatmap_readout_fwd(logits: torch.Tensor, min_var: float):
    if logits.device.type == "cpu":
        return heatmap_readout_plain(logits, min_var)
    if logits.device.type != "cuda":
        raise ValueError(f"heatmap_readout: unsupported device {logits.device}")
    return _heatmap_readout_cuda(logits, min_var)


def heatmap_readout(logits: torch.Tensor, min_var: float = 1e-6):
    """Softmax + soft-argmax + mean-pool readout of [N, H, W, K] f32 or bf16
    logits (any strides). Returns (uv [N, K, 2], cov [N, K, 2, 2], pooled [N, K]).
    K2 on CUDA tensors, the plain version on CPU tensors; where autograd
    records the call, the backward is K19."""
    if kernels.autograd_records(logits):
        return _HeatmapReadout.apply(logits, min_var)
    return _heatmap_readout_fwd(logits, min_var)


# K19 ---------------------------------------------------------------------------
def heatmap_readout_bwd_plain(logits, g_uv, g_cov, g_pooled):
    """Plain K19: d logits [N, H, W, K] (logits' dtype, contiguous) from the
    f32 gradients of uv [N, K, 2], cov [N, K, 2, 2] and pooled [N, K]:
    p (f - E[f]) + g_pooled / (H W), f the derivative of the outputs in p
    (see `csrc/heatmap_readout.cu`), in f32 (f64 for f64 logits)."""
    N, H, W, K = logits.shape
    ft = kernels.plain_dtype(logits.dtype)
    flat = logits.reshape(N, H * W, K)
    shift = torch.amax(flat, dim=1, keepdim=True)
    e = torch.exp((flat - shift).to(ft))
    u, v = ndc_grid(H, W, ft, logits.device)
    u, v = u.reshape(1, H * W, 1), v.reshape(1, H * W, 1)
    m = lambda f: (e * f).sum(1)  # [N, K]
    z = torch.clamp(e.sum(1), min=torch.finfo(ft).tiny)
    eu, ev = m(u) / z, m(v) / z
    euu, evv, euv = m(u * u) / z, m(v * v) / z, m(u * v) / z
    du, dv = g_uv[..., 0], g_uv[..., 1]
    dcuu, dcvv = g_cov[..., 0, 0], g_cov[..., 1, 1]
    dcuv = g_cov[..., 0, 1] + g_cov[..., 1, 0]
    ef = (du * eu + dv * ev + dcuu * (euu - 2.0 * eu * eu) + dcvv * (evv - 2.0 * ev * ev)
          + dcuv * (euv - 2.0 * eu * ev))
    b = lambda t: t[:, None, :]
    f = (b(du) * u + b(dv) * v + b(dcuu) * (u * u - 2.0 * b(eu) * u)
         + b(dcvv) * (v * v - 2.0 * b(ev) * v) + b(dcuv) * (u * v - b(ev) * u - b(eu) * v))
    d = (e / b(z)) * (f - b(ef)) + b(g_pooled / float(H * W))
    return d.to(logits.dtype).reshape(N, H, W, K)


def _dense(t: torch.Tensor) -> bool:
    """Whether t's strides are a permutation of a contiguous layout (so an
    `empty_strided` of them is a dense tensor of its own)."""
    step = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda d: d[1]):
        if size > 1 and stride != step:
            return False
        step *= size
    return True


_BWD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                 + [ctypes.c_int, ctypes.c_void_p])
_BWD_DENSE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_void_p])


def _heatmap_readout_bwd_cuda(logits, g_uv, g_cov, g_pooled, path: int | None = None):
    """K19, one launch on the path `plan_readout_bwd` picks (`path` forces
    one: STRIDED is the earlier design, kept for comparisons)."""
    if logits.dtype not in _LOGIT_DTYPES or logits.dim() != 4:
        raise ValueError(f"K19 takes [N,H,W,K] f32 or bf16 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    N, H, W, K = logits.shape
    gs = [g.to(torch.float32).contiguous() for g in (g_uv, g_cov, g_pooled)]
    if [tuple(g.shape) for g in gs] != [(N, K, 2), (N, K, 2, 2), (N, K)] or any(
            g.device != logits.device for g in gs):
        raise ValueError("K19: the gradients of uv, cov and pooled must be [N,K,2], "
                         "[N,K,2,2] and [N,K] on the logits' device")
    plan = plan_readout_bwd(logits.shape, logits.stride(), logits.element_size(),
                            logits.data_ptr(), path)
    dt = _LOGIT_DTYPES[logits.dtype]
    if plan.path == DENSE:  # dl in the slab's storage order, as the logits
        dl = torch.empty((N, plan.A, plan.Bd, K), dtype=logits.dtype, device=logits.device)
        if plan.transposed:
            dl = dl.permute(0, 2, 1, 3)
        fn = _build.entry("heatmap_readout", _BWD_DENSE_ARGTYPES, "suo_heatmap_readout_bwd_dense")
        err = fn(_build.ptr(logits), logits.stride(0), N, plan.A, plan.Bd, K,
                 int(plan.transposed), *(_build.ptr(g) for g in gs), _build.ptr(dl),
                 plan.A * plan.Bd * K, dt, _build.stream())
    else:
        if _dense(logits):
            dl = torch.empty_strided(logits.shape, logits.stride(), dtype=logits.dtype,
                                     device=logits.device)
        else:
            dl = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
        fn = _build.entry("heatmap_readout", _BWD_ARGTYPES, "suo_heatmap_readout_bwd")
        err = fn(_build.ptr(logits), *logits.stride(), N, H, W, K, *(_build.ptr(g) for g in gs),
                 _build.ptr(dl), *dl.stride(), dt, _build.stream())
    _build.check(err, "K19 heatmap_readout_bwd")
    kernels.count("heatmap_readout_bwd")
    return dl


def heatmap_readout_bwd(logits, g_uv, g_cov, g_pooled):
    """The readout's backward (see `heatmap_readout_bwd_plain`): K19 on CUDA
    tensors, written in the logits' own layout; the plain version on CPU
    tensors."""
    if logits.device.type == "cpu":
        return heatmap_readout_bwd_plain(logits, g_uv, g_cov, g_pooled)
    if logits.device.type != "cuda":
        raise ValueError(f"heatmap_readout_bwd: unsupported device {logits.device}")
    return _heatmap_readout_bwd_cuda(logits, g_uv, g_cov, g_pooled)


class _HeatmapReadout(torch.autograd.Function):
    """K2 forward, K19 backward (an output without a gradient counts as 0)."""

    @staticmethod
    def forward(ctx, logits, min_var):
        ctx.save_for_backward(logits)
        return _heatmap_readout_fwd(logits, min_var)

    @staticmethod
    def backward(ctx, g_uv, g_cov, g_pooled):
        (logits,) = ctx.saved_tensors
        N, _, _, K = logits.shape
        z = lambda g, shape: g if g is not None else logits.new_zeros(shape, dtype=torch.float32)
        return heatmap_readout_bwd(logits, z(g_uv, (N, K, 2)), z(g_cov, (N, K, 2, 2)),
                                   z(g_pooled, (N, K))), None


def _prior_sigmas(hw, sigma_px: float, dtype=torch.float32):
    """sigma in NDC units along u and v (u spans 2 over w pixels), rounded
    to f32 (`dtype`) as the JAX package computes them."""
    h, w = hw
    s = torch.tensor(sigma_px, dtype=dtype)
    return float(s / (w / 2.0)), float(s / (h / 2.0))


def render_prior_heatmaps_plain(uv: torch.Tensor, mask: torch.Tensor,
                                hw: tuple[int, int] = (256, 256),
                                sigma_px: float = PRIOR_SIGMA_PX,
                                dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch K5: [..., K, 2] NDC keypoints and [..., K] validity ->
    [..., H, W, K] peak-1 Gaussians, computed in f32 (f64 for f64 uv) and
    rounded once to `dtype` (default: that dtype); a masked or non-finite
    keypoint draws nothing (its channel is 0)."""
    h, w = hw
    dev = uv.device
    f = kernels.plain_dtype(uv.dtype)
    u, v = ndc_grid(h, w, f, dev)
    finite = torch.isfinite(uv).all(-1)
    uvc = torch.clamp(torch.nan_to_num(uv.to(f)), -1.0, 1.0)
    su, sv = (torch.tensor(s, dtype=f, device=dev) for s in _prior_sigmas(hw, sigma_px, f))
    du = (u[..., None] - uvc[..., None, None, :, 0]) / su
    dv = (v[..., None] - uvc[..., None, None, :, 1]) / sv
    g = torch.exp(-0.5 * (du * du + dv * dv))
    valid = (mask.bool() & finite).to(f)[..., None, None, :]
    return (g * valid).to(dtype or f)


# K5's store routes (`csrc/prior_render.cu`): 16-byte stores, or one value a store
PRIOR_VECTOR, PRIOR_SCALAR = "vector", "scalar"
_PRIOR_TILE = (8, 16)  # kRows x kCols: a block's pixels, whose staged terms bound K
_PRIOR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plan_prior_render(n: int, hw: tuple[int, int], k: int, dtype: torch.dtype,
                      out_ptr: int = 0) -> str:
    """K5's store route (`csrc/prior_render.cu`) for n crops of [H, W, K]
    maps of `dtype` (f32 or bf16) at `out_ptr`: 16-byte stores where W * K
    is a multiple of a vector and the output is 16-byte aligned, else one
    value a store. Raises on what the kernel refuses: another dtype, more
    than 65,535 crops, or keypoints whose staged terms (du of a tile's
    columns, dv of its rows) outgrow a block's shared memory."""
    if dtype not in _PRIOR_DTYPES:
        raise ValueError(f"K5 writes f32 or bf16, got {dtype}")
    v = 16 // dtype.itemsize
    if (hw[1] * k) % v or out_ptr % 16:
        v = 1
    rows, cols = _PRIOR_TILE
    if 4 * ((cols * k + 3) // 4 * 4 + rows * (k + v - 1)) > CTA_SMEM or n > 65535:
        raise ValueError(f"K5 takes at most 65535 crops, and keypoints whose staged terms "
                         f"fit {CTA_SMEM} bytes of shared memory: got {n} crops of {k}")
    return PRIOR_VECTOR if v > 1 else PRIOR_SCALAR


_PRIOR_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _render_prior_cuda(uv: torch.Tensor, mask: torch.Tensor, hw, sigma_px: float,
                       dtype: torch.dtype | None = None):
    if uv.shape[-1] != 2 or mask.shape != uv.shape[:-1]:
        raise ValueError(f"K5 takes [..., K, 2] keypoints and a [..., K] mask, got "
                         f"{tuple(uv.shape)} and {tuple(mask.shape)}")
    if mask.device != uv.device:
        raise ValueError("K5 inputs must lie on one CUDA device")
    dtype = dtype or torch.float32
    lead, K = tuple(uv.shape[:-2]), uv.shape[-2]
    N = 1
    for d in lead:
        N *= d
    h, w = hw
    su, sv = _prior_sigmas(hw, sigma_px)
    uvc = uv.reshape(N, K, 2).to(torch.float32).contiguous()
    mk = mask.reshape(N, K).bool().contiguous()  # a bool tensor's bytes, as they are
    out = torch.empty((N, h, w, K), dtype=dtype, device=uv.device)
    route = plan_prior_render(N, hw, K, dtype, out.data_ptr())
    fn = _build.entry("prior_render", _PRIOR_ARGTYPES)
    err = fn(_build.ptr(uvc), _build.ptr(mk), N, h, w, K, su, sv, _build.ptr(out),
             _PRIOR_DTYPES[dtype], int(route == PRIOR_VECTOR), _build.stream())
    _build.check(err, "K5 prior_render")
    kernels.count("prior_render")
    return out.reshape(lead + (h, w, K))


def render_prior_heatmaps(uv: torch.Tensor, mask: torch.Tensor,
                          hw: tuple[int, int] = (256, 256),
                          sigma_px: float = PRIOR_SIGMA_PX,
                          dtype: torch.dtype | None = None) -> torch.Tensor:
    """Prior-keypoint Gaussians [..., H, W, K] (NHWC, contiguous) of
    [..., K, 2] NDC keypoints: each valid, finite keypoint, clipped to
    [-1, 1], becomes an isotropic Gaussian of peak 1 and `sigma_px` pixels of
    the output map, computed in f32 and rounded once to `dtype` (f32 or
    bf16; default f32, f64 for f64 uv on the CPU): a net passes its
    `prior_dtype`, so it casts nothing. K5 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if uv.device.type == "cpu":
        return render_prior_heatmaps_plain(uv, mask, hw, sigma_px, dtype)
    if uv.device.type != "cuda":
        raise ValueError(f"render_prior_heatmaps: unsupported device {uv.device}")
    return _render_prior_cuda(uv, mask, hw, sigma_px, dtype)


def max_merge_priors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two prior maps (element-wise max keeps peak-1 semantics)."""
    return torch.maximum(a, b)
