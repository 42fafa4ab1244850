"""Heatmap readout (kernel K2) and prior-keypoint rendering (kernel K5),
each beside its plain version.

Port of `suo_slam_tpu/ops/heatmap.py` (`ndc_grid`, `spatial_softmax`,
`soft_argmax`, `soft_argmax_from_logits`, `prior_sigma_for`,
`render_prior_heatmaps`, `max_merge_priors`). Heatmaps keep the JAX package's
public NHWC layout [N, H, W, K]; the readout grid has columns carrying u and
rows carrying v (v up), matching `pixels_to_ndc`.

`heatmap_readout` is what PkpNet calls: per (crop, keypoint) a max-shifted
softmax over H x W, the f32 moments (1, u, v, u^2, v^2, uv) -> uv and
cov = E[pp^T] - mu mu^T + min_var I, and the mean-pooled raw logit for the
validity head. Logits are f32, or bf16 from the int8 engine: then the shift
l - max rounds to bf16 before the f32 exp, as JAX subtracts in the logits'
dtype, and the pooled mean is taken in f32 (`int8_forward.py:535`).
`render_prior_heatmaps` draws the peak-1 Gaussians of the SLAM engine's
projected prior keypoints. A CPU tensor takes the plain
version; a CUDA tensor launches `csrc/heatmap_readout.cu` /
`csrc/prior_render.cu` or raises.
"""

from __future__ import annotations

import ctypes

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


def soft_argmax_from_logits(logits: torch.Tensor, calc_cov: bool = True,
                            min_var: float = 1e-6):
    """Softmax + soft-argmax in one moment contraction with the normalizer as
    a ones-column. Returns (uv [..., K, 2], cov [..., K, 2, 2] | None,
    prob like logits)."""
    h, w, k = logits.shape[-3:]
    flat = logits.reshape(logits.shape[:-3] + (h * w, k))
    shift = torch.amax(flat, dim=-2, keepdim=True)
    e = torch.exp((flat - shift).to(torch.float32))
    u, v = ndc_grid(h, w, torch.float32, logits.device)
    feats = torch.stack(
        [torch.ones_like(u), u, v, u * u, v * v, u * v], dim=-1
    ).reshape(h * w, 6)
    m = torch.einsum("...pk,pf->...kf", e, feats)
    z = torch.clamp(m[..., :1], min=torch.finfo(torch.float32).tiny)
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
    cov [N, K, 2, 2], pooled [N, K])."""
    uv, cov, _ = soft_argmax_from_logits(logits, True, min_var)
    return uv, cov, torch.mean(logits.to(torch.float32), dim=(1, 2))


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_LOGIT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _heatmap_readout_cuda(logits: torch.Tensor, min_var: float):
    kernels.refuse_autograd("K2 heatmap_readout", logits)
    if logits.dtype not in _LOGIT_DTYPES or logits.dim() != 4:
        raise ValueError(f"K2 takes [N,H,W,K] f32 or bf16 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    N, H, W, K = logits.shape
    sn, sh, sw, sk = logits.stride()
    dev = logits.device
    uv = torch.empty((N, K, 2), dtype=torch.float32, device=dev)
    cov = torch.empty((N, K, 2, 2), dtype=torch.float32, device=dev)
    pooled = torch.empty((N, K), dtype=torch.float32, device=dev)
    fn = _build.entry("heatmap_readout", _ARGTYPES)
    err = fn(_build.ptr(logits), sn, sh, sw, sk, N, H, W, K, float(min_var),
             _build.ptr(uv), _build.ptr(cov), _build.ptr(pooled),
             _LOGIT_DTYPES[logits.dtype], _build.stream())
    _build.check(err, "K2 heatmap_readout")
    kernels.count("heatmap_readout")
    return uv, cov, pooled


def heatmap_readout(logits: torch.Tensor, min_var: float = 1e-6):
    """Softmax + soft-argmax + mean-pool readout of [N, H, W, K] f32 or bf16
    logits (any strides). Returns (uv [N, K, 2], cov [N, K, 2, 2], pooled [N, K])."""
    if logits.device.type == "cpu":
        return heatmap_readout_plain(logits, min_var)
    if logits.device.type != "cuda":
        raise ValueError(f"heatmap_readout: unsupported device {logits.device}")
    return _heatmap_readout_cuda(logits, min_var)


def _prior_sigmas(hw, sigma_px: float):
    """sigma in NDC units along u and v (u spans 2 over w pixels), rounded
    to f32 as the JAX package computes them."""
    h, w = hw
    s = torch.tensor(sigma_px, dtype=torch.float32)
    return float(s / (w / 2.0)), float(s / (h / 2.0))


def render_prior_heatmaps_plain(uv: torch.Tensor, mask: torch.Tensor,
                                hw: tuple[int, int] = (256, 256),
                                sigma_px: float = PRIOR_SIGMA_PX) -> torch.Tensor:
    """Plain PyTorch K5: [..., K, 2] NDC keypoints and [..., K] validity ->
    [..., H, W, K] peak-1 Gaussians; a masked or non-finite keypoint draws
    nothing (its channel is 0)."""
    h, w = hw
    dev = uv.device
    u, v = ndc_grid(h, w, torch.float32, dev)
    finite = torch.isfinite(uv).all(-1)
    uvc = torch.clamp(torch.nan_to_num(uv.to(torch.float32)), -1.0, 1.0)
    su, sv = (torch.tensor(s, dtype=torch.float32, device=dev)
              for s in _prior_sigmas(hw, sigma_px))
    du = (u[..., None] - uvc[..., None, None, :, 0]) / su
    dv = (v[..., None] - uvc[..., None, None, :, 1]) / sv
    g = torch.exp(-0.5 * (du * du + dv * dv))
    valid = (mask.bool() & finite).to(torch.float32)[..., None, None, :]
    return g * valid


_PRIOR_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p] * 2)


def _render_prior_cuda(uv: torch.Tensor, mask: torch.Tensor, hw, sigma_px: float):
    if uv.shape[-1] != 2 or mask.shape != uv.shape[:-1]:
        raise ValueError(f"K5 takes [..., K, 2] keypoints and a [..., K] mask, got "
                         f"{tuple(uv.shape)} and {tuple(mask.shape)}")
    if mask.device != uv.device:
        raise ValueError("K5 inputs must lie on one CUDA device")
    lead, K = tuple(uv.shape[:-2]), uv.shape[-2]
    if 3 * K * 4 > 48 * 1024:
        raise ValueError(f"K5 stages at most 4096 keypoints per crop, got {K}")
    N = 1
    for d in lead:
        N *= d
    h, w = hw
    su, sv = _prior_sigmas(hw, sigma_px)
    uvc = uv.reshape(N, K, 2).to(torch.float32).contiguous()
    mk = mask.reshape(N, K).to(torch.uint8).contiguous()
    out = torch.empty((N, h, w, K), dtype=torch.float32, device=uv.device)
    fn = _build.entry("prior_render", _PRIOR_ARGTYPES)
    err = fn(_build.ptr(uvc), _build.ptr(mk), N, h, w, K, su, sv, _build.ptr(out),
             _build.stream())
    _build.check(err, "K5 prior_render")
    kernels.count("prior_render")
    return out.reshape(lead + (h, w, K))


def render_prior_heatmaps(uv: torch.Tensor, mask: torch.Tensor,
                          hw: tuple[int, int] = (256, 256),
                          sigma_px: float = PRIOR_SIGMA_PX) -> torch.Tensor:
    """Prior-keypoint Gaussians [..., H, W, K] (NHWC, contiguous) of
    [..., K, 2] NDC keypoints: each valid, finite keypoint, clipped to
    [-1, 1], becomes an isotropic Gaussian of peak 1 and `sigma_px` pixels of
    the output map. K5 on a CUDA tensor, the plain version on a CPU tensor."""
    if uv.device.type == "cpu":
        return render_prior_heatmaps_plain(uv, mask, hw, sigma_px)
    if uv.device.type != "cuda":
        raise ValueError(f"render_prior_heatmaps: unsupported device {uv.device}")
    return _render_prior_cuda(uv, mask, hw, sigma_px)


def max_merge_priors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two prior maps (element-wise max keeps peak-1 semantics)."""
    return torch.maximum(a, b)
