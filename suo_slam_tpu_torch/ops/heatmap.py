"""Heatmap readout — kernel K2 and its plain version.

Port of `suo_slam_tpu/ops/heatmap.py` (`ndc_grid`, `spatial_softmax`,
`soft_argmax`, `soft_argmax_from_logits`). Heatmaps keep the JAX package's
public NHWC layout [N, H, W, K]; the readout grid has columns carrying u and
rows carrying v (v up), matching `pixels_to_ndc`.

`heatmap_readout` is what PkpNet calls: per (crop, keypoint) a max-shifted
softmax over H x W, the f32 moments (1, u, v, u^2, v^2, uv) -> uv and
cov = E[pp^T] - mu mu^T + min_var I, and the mean-pooled raw logit for the
validity head. A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/heatmap_readout.cu` or raises. `render_prior_heatmaps` is not ported
yet (SLAM mode).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..kernels import _build


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
    return uv, cov, torch.mean(logits, dim=(1, 2))


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_void_p] * 4)


def _heatmap_readout_cuda(logits: torch.Tensor, min_var: float):
    if logits.dtype != torch.float32 or logits.dim() != 4:
        raise ValueError(f"K2 takes [N,H,W,K] f32 logits, got "
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
             _build.stream())
    _build.check(err, "K2 heatmap_readout")
    kernels.count("heatmap_readout")
    return uv, cov, pooled


def heatmap_readout(logits: torch.Tensor, min_var: float = 1e-6):
    """Softmax + soft-argmax + mean-pool readout of [N, H, W, K] logits (any
    strides). Returns (uv [N, K, 2], cov [N, K, 2, 2], pooled [N, K])."""
    if logits.device.type == "cpu":
        return heatmap_readout_plain(logits, min_var)
    if logits.device.type != "cuda":
        raise ValueError(f"heatmap_readout: unsupported device {logits.device}")
    return _heatmap_readout_cuda(logits, min_var)
