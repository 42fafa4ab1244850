"""Training losses for PkpNet: MLE (Mahalanobis + logdet), variance, BCE.

Port of `suo_slam_tpu/train/losses.py` (plain torch, as the JAX package
computes them in `jnp`): every term is a masked mean over the padded [N, K]
layout, so the batch shape never depends on the labels. The no-covariance
loss takes the heatmap's spread per keypoint (`PkpNetOutput.spread`, from
the readout's covariance) where JAX takes the probability maps and forms
`heatmap_variance` from them: the same term, without a [N, H, W, K] map.
"""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, total=None) -> torch.Tensor:
    """sum(x m) / max(sum(m), 1); `total` in place of sum(m): the global
    batch's mask count, which makes this rank's share of the global mean."""
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m) if total is None else total, min=1.0)


def mle_loss(uv_pred, uv_gt, cov, mask, total=None):
    """Gaussian MLE: (Mahalanobis residual mean, logdet(cov) mean), with the
    1e-6 diagonal loading and the closed-form 2x2 inverse."""
    res = uv_gt - uv_pred
    a = cov[..., 0, 0] + 1e-6
    d = cov[..., 1, 1] + 1e-6
    b = cov[..., 0, 1]
    det = torch.clamp(a * d - b * b, min=1e-12)
    ru, rv = res[..., 0], res[..., 1]
    maha = (d * ru * ru - 2.0 * b * ru * rv + a * rv * rv) / det
    return _masked_mean(maha, mask, total), _masked_mean(torch.log(det), mask, total)


def l2_variance_loss(uv_pred, uv_gt, spread, mask, total=None):
    """No-covariance fallback: L2 on uv + heatmap variance minimization;
    spread [N, K] is E|p - uv|^2 (`heatmap.readout_spread`, or
    `heatmap.heatmap_variance` of probability maps)."""
    res = uv_gt - uv_pred
    uv_l = _masked_mean(torch.sum(res * res, -1), mask, total)
    return uv_l, _masked_mean(spread, mask, total)


def bce_with_logits(logits, target):
    """Stable elementwise binary cross-entropy from logits."""
    return torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def kp_loss(uv, cov, spread, kp_mask_logits, uv_gt, mask, totals=None):
    """(uv_loss, var_loss, mask_bce_loss), all scalars. mask [N, K] bool: the
    labeled channels; the BCE trains the validity head against it over ALL
    channels, padded rows included. `totals` (the sharded step's): the global
    batch's (sum of mask, N x K), a [2] tensor: each term is then this
    rank's share of the global batch's, and `any_valid` the global batch's."""
    total = None if totals is None else totals[0]
    if cov is not None:
        uv_l, var_l = mle_loss(uv, uv_gt, cov, mask, total)
    else:
        uv_l, var_l = l2_variance_loss(uv, uv_gt, spread, mask, total)
    b = bce_with_logits(kp_mask_logits, mask.to(kp_mask_logits.dtype))
    bce = torch.mean(b) if totals is None else torch.sum(b) / totals[1]
    any_valid = torch.sum(mask) > 0 if totals is None else totals[0] > 0
    zero = torch.zeros((), dtype=uv_l.dtype, device=uv_l.device)
    return (torch.where(any_valid, uv_l, zero), torch.where(any_valid, var_l, zero),
            torch.where(any_valid, bce, zero))


def anneal_weights(epoch, device=None, dtype=torch.float32):
    """(var_lambda, mask_lambda) = sigmoid(epoch - 5), sigmoid(epoch - 10)."""
    e = torch.as_tensor(epoch, dtype=dtype, device=device)
    return torch.sigmoid(e - 5.0), torch.sigmoid(e - 10.0)


def total_loss(uv, cov, spread, kp_mask_logits, uv_gt, mask, epoch, do_anneal: bool = True,
               totals=None):
    """Combined objective uv + 0.5 * var_l * var + mask_l * bce, and its
    terms (with `totals`, this rank's share of the global batch's: see
    `kp_loss`)."""
    uv_l, var_l, bce_l = kp_loss(uv, cov, spread, kp_mask_logits, uv_gt, mask, totals)
    if do_anneal:
        var_w, mask_w = anneal_weights(epoch, uv_l.device, uv_l.dtype)
    else:
        var_w = mask_w = torch.ones((), dtype=uv_l.dtype, device=uv_l.device)
    loss = uv_l + 0.5 * var_w * var_l + mask_w * bce_l
    aux = {"uv_loss": uv_l, "var_loss": var_l, "mask_loss": bce_l,
           "var_lambda": var_w, "mask_lambda": mask_w}
    return loss, aux
