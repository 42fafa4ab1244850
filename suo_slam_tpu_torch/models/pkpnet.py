"""PkpNet: probabilistic keypoint network (uv + 2x2 covariance + validity).

Port of `suo_slam_tpu/models/pkpnet.py`. The public input is
the JAX package's NHWC crop batch [N, 256, 256, 3]; inside, the backbone runs
NCHW with `channels_last` memory, so the head's logits are already laid out
as the public NHWC heatmaps [N, H/4, W/4, K] and the readout (kernel K2,
`ops/heatmap.heatmap_readout`) reads them through strides, without a copy.

Validity head: mean-pooled raw logits -> ReLU -> Dropout(0.5) -> Linear(K,
K) -> sigmoid. Dropout acts in train mode only (`forward(..., train=True)`,
which also takes the backbone's norms to their batch statistics over the
rows `row_mask` marks): it keeps each value with probability 0.5 and
doubles it, drawing from the `torch.Generator` it is given on the net's
device, or applying a given keep mask `dropout_mask` [N, K] bool.

`prior_mode="post_stem"` injects the prior after the stem through a 1x1
projection; with no prior the projection contributes its bias only (what
the JAX net computes on its all-zero prior). `prior_mode="concat"`
concatenates the prior to the RGB input.

`dtype` is the backbone's working dtype, f32 or bf16 (the JAX package's
`PkpNet(dtype=...)`; `evaluate.py` runs bf16 by default): the crops and the
prior are cast to it inside the backbone, whose heads return f32 logits, so
the readout and the validity head stay f32 (`models/hourglass.py`).

`norm`: "batch" (masked BatchNorm, K8 / K16 / K17) or "group" (GroupNorm,
K20 / K21). `quant`: "off", or "calib" / "int8", every convolution but the
heads a `models/quant.QuantConv` in that mode (K12 and K11 in int8 mode;
`quant.calibrate` fills the scales); the quantized modes are inference-only.
The constructor takes every argument of the JAX `PkpNet`.
"""

from __future__ import annotations

from functools import partial

from typing import NamedTuple

import torch
from torch import nn

from ..kp import config as kp_config
from ..ops import heatmap as hm
from . import quant as q
from .hourglass import HourglassNet


class PkpNetOutput(NamedTuple):
    uv: torch.Tensor                 # [N, K, 2] expected NDC keypoint
    cov: torch.Tensor | None         # [N, K, 2, 2] heatmap covariance
    prob_logits: torch.Tensor        # [N, H/4, W/4, K] final-stack logits
    kp_mask_logits: torch.Tensor     # [N, K]
    kp_mask: torch.Tensor            # [N, K] sigmoid validity probability
    aux_logits: tuple = ()           # earlier stacks, NHWC
    # The softmaxed heatmaps (`prob` in the JAX output) are never formed by
    # the readout kernel: `hm.spatial_softmax(out.prob_logits)` gives them.


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PkpNet(nn.Module):
    """Stacked-hourglass keypoint network with covariance readout."""

    def __init__(self, num_kp: int = kp_config.num_kp(), calc_cov: bool = True,
                 n_stack: int = 2, n_modules: int = 2, features: int = 256,
                 norm: str = "batch", prior_mode: str = "post_stem",
                 transpose_heatmaps: bool = False, dtype: torch.dtype = torch.float32,
                 quant: str = "off"):
        super().__init__()
        if prior_mode not in ("post_stem", "concat"):
            raise ValueError(f"unknown prior_mode {prior_mode!r}")
        if quant != "off" and quant not in q.MODES:
            raise ValueError(f"unknown quant mode {quant!r}")
        self.norm = norm
        self.quant = quant
        self.num_kp = num_kp
        self.calc_cov = calc_cov
        self.prior_mode = prior_mode
        self.transpose_heatmaps = transpose_heatmaps
        self.backbone = HourglassNet(
            in_features=3 + (num_kp if prior_mode == "concat" else 0),
            num_output=num_kp, n_stack=n_stack, n_modules=n_modules,
            features=features, with_extra=prior_mode == "post_stem",
            extra_features=num_kp, dtype=dtype, norm=norm,
            conv_cls=nn.Conv2d if quant == "off" else partial(q.QuantConv, mode=quant),
        )
        self.classifier = nn.Linear(num_kp, num_kp)

    @property
    def dtype(self) -> torch.dtype:
        """The backbone's working dtype."""
        return self.backbone.dtype

    @property
    def prior_dtype(self) -> torch.dtype:
        """The dtype a prior is rendered in (`render_prior_heatmaps(...,
        dtype=)`) so that the net casts nothing: the working dtype for
        post_stem (the projection reads the prior in it), f32 for concat
        (the prior joins the f32 crops before the backbone's cast)."""
        return self.dtype if self.prior_mode == "post_stem" else torch.float32

    def prior_hw(self, input_hw: tuple[int, int]) -> tuple[int, int]:
        """Resolution the prior heatmaps are rendered at."""
        if self.prior_mode == "concat":
            return tuple(input_hw)
        return (input_hw[0] // 4, input_hw[1] // 4)

    def backbone_logits(self, images_roi: torch.Tensor,
                        prior_kp: torch.Tensor | None = None, train: bool = False,
                        row_mask: torch.Tensor | None = None) -> list:
        """Backbone only: NHWC crops (+ NHWC prior) -> n_stack NHWC logits."""
        n, h, w, c = images_roi.shape
        if c != 3:
            raise ValueError(f"expected an RGB ROI batch, got {tuple(images_roi.shape)}")
        if train and self.quant != "off":
            raise ValueError("quantized modes are inference-only")
        x = _nhwc_to_cl(images_roi)
        if self.prior_mode == "concat":
            if prior_kp is None:
                prior_kp = images_roi.new_zeros((n, h, w, self.num_kp))
            if tuple(prior_kp.shape[1:3]) != (h, w):
                raise ValueError(f"concat prior must be {h}x{w}, got {tuple(prior_kp.shape)}")
            x = torch.cat([x, _nhwc_to_cl(prior_kp.to(x.dtype))], dim=1)
            outs = self.backbone(x.contiguous(memory_format=torch.channels_last),
                                 train=train, row_mask=row_mask)
        else:
            extra = None
            if prior_kp is not None:
                if tuple(prior_kp.shape[1:3]) != (h // 4, w // 4):
                    raise ValueError(f"post_stem prior must be H/4 x W/4, got "
                                     f"{tuple(prior_kp.shape)}")
                extra = _nhwc_to_cl(prior_kp)  # the backbone casts it to its dtype
            outs = self.backbone(x, extra, train=train, row_mask=row_mask)
        return [_nhwc(o) for o in outs]

    def forward(self, images_roi: torch.Tensor, prior_kp: torch.Tensor | None = None,
                train: bool = False, row_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None) -> PkpNetOutput:
        """images_roi [N, H, W, 3] NHWC; prior_kp NHWC at `prior_hw` or None
        (no prior: the statically prior-free program). train: batch
        statistics over the rows `row_mask` [N] bool marks real, and
        dropout (see the module docstring)."""
        outs = self.backbone_logits(images_roi, prior_kp, train, row_mask)
        keep = None
        if train:
            keep = dropout_mask
            if keep is None:
                n, k = images_roi.shape[0], self.num_kp
                keep = torch.rand((n, k), generator=generator, device=images_roi.device) < 0.5
        return self.readout(outs[-1], tuple(outs[:-1]), keep)

    def readout(self, raw: torch.Tensor, aux: tuple = (),
                dropout_keep: torch.Tensor | None = None) -> PkpNetOutput:
        """Heatmap readout (K2) + validity head on NHWC final-stack logits;
        `dropout_keep` [N, K] bool: dropout(0.5) with this keep mask."""
        if self.transpose_heatmaps:
            raw = raw.transpose(1, 2)
        uv, cov, pooled = hm.heatmap_readout(raw)
        y = torch.relu(pooled)
        if dropout_keep is not None:  # flax Dropout: select(keep, y / 0.5, 0)
            y = torch.where(dropout_keep, y / 0.5, torch.zeros((), device=y.device))
        mask_logits = self.classifier(y)
        return PkpNetOutput(
            uv=uv,
            cov=cov if self.calc_cov else None,
            prob_logits=raw,
            kp_mask_logits=mask_logits,
            kp_mask=torch.sigmoid(mask_logits),
            aux_logits=aux,
        )


def _nhwc_to_cl(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory (no copy when x is
    contiguous NHWC)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
