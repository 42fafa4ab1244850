"""Post-training int8 quantized convolutions for the hourglass backbone (B12).

Port of `suo_slam_tpu/models/quant.py`. `QuantConv` is an `nn.Conv2d` (the
same weight and bias, so a float checkpoint loads unchanged) with an
`act_absmax` buffer, the JAX "quant" collection's `act_absmax`, and a mode:

- "calib": records the running abs-max of its input, act_absmax =
  max(act_absmax, max |x|) in f32, then convolves as the float net does
  (`hourglass.float_conv`: cuDNN on the card, as XLA ran the JAX package's
  convolution);
- "int8": the input quantized per tensor with s_x = max(act_absmax, 1e-6) /
  127, codes clip(rint(f32(x) / s_x)) (K12 with `f32_ops`, written
  `CIN_ALIGN`-wide); the weights per output channel, s_w = max(max |w|,
  1e-12) / 127, codes clip(rint(w / s_w)); the exact s8 convolution with the
  f32 epilogue f32(y) * (s_x * s_w) + bias, cast once to the working dtype
  (K11 with `f32_epilogue`). The weight codes, e1 = s_x * s_w and the
  divisor are made with plain torch operations once per update of the
  weights or of act_absmax and kept (JAX recomputes them on every call; the
  values are the same).

`PkpNet(quant="calib" | "int8")` builds every convolution but the f32 heads
as a `QuantConv` (`models/pkpnet.py`); `calibrate(net, batches)` runs the
net in calib mode over some batches and returns it to the mode it had;
`set_mode(net, mode)` switches every `QuantConv` of a net. Inference only.
"""

from __future__ import annotations

import torch
from torch import nn

from . import hourglass as hg
from . import int8_kernels as ik

MODES = ("calib", "int8")


class QuantConv(nn.Conv2d):
    """`nn.Conv2d` with an int8 execution mode (see the module docstring)."""

    def __init__(self, *args, mode: str = "int8", **kw):
        super().__init__(*args, **kw)
        if mode not in MODES:
            raise ValueError(f"unknown QuantConv mode {mode!r}")
        self.mode = mode
        self.register_buffer("act_absmax", torch.zeros(()))
        self._int8 = None

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        # a float checkpoint has no act_absmax: it loads, uncalibrated (0, as
        # the JAX collection's initial value)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)
        if prefix + "act_absmax" in missing_keys:
            missing_keys.remove(prefix + "act_absmax")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "calib":
            with torch.no_grad():
                self.act_absmax.copy_(torch.maximum(self.act_absmax,
                                                    x.abs().amax().to(torch.float32)))
            return hg.float_conv(self, x)
        return self._int8_conv(x)

    def _int8_operands(self, device) -> tuple:
        """(QConv, e1 = s_x * s_w, e2 = bias, divisor s_x [C]) on `device`,
        f32, made once per update of the weights or of act_absmax."""
        key = hg._cache_key(self.weight, self.bias, self.act_absmax) + (device,)
        if self._int8 is None or self._int8[0] != key:
            from .int8_forward import quantize_conv

            with torch.no_grad():
                s_x = torch.clamp(self.act_absmax.detach().to("cpu", torch.float32),
                                  min=1e-6) / 127.0
                qc = quantize_conv(self, 0, device)
                e1 = (s_x * qc.s_w).to(device)
                div = s_x.expand(self.in_channels).contiguous().to(device)
                self._int8 = (key, qc, e1, qc.bias.to(device), div)
        return self._int8[1:]

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"QuantConv: int8 mode takes f32 or bf16 input, got {x.dtype}")
        qc, e1, e2, div = self._int8_operands(x.device)
        xh = x.permute(0, 2, 3, 1)  # channels_last NCHW -> contiguous NHWC
        codes, _ = ik.int8_quant(xh, div, c_out=ik.padded(self.in_channels), f32_ops=True)
        y = ik.int8_conv(codes, qc, e1, e2, f32_epilogue=x.dtype)
        return y.permute(0, 3, 1, 2)


def quant_convs(net: nn.Module) -> list:
    return [m for m in net.modules() if isinstance(m, QuantConv)]


def set_mode(net: nn.Module, mode: str) -> nn.Module:
    """Every `QuantConv` of `net` to `mode` ("calib" or "int8")."""
    if mode not in MODES:
        raise ValueError(f"unknown QuantConv mode {mode!r}")
    for m in quant_convs(net):
        m.mode = mode
    if hasattr(net, "quant"):
        net.quant = mode
    return net


@torch.no_grad()
def calibrate(net: nn.Module, batches, prior_batches=None) -> nn.Module:
    """Run `net` (a `PkpNet(quant=...)`) in calib mode over `batches` (NHWC
    crop tensors; `prior_batches` the priors, none given: the prior-free
    program, which leaves the projection's act_absmax unchanged as JAX's
    all-zero prior does), then return it to its mode. The act_absmax
    buffers keep their running maxima from before the call."""
    convs = quant_convs(net)
    if not convs:
        raise ValueError("calibrate: the net has no QuantConv (build it with quant=...)")
    before = getattr(net, "quant", convs[0].mode)
    set_mode(net, "calib")
    try:
        for i, x in enumerate(batches):
            net(x, None if prior_batches is None else prior_batches[i])
    finally:
        set_mode(net, before)
    return net
