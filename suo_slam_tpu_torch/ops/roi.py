"""Batched ROI crop-and-resize — kernel K1 and its plain version.

Port of `suo_slam_tpu/ops/roi.py`. One bilinear tap at each output-bin
centre, x = x1 + (j + 0.5) * (x2 - x1) / ow, with the sample coordinate
clamped into the image (replicate padding, clamp before the floor — not
torchvision's zero padding) and non-finite coordinates sanitized with
`nan_to_num`; masked box slots come out zero. Coordinates are f32 whatever
the image dtype.

`roi_crop_batch` dispatches on the tensor's device: a CPU tensor takes the
plain version (`roi_crop_batch_plain`, the JAX package's hat-weight matmuls
written in PyTorch); a CUDA tensor launches `csrc/roi_crop.cu` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..kernels import _build


def _hat_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """[..., n] coords -> [..., n, size] bilinear hat weights
    max(0, 1 - |clip(nan_to_num(c), 0, size-1) - y|)."""
    grid = torch.arange(size, dtype=coords.dtype, device=coords.device)
    c = torch.clamp(torch.nan_to_num(coords), 0.0, float(size - 1))
    return torch.clamp(1.0 - torch.abs(c[..., None] - grid), min=0.0)


def roi_crop_batch_plain(images, boxes, box_mask, out_hw=(256, 256)):
    """Plain PyTorch K1: separable hat-weight contractions (the JAX form).

    images [B, H, W, C] f32, boxes [B, O, 4] xyxy pixels, box_mask [B, O]
    -> [B, O, out_h, out_w, C], in f32 (f64 for f64 images)."""
    oh, ow = out_hw
    H, W = images.shape[1], images.shape[2]
    ft = kernels.plain_dtype(images.dtype)
    boxes = boxes.to(ft)
    x1, y1, x2, y2 = boxes.unbind(-1)  # [B, O]
    jw = torch.arange(ow, dtype=ft, device=boxes.device) + 0.5
    ih = torch.arange(oh, dtype=ft, device=boxes.device) + 0.5
    xs = x1[..., None] + jw * (x2 - x1)[..., None] / ow  # [B, O, ow]
    ys = y1[..., None] + ih * (y2 - y1)[..., None] / oh  # [B, O, oh]
    wy = _hat_weights(ys, H)  # [B, O, oh, H]
    wx = _hat_weights(xs, W)  # [B, O, ow, W]
    img = images.to(ft)
    rows = torch.einsum("boyh,bhwc->boywc", wy, img)
    out = torch.einsum("boxw,boywc->boyxc", wx, rows)
    return out * box_mask[..., None, None, None].to(out.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _roi_crop_cuda(images, boxes, box_mask, out_hw):
    oh, ow = out_hw
    if images.dtype != torch.float32 or images.dim() != 4:
        raise ValueError(f"K1 takes a [B,H,W,C] f32 image batch, got "
                         f"{tuple(images.shape)} {images.dtype}")
    B, H, W, C = images.shape
    if boxes.shape != (B, boxes.shape[1], 4) or box_mask.shape != boxes.shape[:2]:
        raise ValueError(f"K1 boxes {tuple(boxes.shape)} / mask "
                         f"{tuple(box_mask.shape)} do not match images {B}")
    dev = images.device
    if boxes.device != dev or box_mask.device != dev:
        raise ValueError("K1 inputs must lie on one CUDA device")
    O = boxes.shape[1]
    img = images.contiguous()
    bx = boxes.to(torch.float32).contiguous()
    mk = box_mask.to(torch.uint8).contiguous()
    out = torch.empty((B, O, oh, ow, C), dtype=torch.float32, device=dev)
    fn = _build.entry("roi_crop", _ARGTYPES)
    err = fn(_build.ptr(img), _build.ptr(bx), _build.ptr(mk), _build.ptr(out),
             B, O, H, W, C, oh, ow, _build.stream())
    _build.check(err, "K1 roi_crop")
    kernels.count("roi_crop")
    return out


def roi_crop_batch(images, boxes, box_mask, out_hw=(256, 256)):
    """Padded batched ROI extraction.

    images [B, H, W, C], boxes [B, O, 4] (x1, y1, x2, y2) pixels (padding rows
    arbitrary), box_mask [B, O] bool -> [B, O, out_h, out_w, C] f32; masked
    slots are zero. CPU tensors take the plain version, CUDA tensors K1."""
    out_hw = tuple(int(s) for s in out_hw)
    if images.device.type == "cpu":
        return roi_crop_batch_plain(images, boxes, box_mask, out_hw)
    if images.device.type != "cuda":
        raise ValueError(f"roi_crop_batch: unsupported device {images.device}")
    return _roi_crop_cuda(images, boxes, box_mask, out_hw)
