"""Batched ROI crop-and-resize — kernel K1 and its plain version.

Port of `suo_slam_tpu/ops/roi.py`. One bilinear tap at each output-bin
centre, x = x1 + (j + 0.5) * (x2 - x1) / ow, with the sample coordinate
clamped into the image (replicate padding, clamp before the floor — not
torchvision's zero padding) and non-finite coordinates sanitized with
`nan_to_num`; masked box slots come out zero. Coordinates are f32 whatever
the image dtype.

`roi_crop_batch` dispatches on the tensor's device: a CPU tensor takes the
plain version (`roi_crop_batch_plain`, the JAX package's hat-weight matmuls
written in PyTorch); a CUDA tensor launches `csrc/roi_crop.cu` or raises,
on the path and grid `plan_crop` gives.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


class CropPlan(NamedTuple):
    """K1's launch geometry (`csrc/roi_crop.cu`, whose constants it mirrors):
    the path (0 generic, 1 strip), output pixels per thread, block and grid
    dimensions (x, y, z)."""
    path: int
    pixels_per_thread: int
    block: tuple
    grid: tuple


GENERIC, STRIP = 0, 1
GENERIC_THREADS = 256        # kGenericThreads: pixels of one row per block
STRIP_PIXELS, STRIP_WARPS = 128, 8  # kStrip pixels per warp, kStripWarps rows per block
GRID_YZ_MAX = 65535


@functools.lru_cache(maxsize=64)
def plan_crop(n_box: int, oh: int, ow: int, C: int, out_aligned: bool = True,
              path: int | None = None) -> CropPlan:
    """The launch of K1 for n_box = B * O boxes of oh x ow x C outputs. The
    strip path takes C = 3, ow % 4 == 0 and a 16-byte aligned output;
    anything else takes the generic path (`path` forces one, or raises
    where it cannot take the shape). Raises where the grid cannot hold the
    shape."""
    if min(n_box, oh, ow, C) < 1:
        raise ValueError(f"K1 needs boxes and a non-empty output, got {n_box} boxes of "
                         f"{oh}x{ow}x{C}")
    vec = C == 3 and ow % 4 == 0 and out_aligned
    if path is None:
        path = STRIP if vec else GENERIC
    if path == STRIP and not vec:
        raise ValueError(f"K1 path {path} takes C = 3, ow % 4 == 0 and an aligned output, "
                         f"got C = {C}, ow = {ow}, aligned {out_aligned}")
    if path == STRIP:
        plan = CropPlan(STRIP, STRIP_PIXELS // 32, (32 * STRIP_WARPS, 1, 1),
                        (-(-ow // STRIP_PIXELS), -(-oh // STRIP_WARPS), n_box))
    elif path == GENERIC:
        plan = CropPlan(GENERIC, 1, (GENERIC_THREADS, 1, 1),
                        (-(-ow // GENERIC_THREADS), oh, n_box))
    else:
        raise ValueError(f"K1 has no path {path}")
    if max(plan.grid[1:]) > GRID_YZ_MAX:
        raise ValueError(f"K1's grid {plan.grid} exceeds {GRID_YZ_MAX} in y or z "
                         f"({n_box} boxes of {oh} rows)")
    return plan


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _roi_crop_cuda(images, boxes, box_mask, out_hw, path=None):
    """K1: one launch. images [B, H, W, C] f32, boxes [B, O, 4], box_mask
    [B, O] (bool passes as it is; another dtype is converted) on one CUDA
    device; `path` forces a `plan_crop` path. Raises on what the kernel does
    not take; never falls back."""
    oh, ow = out_hw
    if images.dtype != torch.float32 or images.dim() != 4:
        raise ValueError(f"K1 takes a [B,H,W,C] f32 image batch, got "
                         f"{tuple(images.shape)} {images.dtype}")
    B, H, W, C = images.shape
    O = boxes.shape[1] if boxes.dim() == 3 else -1
    if boxes.shape != (B, O, 4) or box_mask.shape != (B, O):
        raise ValueError(f"K1 boxes {tuple(boxes.shape)} / mask "
                         f"{tuple(box_mask.shape)} do not match images {B}")
    d = images.get_device()
    if d < 0 or boxes.get_device() != d or box_mask.get_device() != d:
        raise ValueError("K1 inputs must lie on one CUDA device")
    img = images if images.is_contiguous() else images.contiguous()
    bx = boxes if boxes.dtype == torch.float32 and boxes.is_contiguous() else (
        boxes.to(torch.float32).contiguous())
    pb = bx.data_ptr()
    if pb % 16:  # the strip path reads a box as one 16-byte load
        bx = bx.clone()
        pb = bx.data_ptr()
    # a bool mask is one byte per slot: its storage passes as it is, no launch
    mk = box_mask if box_mask.dtype == torch.bool and box_mask.is_contiguous() else (
        box_mask.to(torch.uint8).contiguous())
    out = img.new_empty((B, O, oh, ow, C))
    po = out.data_ptr()
    plan = plan_crop(B * O, oh, ow, C, po % 16 == 0, path)
    err = _build.entry("roi_crop", _ARGTYPES)(
        img.data_ptr(), pb, mk.data_ptr(), po, B, O, H, W, C, oh, ow, plan.path,
        _build.stream(d))
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
