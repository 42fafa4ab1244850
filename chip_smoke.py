"""Chip smoke test of the PyTorch/CUDA port: the single-view frame, SLAM
mode, the evaluation entry point, int8 serving and training of SUO-SLAM on
one NVIDIA GPU, through the entry points a user calls.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: nvidia-smi name and power limit, torch / CUDA versions, the f32
     precision flags;
  2. build: every `suo_slam_tpu_torch/csrc/*.cu` with nvcc (one process per
     source, in parallel) and the seconds it took; the count of IGMMA (s8
     `wgmma`) instructions in K11's SASS, where the toolkit has cuobjdump;
  3. kernels: K1-K10, K14 and K15 against their plain PyTorch versions on the
     same CUDA inputs at the main paths' shapes, with the stated tolerances
     (K14, the whole LM schedule of `ba.optimize` in one launch: one
     iteration against one eager iteration with K4 + K7, which stay off the
     main path; K15, the whole of `pnp_ransac_batch` in one launch: its
     outcome at the front end's shapes and the backup pose's, and its time
     against the K3 + eager-tail schedule it replaced, K3 now off the main
     path too); kernel,
     plain and library times (median of CUDA-event timings; the library
     yardsticks' device time from torch.profiler beside them) and each
     kernel's bound on an H100 (bytes at 3.35 TB/s or f32 operations at
     67 TFLOP/s, counted from this run's inputs); K8 and K9's launches per
     forward of the full-width net; then the full-width net in bf16 against
     the same net in f32 on the card (uv within the bf16 error the CPU shows
     for the same crops), both nets' ms per call on the host clock (with K8 /
     K9 and with their plain versions) and their device ms per call;
  4. the single-view path: full-width PkpNet (2 stacks x 2 modules x 256
     features, 256x256 crops, seeded random weights, non-trivial BatchNorm
     statistics) in `ObjectSlam(single_view_mode=True)` over synthetic
     480x640 views with 8 objects each, `reset()` before every view as
     `evaluate.py --nviews 1` does: per-view latency and per-stage times;
     the launch counters of K1, K2, K14 and K15 must rise (K15 exactly once
     per view: one per `pnp_ransac_batch` call), K3's, K4's and K7's stay 0;
     the stage times split the front end into its sampler,
     `pnp_ransac_batch` and the rest;
     the prior-free network path is
     held against the same net on the CPU for two crops; one more view runs
     under torch.profiler;
  5. solver check: the same engine with an injected ground-truth inference
     (projected keypoints + N(0, 0.005) NDC noise, cov sigma^2 I, validity
     1): ADD < 0.1 diameter for >= 90% of the objects;
  6. the SLAM path: `ObjectSlam(SlamConfig())` in SLAM mode over 22 frames
     of a smooth camera trajectory around the same 8 objects fixed in the
     world, 3 of them symmetric (prior feedback). The full-width net runs on
     every call through `make_frame_inference` — so the symmetric group
     renders its map priors with K5 — and a wrapper then replaces the net's
     uv / cov / validity with the group's projected ground truth plus
     N(0, 0.005) NDC noise: random weights would leave every object
     uninitialised, while these keypoints make PnP, camera RANSAC, late
     init, the priors, re-init and both BAs do real work, as trained
     weights would. The view capacity grows 16 -> 32, global BA runs at
     frames 10 and 20 and in `collect_results(final=True)`. Every counter
     K1, K2, K5, K6, K14 and K15 must rise and K3's, K4's and K7's stay 0
     (K14: one launch per tracking BA and per global BA; K15: one per
     `pnp_ransac_batch` call, two front ends a frame and the backup camera
     poses); the camera trajectory error
     and ADD < 0.1 d for >= 90% of the (frame, object) poses; the
     with-prior program against the CPU for two crops (1e-3); the global
     (V = 32) and tracking BA problems through K14, the eager schedule with
     K4 + K7 and with the plain versions, and f64 on the CPU (`compare_ba`).
     Prints per-frame latency, tracking (K14 and the eager K4 + K7
     schedule) and global BA ms, launches per frame, and a torch.profiler
     summary of one frame with its launches (K14 1, K15 one per
     `pnp_ransac_batch` call, K3, K4 and K7 0, no cholesky), its kernel
     count and device ms beside those before K15, and the sum of its K8 / K9 calls'
     bounds;
  7. the evaluation entry point: a BOP tree written here (one scene of 12
     480x640 views with the YCB-V intrinsics, 8 objects with keypoint
     configs and 6000-point PLY models, PNGs from this script's own writer)
     read by the port's loader and scored by its meter (K10):
     `Evaluator(nviews=-1, debug_gt_kp=True)` must reach AUC of ADD(-S) > 80
     and 100% of camera poses; `Evaluator(nviews=1)` with the full-width
     bf16 net (seeded random weights, passed as `net=`) must run to its end
     and write summary.txt and the BOP CSV. Per-view latency and the K8-K10
     counts of the phase;
  8. int8 serving: the full-width net's s8-resident program
     (`models/int8_forward.py`) calibrated on the card; K11 (every distinct
     convolution shape of the forward, with its real codes and its route —
     wgmma for every stride-1 convolution —, plus the concat stem's 7x7
     stride-2 prior convolution on the mma.sync route), K12 (each mode:
     input dtype or prologue, outputs, padded rows) and K13 (each level)
     bit-equal to their plain versions on the same CUDA inputs, with
     kernel, device, plain, `torch._int_mm` (cuBLASLt s8 GEMM; an im2col of
     the 3x3 input; wrapper and device) times and bounds (int8 operations at
     1,979 TOP/s or bytes at 3.35 TB/s); K2 on the bf16 logits against its
     plain version; launches per forward; the whole int8 net against its
     plain-version run on the card (equal logits) and against the f32 net
     (uv gap within 1.5x the CPU's on the same two crops); the int8 and
     bf16 nets' host and device ms per call and crops/s; the same at 128
     crops (the JAX bench's batch: launches per prior-free forward, K11 and
     K12 bit-equal and timed at every distinct call, device ms per call,
     crops/s and kernels of the int8 and bf16 nets); a scales sidecar written by
     `calibrate_int8` over the phase-7 BOP tree, then `Evaluator(nviews=1,
     int8=True)` to its end; a 6-frame SLAM run with
     `SlamConfig(int8_inference=True, int8_calib_frames=2)` under phase 6's
     ground-truth wrapper (the with-prior int8 program and K5);
  9. training: a `train_real` split (40 480x640 PNG views of 5-8 of the
     eight objects, YCB-V's every-5th cut keeps 8) beside phase 7's test
     split; K16-K19 against their plain versions at the train step's
     full-width shapes (16 rows, 4 padded; f32 and bf16) with kernel,
     device, plain and library times (F.batch_norm + relu forward and
     backward; avg_pool2d; autograd of softmax + einsum) and bytes bounds;
     one full-width train step (2 frames x 16 slots) with the kernels
     against the same step on the plain versions, f32 and bf16 (loss and
     terms, every gradient, the new statistics; gated by the step's own
     sensitivity to 1e-6 input noise); the bf16 step's host and device ms,
     kernels, busy share, peak memory and launches per step (K16 / K17 / K8
     180, K9 / K18 8, K1 / K2 / K5 / K19 1); 30 steps overfitting one batch
     (the loss falls); `python -m suo_slam_tpu_torch.train` in process, full
     width and bf16, 2 epochs x 4 steps + 2 validation batches, its exact
     launches, no plain version on a CUDA tensor, its checkpoints, and a
     second run that auto-resumes at epoch 2; the trained checkpoint through
     `Evaluator(nviews=1)`;
 10. the kernels JSON line (K1-K7's, K14's and K15's launches from the SLAM
     path, K8-K10's from the evaluation phase, K11-K13's from the int8
     phase's evaluation and SLAM runs, K16-K19's from the training CLI), the
     nvidia-smi line, and the last line {"ok": true, "device": {...}}.

The script imports nothing of JAX or of the JAX package; its scenes are made
with numpy from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core operations (data sheet)
H_IMG, W_IMG = 480, 640
YCBV_K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]])
N_OBJ = 8
NK = 41
SINGLE_VIEW_KERNELS = ("roi_crop", "heatmap_readout", "pnp_ransac", "ba_lm")
# K3, K4, K7: checked in phase 3, off the main path (K15 and K14 replaced them)
OFF_PATH_KERNELS = ("pnp_hypotheses", "ba_edges", "ba_schur")
EVAL_KERNELS = ("norm_relu", "upsample_add", "add_dists")  # launches from the evaluation phase
INT8_KERNELS = ("int8_conv", "int8_quant", "int8_pool_junction")  # from the int8 phase
TRAIN_KERNELS = ("bn_stats", "norm_relu_bwd", "upsample_add_bwd",  # from the training phase
                 "heatmap_readout_bwd")


# ----------------------------------------------------------------- helpers --
def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=20, inner=10, warmup=3):
    """Milliseconds per call of `fn`: the median over n runs, each run `inner`
    back-to-back calls bracketed by one pair of CUDA events (so a call's host
    overhead overlaps the previous call's device work). Inputs stay L2-warm."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, ops_per_s: float = F32_FLOP_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class Objects:
    """Eight synthetic objects: 16 of the 41 keypoint channels each, model
    points in a 100 mm cube; objects 1, 4 and 7 are symmetric (the SLAM
    path's prior feedback; single-view mode ignores symmetry)."""

    def __init__(self, rng):
        self.model_kps = np.zeros((N_OBJ, NK, 3), np.float32)
        self.masks = np.zeros((N_OBJ, NK), bool)
        self.diameter = np.zeros((N_OBJ,), np.float32)
        for o in range(N_OBJ):
            ch = rng.choice(NK, 16, replace=False)
            self.masks[o, ch] = True
            self.model_kps[o, ch] = rng.uniform(-50, 50, (16, 3))
            p = self.model_kps[o, ch]
            self.diameter[o] = np.max(np.linalg.norm(p[:, None] - p[None], axis=-1))
        self.is_symmetric = np.zeros((N_OBJ,), bool)
        self.is_symmetric[[0, 3, 6]] = True


def make_view(rng, objs: Objects):
    """One 480x640 view: the eight objects on a 4x2 grid 0.7-0.9 m away.
    Returns (img, T_OtoC [8,4,4], bboxes [8,4], uv_gt [8,41,2] NDC)."""
    img = rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    T = np.tile(np.eye(4), (N_OBJ, 1, 1))
    bboxes = np.zeros((N_OBJ, 4), np.float32)
    uv_gt = np.zeros((N_OBJ, NK, 2), np.float32)
    for o in range(N_OBJ):
        z = rng.uniform(700, 900)
        T[o, :3, :3] = random_rotation(rng)
        T[o, :3, 3] = [(-210 + 140 * (o % 4)) * z / 800, (-80 + 160 * (o // 4)) * z / 800, z]
        p = objs.model_kps[o] @ T[o, :3, :3].T + T[o, :3, 3]
        uvw = p @ YCBV_K.T
        uv = uvw[:, :2] / uvw[:, 2:]
        m = objs.masks[o]
        x1, y1 = uv[m].min(0) - 10
        x2, y2 = uv[m].max(0) + 10
        bboxes[o] = (x1, y1, x2, y2)
        uv_gt[o] = np.stack([2 * (uv[:, 0] - x1) / (x2 - x1) - 1,
                             1 - 2 * (uv[:, 1] - y1) / (y2 - y1)], -1)
    return img, T, bboxes, uv_gt


def full_width_net(seed, dtype=None):
    """PkpNet at full width with seeded random weights and non-trivial
    BatchNorm running statistics, in f32 (default) or `dtype`."""
    import torch

    from suo_slam_tpu_torch.models.hourglass import MaskedBatchNorm
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    torch.manual_seed(seed)
    net = PkpNet(n_stack=2, n_modules=2, features=256, prior_mode="post_stem",
                 dtype=dtype or torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.mean.numel()
                m.mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.var.copy_(torch.rand(c, generator=g) + 0.5)
                m.scale.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return net


# ------------------------------------------------------------------ phases --
def phase_card():
    import torch

    from suo_slam_tpu_torch import _device

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — no result")
    dev = _device.resolve_device("cuda")
    log("[card]", smi_line())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("[card] precision", json.dumps(_device.precision_flags()))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for this slice")
    return dev


def phase_build():
    from suo_slam_tpu_torch.kernels import _build

    secs = _build.build_all()
    log(f"[build] nvcc of {len(_build._sources())} sources: {secs:.2f} s")
    for stem, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {stem}: {line.strip()}")
    # K11's s8 wgmma in the SASS (IGMMA), where the toolkit has cuobjdump
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    lib = _build.BUILD_DIR / "libint8_conv.so"
    if os.path.isfile(tool):
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
        n = sum("IGMMA" in line for line in r.stdout.splitlines())
        log(f"[build] {lib.name}: {n} IGMMA instructions in its SASS (cuobjdump -sass)")
    else:
        log(f"[build] {lib.name}: cuobjdump is missing; its SASS was not read")
    return secs


def _report(name, err, tol, ms, plain_ms, lib_ms, b, lib_fn=None):
    """One kernel line; with `lib_fn`, the library yardstick's device time
    too (`lib_device_us`: its wrapper-free time beside `lib_ms`)."""
    tol = tol if isinstance(tol, str) else f"{tol:.1e}"
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    if lib_fn is not None:
        us, src = lib_device_us(lib_fn)
        lib += f" (device {us:.3f} us by {src})"
    log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms"
        f" | plain {plain_ms:.4f} ms | library {lib} | bound {b[0]:.5f} ms ({b[1]})")


def check_k1(dev, rng, objs):
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.ops import roi

    img, _, bboxes, _ = make_view(rng, objs)
    imgs = torch.from_numpy(img)[None].to(dev)
    boxes = torch.from_numpy(bboxes)[None].to(dev)
    mask = torch.ones((1, N_OBJ), dtype=torch.bool, device=dev)
    out_k = roi._roi_crop_cuda(imgs, boxes, mask, (256, 256))
    out_p = roi.roi_crop_batch_plain(imgs, boxes, mask, (256, 256))
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    tol = 1e-5  # the same two f32 taps; the plain version sums them in matmuls
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: roi._roi_crop_cuda(imgs, boxes, mask, (256, 256)))
    plain_ms = cuda_ms(lambda: roi.roi_crop_batch_plain(imgs, boxes, mask, (256, 256)))
    # library yardstick: grid_sample (bilinear, border padding) on the same boxes
    j = (torch.arange(256, device=dev, dtype=torch.float32) + 0.5) / 256
    bx = boxes[0]
    xs = bx[:, 0:1] + j * (bx[:, 2:3] - bx[:, 0:1])
    ys = bx[:, 1:2] + j * (bx[:, 3:4] - bx[:, 1:2])
    gx = (xs + 0.5) / W_IMG * 2 - 1
    gy = (ys + 0.5) / H_IMG * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(N_OBJ, 256, 256),
                        gy[:, :, None].expand(N_OBJ, 256, 256)], -1)
    nchw = imgs.permute(0, 3, 1, 2).expand(N_OBJ, 3, H_IMG, W_IMG)
    def lib():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    lib_ms = cuda_ms(lib)
    x1 = bboxes[:, 0].clip(0, W_IMG)
    x2 = bboxes[:, 2].clip(0, W_IMG)
    y1 = bboxes[:, 1].clip(0, H_IMG)
    y2 = bboxes[:, 3].clip(0, H_IMG)
    read = min(float(np.sum((x2 - x1 + 2) * (y2 - y1 + 2))), H_IMG * W_IMG) * 3 * 4
    n_out = N_OBJ * 256 * 256
    b = bound(n_out * 3 * 4 + read + bboxes.nbytes + N_OBJ, n_out * 54)
    _report("K1 roi_crop", err, tol, ms, plain_ms, lib_ms, b, lib)
    return dict(name="roi_crop", route="cuda", source="suo_slam_tpu_torch/csrc/roi_crop.cu",
                replaces="suo_slam_tpu/ops/roi.py:84", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k2(dev, rng, net):
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    # the head's layout on the main path: an NHWC view of a channels_last
    # NCHW tensor of logits of the full-width net on 8 random crops
    crops = torch.from_numpy(rng.uniform(0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        raw = net.backbone_logits(crops)[-1]
    assert raw.shape == (N_OBJ, 64, 64, NK)
    uv_k, cov_k, pool_k = hm._heatmap_readout_cuda(raw, 1e-6)
    uv_p, cov_p, pool_p = hm.heatmap_readout_plain(raw, 1e-6)
    torch.cuda.synchronize()
    err = max((uv_k - uv_p).abs().max().item(), (cov_k - cov_p).abs().max().item(),
              (pool_k - pool_p).abs().max().item())
    tol = 1e-5  # f32 moments over 4096 pixels, summed in another order
    if not err <= tol:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: hm._heatmap_readout_cuda(raw, 1e-6))
    plain_ms = cuda_ms(lambda: hm.heatmap_readout_plain(raw, 1e-6))
    u, v = hm.ndc_grid(64, 64, torch.float32, dev)
    feats = torch.stack([u, v, u * u, v * v, u * v], -1).reshape(4096, 5)
    flat = raw.reshape(N_OBJ, 4096, NK)

    def lib():  # softmax + einsum: two PyTorch calls
        return torch.einsum("npk,pf->nkf", torch.softmax(flat, dim=1), feats)

    lib_ms = cuda_ms(lib)
    n = raw.numel()
    b = bound(n * 4 + N_OBJ * NK * (2 + 4 + 1) * 4, n * 24)
    _report("K2 heatmap_readout", err, tol, ms, plain_ms, lib_ms, b, lib)
    return dict(name="heatmap_readout", route="cuda",
                source="suo_slam_tpu_torch/csrc/heatmap_readout.cu",
                replaces="suo_slam_tpu/ops/heatmap.py:56", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k3(dev, rng, objs):
    import torch

    from suo_slam_tpu_torch.slam.engine import _fix_K_np
    from suo_slam_tpu_torch.solvers import pnp

    _, _, bboxes, uv_gt = make_view(rng, objs)
    uv = uv_gt + rng.normal(scale=0.005, size=uv_gt.shape).astype(np.float32)
    k4 = np.zeros((N_OBJ, 4), np.float32)
    for o in range(N_OBJ):
        K = _fix_K_np(YCBV_K, bboxes[o])
        k4[o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    y = (uv - k4[:, None, 2:]) / k4[:, None, :2]
    x = torch.from_numpy(objs.model_kps).to(dev)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)
    mask = torch.from_numpy(objs.masks).to(dev)
    xp, _, _ = pnp._precondition(x, mask)
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = pnp.sample_hypothesis_indices(mask, 64, gen)
    thr = pnp.DEFAULT_THRESHOLD ** 2
    Tk, okk, ck = pnp._pnp_hypotheses_cuda(xp, yt, mask, idx, thr)
    Tp, okp, cp = pnp.pnp_hypotheses_plain(xp, yt, mask, idx, thr)
    torch.cuda.synchronize()
    both = okk & okp
    err = (Tk - Tp).abs().amax(dim=(-2, -1))[both].max().item() if both.any() else 0.0
    # ok flags and inlier counts must be equal: one hypothesis that flips
    # changes the argmax and the PnP pose
    flag_diff = int((okk != okp).sum())
    count_diff = int((ck != cp).sum())
    tol = 1e-4  # same scalar arithmetic in the same order, --fmad=false
    log(f"[kernel] K3 disagreements: ok flags {flag_diff}, inlier counts {count_diff} "
        f"of {okk.numel()} hypotheses; {int(okk.sum())} solved, "
        f"best counts {ck.amax(-1).tolist()}")
    if not (err <= tol and flag_diff == 0 and count_diff == 0):
        raise AssertionError(f"K3 disagrees with its plain version: T err {err}, "
                             f"flags {flag_diff}, counts {count_diff}")
    ms = cuda_ms(lambda: pnp._pnp_hypotheses_cuda(xp, yt, mask, idx, thr))
    plain_ms = cuda_ms(lambda: pnp.pnp_hypotheses_plain(xp, yt, mask, idx, thr), inner=1,
                       warmup=1)
    O, H, N = N_OBJ, 64, NK
    # per hypothesis ~2,800 f32 ops of P3P/P4P (counted from
    # csrc/pnp_hypotheses.cu: 50 cubic Newton steps, 4 x 5 lambda refines,
    # eig, recovery, 4th-point scoring) + ~18 per point of inlier counting
    b = bound(O * N * (12 + 8 + 1) + O * H * 16 + O * H * (64 + 1 + 4),
              O * H * (2800 + 18 * N))
    _report("K3 pnp_hypotheses", err, tol, ms, plain_ms, None, b)
    return dict(name="pnp_hypotheses", route="cuda",
                source="suo_slam_tpu_torch/csrc/pnp_hypotheses.cu",
                replaces="suo_slam_tpu/solvers/p3p.py:289", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def _ba_problem(dev, rng, objs, V=16, obj_noise=5.0, cam_noise=0.0):
    """The engine's single-view BA problem: capacity V x 8 x 41, one active
    view, objects at poses perturbed by N(0, obj_noise) mm (the camera by
    N(0, cam_noise) mm), NDC measurements with info 1e4 I."""
    import torch

    from suo_slam_tpu_torch.slam.engine import _fix_K_np
    from suo_slam_tpu_torch.solvers import ba

    _, T, bboxes, uv_gt = make_view(rng, objs)
    uv = np.zeros((V, N_OBJ, NK, 2), np.float32)
    uv[0] = uv_gt + rng.normal(scale=0.005, size=uv_gt.shape)
    info = np.zeros((V, N_OBJ, NK, 2, 2), np.float32)
    info[0] = np.eye(2) * 1e4
    k4 = np.zeros((V, N_OBJ, 4), np.float32)
    for o in range(N_OBJ):
        K = _fix_K_np(YCBV_K, bboxes[o])
        k4[0, o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    valid = np.zeros((V, N_OBJ, NK), bool)
    valid[0] = objs.masks
    obj_T = T.copy()
    obj_T[:, :3, 3] += rng.normal(scale=obj_noise, size=(N_OBJ, 3))
    cam_T = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    cam_T[0, :3, 3] += rng.normal(scale=cam_noise, size=3)
    cam_active = np.zeros((V,), bool)
    cam_active[0] = True
    t = lambda a: torch.as_tensor(a).to(dev)
    return ba.BAProblem(
        cam_T=t(cam_T), obj_T=t(obj_T.astype(np.float32)), uv=t(uv), info=t(info),
        model_kp=t(objs.model_kps), cam_k=t(k4), valid=t(valid), inliers=t(valid),
        cam_active=t(cam_active), obj_active=t(np.ones((N_OBJ,), bool)),
    )


def k4_scaled_errors(H, g, Hp, gp, chi2p, inl, huber_d):
    """The largest errors of K4's H [.., 12, 12] and g [.., 12] against the
    plain Hp, gp, each entry over its Cauchy-Schwarz scale: sqrt(H_ii H_jj)
    for H_ij and sqrt(H_ii sum_k w_k chi2_k) for g_i (w the inlier-masked
    Huber weight of the plain chi2p [.., K]). With a diagonal information
    that scale bounds the sum of the entry's absolute terms, so f32
    rounding stays a few hundred ulps of it whatever the entry's own size.
    An entry whose scale is 0 must be exactly 0."""
    import torch

    d = Hp.double().diagonal(dim1=-2, dim2=-1).abs()
    c2 = chi2p.double()
    w = inl.double() * torch.where(c2 <= huber_d ** 2, 1.0,
                                   huber_d / c2.clamp(min=1e-30).sqrt())
    s_H = torch.sqrt(d[..., :, None] * d[..., None, :])
    s_g = torch.sqrt(d * (w * c2).sum(-1, keepdim=True))

    def worst(a, b, s):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return math.inf
        e = (a.double() - b.double()).abs()
        r = torch.where(s > 0, e / s.clamp(min=1e-300), torch.where(e > 0, math.inf, 0.0))
        return r.max().item()

    return worst(H, Hp, s_H), worst(g, gp, s_g)


def check_k4(dev, rng, objs):
    import torch

    from suo_slam_tpu_torch.solvers import ba

    p = _ba_problem(dev, rng, objs)
    args = (p.cam_T, p.obj_T, p.uv, p.info, p.model_kp, p.cam_k)
    d = ba.HUBER_DELTA
    Hk, gk, ck, zk = ba._ba_edges_cuda(*args, p.valid, True, d, want_hg=True)
    Hp, gp, cp, zp = ba._edge_planes_Hg_plain(*args, p.valid, True, d)
    c2k = ba._ba_edges_cuda(*args, None, False, 0.0, want_hg=False)[2]
    c2p = ba._edge_chi2_plain(*args)
    torch.cuda.synchronize()
    # 82-term f32 sums in another order. H's entries span ~9 decades, so each
    # H and g entry is held to 1e-4 of its own Cauchy-Schwarz scale; the
    # per-edge chi2 and z to 1e-4 of their largest magnitude
    tol_rel = 1e-4
    sH, sg = k4_scaled_errors(Hk, gk, Hp, gp, cp, p.valid, d)
    pairs = dict(chi2=(ck, cp), chi2_mode=(c2k, c2p), z=(zk, zp))
    errs = {k: (a - b).abs().max().item() for k, (a, b) in pairs.items()}
    tols = {k: tol_rel * b.abs().max().item() for k, (_, b) in pairs.items()}
    errs.update(H_scaled=sH, g_scaled=sg)
    tols.update(H_scaled=tol_rel, g_scaled=tol_rel)
    log("[kernel] K4 err / tol per output "
        + json.dumps({k: f"{errs[k]:.3e} / {tols[k]:.3e}" for k in errs}))
    if not all(errs[k] <= tols[k] for k in errs):
        raise AssertionError(f"K4 disagrees with its plain version: {errs} vs {tols}")
    err, tol = (Hk - Hp).abs().max().item(), "1e-4 of each entry's scale"
    inl = p.valid
    ms = cuda_ms(lambda: ba._ba_edges_cuda(*args, inl, True, d, want_hg=True))
    plain_ms = cuda_ms(lambda: ba._edge_planes_Hg_plain(*args, inl, True, d))
    ms_chi2 = cuda_ms(lambda: ba._ba_edges_cuda(*args, None, False, 0.0, want_hg=False))
    plain_chi2 = cuda_ms(lambda: ba._edge_chi2_plain(*args))
    V, O, K = p.uv.shape[:3]
    # the H/g contraction alone as one bmm: the library yardstick
    JW = torch.randn(V * O, 12, 2 * K, device=dev)
    J = torch.randn(V * O, 2 * K, 12, device=dev)
    lib = lambda: torch.bmm(JW, J)
    lib_ms = cuda_ms(lib)
    e = V * O * K
    in_bytes = V * 64 + O * 64 + e * (8 + 16 + 1) + O * K * 12 + V * O * 16
    out_bytes = V * O * (144 + 12) * 4 + e * 8
    # ~200 f32 ops per edge (projection, residual, chi2, Huber, 2x12 J,
    # weighting) + 156 outputs x 2K products x 2 per (v, o)
    b = bound(in_bytes + out_bytes, e * 200 + V * O * 156 * 2 * K * 2)
    b_chi2 = bound(in_bytes - e + e * 8, e * 45)
    _report("K4 ba_edges (H/g mode, H)", err, tol, ms, plain_ms, lib_ms, b, lib)
    log(f"[kernel] K4 ba_edges (chi2 mode): kernel {ms_chi2:.4f} ms | plain "
        f"{plain_chi2:.4f} ms | bound {b_chi2[0]:.5f} ms ({b_chi2[1]})")
    return dict(name="ba_edges", route="cuda", source="suo_slam_tpu_torch/csrc/ba_edges.cu",
                replaces="suo_slam_tpu/solvers/ba.py:130", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k5(dev, rng):
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    # the SLAM path's symmetric group: 3 objects in a bucket of 4 crops,
    # post_stem priors at 64x64, about half the channels valid
    ob, hw = 4, (64, 64)
    uv = torch.from_numpy(rng.uniform(-1.1, 1.1, (ob, NK, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(size=(ob, NK)) < 0.4).to(dev)
    mask[3] = False  # the padded slot
    sigma = hm.prior_sigma_for(hw)
    out_k = hm._render_prior_cuda(uv, mask, hw, sigma)
    out_p = hm.render_prior_heatmaps_plain(uv, mask, hw, sigma)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    tol = 1e-6  # the same f32 Gaussian of values in [0, 1]
    if not (err <= tol and out_k.is_contiguous()):
        raise AssertionError(f"K5 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: hm._render_prior_cuda(uv, mask, hw, sigma))
    plain_ms = cuda_ms(lambda: hm.render_prior_heatmaps_plain(uv, mask, hw, sigma))
    n_out = out_k.numel()
    # ~20 f32 operations per output (2 sub, 2 div, 3 mul, 1 add, the exp)
    b = bound(n_out * 4 + ob * NK * 9, n_out * 20)
    _report("K5 prior_render", err, tol, ms, plain_ms, None, b)
    return dict(name="prior_render", route="cuda",
                source="suo_slam_tpu_torch/csrc/prior_render.cu",
                replaces="suo_slam_tpu/ops/heatmap.py:167", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def _k6_inputs(dev, rng, objs, S, M):
    """S pose sets of the 8 objects near their true camera-frame poses and M
    rows of noisy detections, info (1/0.005^2) I."""
    import torch

    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.slam.engine import _fix_K_np

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    rows = [make_view(rng, objs) for _ in range(M)]
    k4 = np.zeros((M, N_OBJ, 4), np.float32)
    for m, (_, _, bb, _) in enumerate(rows):
        for o in range(N_OBJ):
            K = _fix_K_np(YCBV_K, bb[o])
            k4[m, o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    T = np.stack([rows[s % M][1] for s in range(S)])
    # pose sets 0.2-1.5 mm and ~1 mrad off: counts from most to few edges
    scale = np.array([0.001] * 3 + [0.2] * 3) * (1 + np.arange(S) % 8)[:, None, None]
    jitter = lie.se3_exp(t(rng.normal(size=(S, N_OBJ, 6)) * scale))
    T_sets = (jitter @ t(T)).contiguous()
    uv = np.stack([r[3] for r in rows]) + rng.normal(scale=0.005, size=(M, N_OBJ, NK, 2))
    info = np.broadcast_to(np.eye(2) / 0.005 ** 2, (M, N_OBJ, NK, 2, 2))
    mask = np.broadcast_to(objs.masks, (M, N_OBJ, NK)) & (rng.uniform(size=(M, N_OBJ, NK)) < 0.9)
    return (T_sets, t(objs.model_kps), t(uv), t(info),
            torch.from_numpy(np.ascontiguousarray(mask)).to(dev), t(k4))


def check_k6(dev, rng, objs):
    import torch

    from suo_slam_tpu_torch.slam import kernels as sk

    # camera RANSAC: H = 8 hypotheses x 8 objects x 41 keypoints of one
    # frame; re-init: the PnP and map poses over the 15-view window
    cases = {"ransac": (_k6_inputs(dev, rng, objs, N_OBJ, 1), False),
             "reinit": (_k6_inputs(dev, rng, objs, 30, 15), True)}
    res = {}
    for name, (args, per_obj) in cases.items():
        ck = sk._chi2_counts_cuda(*args, 5.991, per_obj)
        cp = sk.chi2_counts_plain(*args, 5.991, per_obj)
        torch.cuda.synchronize()
        diff = int((ck != cp).sum())
        log(f"[kernel] K6 {name}: counts {ck.flatten().tolist()[:16]} ... "
            f"({diff} of {ck.numel()} differ)")
        if diff:
            raise AssertionError(f"K6 {name} counts differ from the plain version: "
                                 f"{ck.tolist()} vs {cp.tolist()}")
        S, O, K, M = args[0].shape[0], N_OBJ, NK, args[2].shape[0]
        ms = cuda_ms(lambda: sk._chi2_counts_cuda(*args, 5.991, per_obj))
        plain_ms = cuda_ms(lambda: sk.chi2_counts_plain(*args, 5.991, per_obj))
        # ~45 f32 operations per edge: the pose (18), the projection (8),
        # the residual and chi2 (11), the tests and the sum
        b = bound(S * O * 64 + O * K * 12 + M * O * K * (8 + 16 + 1) + M * O * 16
                  + (S // M if per_obj else S) * (O if per_obj else 1) * 4, S * O * K * 45)
        res[name] = (ms, plain_ms, b)
        _report(f"K6 chi2_counts ({name})", 0.0, "exact", ms, plain_ms, None, b)
    ms, plain_ms, b = res["ransac"]
    return dict(name="chi2_counts", route="cuda", source="suo_slam_tpu_torch/csrc/chi2_counts.cu",
                replaces="suo_slam_tpu/slam/kernels.py:116", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def k7_scaled_errors(k, p):
    """The largest errors of K7's (d_cam, d_obj) against the plain ones, each
    entry over the largest |entry| of the plain version's 6-vector block
    (one camera's or one object's step); in a block that is exactly 0 every
    entry must be 0."""
    import torch

    def worst(a, b):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return math.inf
        e = (a.double() - b.double()).abs()
        s = b.double().abs().amax(-1, keepdim=True)
        r = torch.where(s > 0, e / s.clamp(min=1e-300), torch.where(e > 0, math.inf, 0.0))
        return r.max().item() if r.numel() else 0.0

    return worst(k[0], p[0]), worst(k[1], p[1])


def _normal_equations(dev, scene, V):
    """The global BA's normal-equation blocks at the SLAM path's shapes:
    V view slots (the first n active), 8 objects, 41 keypoints, noisy
    measurements and perturbed poses, through the plain K4."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    rng = np.random.default_rng(5)
    n = min(V, len(scene.cams))
    uv = np.zeros((V, N_OBJ, NK, 2), np.float32)
    k4 = np.zeros((V, N_OBJ, 4), np.float32)
    valid = np.zeros((V, N_OBJ, NK), bool)
    for v in range(n):
        _, bb, uvs = scene.frame(v)
        uv[v] = uvs + rng.normal(scale=0.005, size=uvs.shape)
        k4[v] = scene.k4(bb)
        valid[v] = scene.objs.masks
    cam_T = np.tile(np.eye(4), (V, 1, 1))
    cam_T[:n] = scene.cams[:n]
    cam_T[1:n, :3, 3] += rng.normal(scale=2.0, size=(n - 1, 3))
    obj_T = scene.T_obj.copy()
    obj_T[:, :3, 3] += rng.normal(scale=2.0, size=(N_OBJ, 3))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    info = t(np.broadcast_to(np.eye(2) / 0.005 ** 2, (V, N_OBJ, NK, 2, 2)))
    inl = torch.from_numpy(valid).to(dev)
    H, g, _, _ = ba._edge_planes_Hg_plain(t(cam_T), t(obj_T), t(uv), info, t(scene.objs.model_kps),
                                          t(k4), inl, True, ba.HUBER_DELTA)
    blocks = (H[..., :6, :6].sum(1), H[..., 6:, 6:].sum(0), H[..., :6, 6:].contiguous(),
              g[..., :6].sum(1), g[..., 6:].sum(0))
    cam_free = torch.zeros(V, dtype=torch.bool, device=dev)
    cam_free[1:n] = True
    return blocks, cam_free, torch.ones(N_OBJ, dtype=torch.bool, device=dev)


def check_k7(dev, scene):
    """K7 on the SLAM path's normal equations (global V = 32 and tracking
    V = 1). Gate 1: each entry within 1e-4 of its plain 6-block's largest
    |entry|, ok flags equal, at LM damping 1e-2: there a 1e-7 relative
    perturbation of the f32 inputs moves the solution by ~3e-5 of that
    scale (measured on the CPU), so 1e-4 measures the kernel. At the
    engine's first damping 1e-5 the global system is ill-conditioned: the
    same perturbation moves it by ~1e-2, for any f32 solve. Gate 2, at
    1e-5: K7's error against the plain solve in f64 at most twice the plain
    f32 solve's (or 1e-4)."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    cases = {}
    blocks, cam_free, obj_free = _normal_equations(dev, scene, 32)
    cases["global"] = (blocks, cam_free, obj_free, False)
    tb, tcf, _ = _normal_equations(dev, scene, 1)
    tcf[0] = True
    cases["tracking"] = (tb, tcf, torch.zeros(N_OBJ, dtype=torch.bool, device=dev), True)
    res = {}
    for name, (bl, cf, of, frozen) in cases.items():
        lam = torch.tensor(1e-2, device=dev)
        k = ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam, frozen)
        p = ba._solve_normal_eq_schur_plain(*bl, cf, of, lam)
        lam5 = torch.tensor(1e-5, device=dev)
        k5 = ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam5, frozen)
        p5 = ba._solve_normal_eq_schur_plain(*bl, cf, of, lam5)
        r64 = ba._solve_normal_eq_schur_plain(*[b.double() for b in bl], cf, of,
                                              lam5.double())
        r64 = (r64[0].float(), r64[1].float())
        torch.cuda.synchronize()
        sc, so = k7_scaled_errors(k, p)
        err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
        ek, ep = max(k7_scaled_errors(k5, r64)), max(k7_scaled_errors(p5, r64))
        log(f"[kernel] K7 {name}: ok {bool(k[2])}/{bool(p[2])}, scaled errors d_cam {sc:.3e} "
            f"d_obj {so:.3e} (tol 1e-4, damping 1e-2), max abs {err:.3e}, max |d_cam| "
            f"{p[0].abs().max().item():.3e}; at damping 1e-5 against the f64 solve: "
            f"K7 {ek:.3e}, plain {ep:.3e}")
        if not (bool(k[2]) == bool(p[2]) and bool(p[2]) and max(sc, so) <= 1e-4
                and bool(k5[2]) == bool(p5[2]) and ek <= max(2 * ep, 1e-4)):
            raise AssertionError(f"K7 {name} disagrees with its plain version: {sc}, {so}, "
                                 f"{ek} vs {ep}")
        # the same blocks with one camera block not positive definite:
        # a NaN factor -> zero steps and ok False, no raise
        bad = bl[0].clone()
        bad[0] = -torch.eye(6, device=dev)
        cf_bad = cf.clone()
        cf_bad[0] = True
        kb = ba._solve_normal_eq_schur_cuda(bad, *bl[1:], cf_bad, of, lam, frozen)
        pb = ba._solve_normal_eq_schur_plain(bad, *bl[1:], cf_bad, of, lam)
        if bool(kb[2]) or bool(pb[2]) or kb[0].any() or kb[1].any():
            raise AssertionError(f"K7 {name}: a non-PD camera block must give ok False")
        ms = cuda_ms(lambda: ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam, frozen))
        plain_ms = cuda_ms(lambda: ba._solve_normal_eq_schur_plain(*bl, cf, of, lam))
        V, O = bl[2].shape[:2]
        Hcc = bl[0]

        def lib():  # the camera blocks' factor and the two triangular solves
            L, _ = torch.linalg.cholesky_ex(Hcc)
            rhs = torch.cat([bl[2].permute(0, 2, 1, 3).reshape(V, 6, 6 * O), bl[3][..., None]], -1)
            half = torch.linalg.solve_triangular(L, rhs, upper=False)
            return torch.linalg.solve_triangular(L.transpose(-1, -2), half, upper=True)

        lib_ms = cuda_ms(lib)
        n_o = 0 if frozen else 6 * O
        flops = V * (300 + (n_o + 1) * 80) + (n_o * n_o + n_o) * V * 12 + n_o ** 3 // 3 \
            + 2 * n_o * n_o + V * (12 * n_o + 80)
        b = bound(V * 144 + O * 144 + V * O * 144 + V * 24 + O * 24 + V + O + 4
                  + V * 24 + O * 24 + 1, flops)
        res[name] = (max(sc, so), ms, plain_ms, lib_ms, b)
        _report(f"K7 ba_schur ({name}, V={V})", max(sc, so), "1e-4 of each 6-block's max",
                ms, plain_ms, lib_ms, b, lib)
    err, ms, plain_ms, lib_ms, b = res["global"]
    return dict(name="ba_schur", route="cuda", source="suo_slam_tpu_torch/csrc/ba_schur.cu",
                replaces="suo_slam_tpu/solvers/ba.py:267", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def _steps(r, p):
    """The f64 left steps log(T_out T_in^-1) of a BA result's cameras and
    objects against its problem's poses."""
    from suo_slam_tpu_torch.core import lie

    d = lambda a, b: lie.se3_log(a.double() @ lie.invert_SE3(b.double()))
    return d(r.cam_T, p.cam_T), d(r.obj_T, p.obj_T)


def lm_bound(p, iters, tracking):
    """K14's bound for one call on problem p that ran `iters` LM iterations
    per round: each input read once and each output written once, against
    the f32 operations of this run's iterations, rounds and classifications.
    Per edge and iteration: ~130 for the projection, chi2, Huber weight,
    Jacobian and weighted rows, 4 per H / g sum (27 tracking, 90 global),
    ~45 for the trial chi2; the Schur solve as K7 counts it (its 6x6
    factors, column solves, reduction to S, S's factor and back-substitution);
    ~45 per edge for each classification."""
    V, O, K = p.valid.shape
    E, R = V * O * K, len(iters)
    n_it, n_rnd = sum(iters), sum(1 for i in iters if i > 0)
    n_o = 0 if tracking else 6 * O
    solve = V * (300 + (n_o + 1) * 80) + (n_o * n_o + n_o) * V * 12 + n_o ** 3 // 3 \
        + 2 * n_o * n_o + V * (12 * n_o + 80) + (V + O) * 150
    per_it = E * (130 + 4 * (27 if tracking else 90) + 45) + solve
    flops = n_it * per_it + (n_rnd + 2) * E * 45 + n_rnd * (V + O) * 100
    in_bytes = V * 64 + O * 64 + E * (8 + 16 + 1) + O * K * 12 + V * O * 16 + 2 * (V + O)
    out_bytes = V * 64 + O * 64 + E + 8 * (1 + R) + 4
    return bound(in_bytes + out_bytes, flops)


def k14_first_step(p):
    """One iteration of one round of K14 on problem p (objects free, every
    valid edge an inlier to start with, the first camera the gauge) against
    one eager iteration with K4 + K7 from the same damping 1e-5, each step
    (the f64 log of T_out T_in^-1) measured against the f64 step of the
    plain schedule on the CPU in units of its 6-block's largest |entry|.
    Raises unless K14's error is at most twice K4 + K7's (or 1e-4: K7's gate
    at this damping, where the f32 step of a single-view problem moves by
    ~3e-4 of its scale under another summation order), the inlier masks are
    equal and each ran one iteration. Returns K14's error."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    one = dict(iters_per_round=(1,), tracking_only=False, fix_first_cam=True,
               init_with_outliers=True)
    rk, itk = ba._ba_lm_cuda(p, **one)
    re, ite = ba._optimize_eager(p, use_kernels=True, **one)
    torch.cuda.synchronize()
    p64 = ba.BAProblem(*[None if a is None else a.cpu().double() if a.is_floating_point()
                         else a.cpu() for a in p])
    s64 = _steps(ba._optimize_eager(p64, **one)[0], p64)
    sk, se = _steps(rk, p), _steps(re, p)
    s64 = tuple(a.to(sk[0].device) for a in s64)
    ek, ee = max(k7_scaled_errors(sk, s64)), max(k7_scaled_errors(se, s64))
    same = torch.equal(rk.inliers, re.inliers)
    log(f"[kernel] K14 one iteration (V={p.uv.shape[0]}): scaled step errors against the f64 "
        f"step K14 {ek:.3e}, eager K4 + K7 {ee:.3e} (gate: K14 <= max(2 x K4 + K7, 1e-4)); "
        f"K14 against K4 + K7 {max(k7_scaled_errors(sk, se)):.3e}; max |d_obj| "
        f"{s64[1].abs().max().item():.3e}; inliers equal {same}; iterations {itk.tolist()} / "
        f"{ite}")
    if not (ek <= max(2 * ee, 1e-4) and same and itk.tolist() == [1] and ite == [1]
            and s64[1].abs().max().item() > 0):
        raise AssertionError(f"K14's first iteration disagrees with K4 + K7: {ek} vs {ee}, {same}")
    return ek


def check_k14(dev, rng, objs):
    """K14, the whole LM schedule in one launch. Gate: `k14_first_step` on
    the engine's single-view problem (V = 16, objects 5 mm off). Timed on
    the tracking problem (V = 1, every object fixed, the camera 0.3 mm off,
    rounds (10, 10, 10, 10)): K14, the eager schedule with its plain
    versions (plain ms) and with K4 + K7 (the schedule K14 replaced), device
    time per call and per iteration."""
    from suo_slam_tpu_torch.solvers import ba

    err = k14_first_step(_ba_problem(dev, rng, objs))
    pt = _ba_problem(dev, rng, objs, V=1, obj_noise=0.0, cam_noise=0.3)
    trk = dict(iters_per_round=(10, 10, 10, 10), tracking_only=True, fix_first_cam=False)
    _, it_t = ba._ba_lm_cuda(pt, **trk)
    it_t = it_t.tolist()
    ms = cuda_ms(lambda: ba._ba_lm_cuda(pt, **trk))
    plain_ms = cuda_ms(lambda: ba._optimize_eager(pt, **trk), n=3, inner=2, warmup=1)
    eager_ms = cuda_ms(lambda: ba._optimize_eager(pt, use_kernels=True, **trk), n=3, inner=2,
                       warmup=1)
    us, src = device_us(lambda: ba._ba_lm_cuda(pt, **trk), "ba_lm_kernel")
    b = lm_bound(pt, it_t, True)
    _report(f"K14 ba_lm (tracking V=1, iterations {it_t}, device {us:.3f} us by {src}, "
            f"{us / max(1, sum(it_t)):.3f} us per iteration; the eager K4 + K7 schedule "
            f"{eager_ms:.4f} ms)", err, "2x K4 + K7's scaled step error (one iteration)", ms,
            plain_ms, None, b)
    return dict(name="ba_lm", route="cuda", source="suo_slam_tpu_torch/csrc/ba_lm.cu",
                replaces="suo_slam_tpu/solvers/ba.py:456", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def pnp_inputs(dev, rng, O=N_OBJ, N=NK, n_hyp=64):
    """A PnP batch at the front end's shapes: O objects of N model points in
    a 100 mm cube 700-900 mm away, their normalized image points with
    N(0, 3e-4) noise (~0.3 px, the NDC noise of the SLAM phase), 80% valid,
    5 gross outliers each (0.02-0.1 off); object O-2 has 3 valid points and
    object O-1 every point at one place (every hypothesis fails).
    Returns x, y, mask and the sampler's idx on dev."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    x = rng.uniform(-50, 50, (O, N, 3))
    y = np.zeros((O, N, 2))
    for o in range(O):
        p = x[o] @ random_rotation(rng).T + [rng.uniform(-200, 200), rng.uniform(-150, 150),
                                             rng.uniform(700, 900)]
        y[o] = p[:, :2] / p[:, 2:] + rng.normal(scale=3e-4, size=(N, 2))
    y[:, :5] += rng.uniform(0.02, 0.1, (O, 5, 2)) * rng.choice([-1, 1], (O, 5, 2))
    mask = rng.uniform(size=(O, N)) < 0.8
    mask[O - 2] = False
    mask[O - 2, 10:13] = True
    x[O - 1] = x[O - 1, :1]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    mk = t(mask, torch.bool)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return t(x), t(y), mk, pnp.sample_hypothesis_indices(mk, n_hyp, gen)


def backup_inputs(dev, rng):
    """The backup camera pose's PnP (`engine._backup_estimate_camera_pose`):
    one set of 8 mapped object centres (+-300 mm, the camera 1 m away), their
    bbox centroids with N(0, 3e-4) noise, one 0.05 off, 128 hypotheses."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    x = np.concatenate([rng.uniform(-300, 300, (8, 2)), rng.uniform(-100, 100, (8, 1))], -1)
    p = x @ random_rotation(rng).T + [30.0, -40.0, 1000.0]
    y = p[:, :2] / p[:, 2:] + rng.normal(scale=3e-4, size=(8, 2))
    y[6] += 0.05
    t = lambda a: torch.from_numpy(a[None].astype(np.float32)).to(dev)
    mask = torch.ones((1, 8), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return t(x), t(y), mask, pnp.sample_hypothesis_indices(mask, pnp.DEFAULT_HYPOTHESES, gen)


def k15_gate(label, x, y, mask, idx, refine=True):
    """K15 against `pnp_ransac_batch_plain` on the same CUDA inputs. The
    outcome, not the bits (their sums run in other orders, so the accept
    test, the reselection and the keep gate can flip at their edges):
    success equal; poses within 1e-4 (rotation absolute, translation
    relative to its norm, at least 1); inlier masks equal except points
    whose squared error under the plain pose lies within 1e-3 relative of
    the threshold, each printed with its margin; each count that of its own
    mask. Returns (the pose error, the flipped points)."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    rk = pnp._pnp_ransac_cuda(x, y, mask, idx, refine=refine)
    rp = pnp.pnp_ransac_batch_plain(x, y, mask, idx, refine=refine)
    torch.cuda.synchronize()
    thr = pnp.DEFAULT_THRESHOLD ** 2
    err_p, _ = pnp._reproj_sq_err(rp.T, x, y)
    margin = ((err_p - thr).abs() / thr).cpu()
    flips = (rk.inliers != rp.inliers).nonzero().tolist()
    margins = [float(margin[tuple(f)]) for f in flips]
    Tk, Tp = rk.T.double().cpu(), rp.T.double().cpu()
    rot = (Tk[:, :3, :3] - Tp[:, :3, :3]).abs().max().item()
    tn = Tp[:, :3, 3].norm(dim=-1).clamp(min=1.0)
    rel = ((Tk[:, :3, 3] - Tp[:, :3, 3]).abs().amax(-1) / tn).max().item()
    own = torch.equal(rk.num_inliers, rk.inliers.sum(-1)) and rk.num_inliers.dtype == torch.int64
    log(f"[kernel] {label}: success {rk.success.int().tolist()} (plain "
        f"{rp.success.int().tolist()}), inliers {rk.num_inliers.tolist()} (plain "
        f"{rp.num_inliers.tolist()}); pose error rotation {rot:.3e}, translation {rel:.3e} "
        f"relative (tol 1e-4); {len(flips)} flipped inlier points (o, n) {flips[:8]} with "
        f"margins {[round(m, 6) for m in margins[:8]]} (allowed <= 1e-3)")
    if not (torch.equal(rk.success, rp.success) and max(rot, rel) <= 1e-4 and own
            and all(m <= 1e-3 for m in margins)):
        raise AssertionError(f"{label}: K15 disagrees with its plain version")
    return max(rot, rel), flips


def k15_bound(O, N, H, n_refined):
    """K15's bound for one call: each input read once (x, y, mask, the int64
    indices), each output written once, against the f32 operations this
    run's data needs: every hypothesis as K3 counts it (~2,800 for P3P /
    P4P, ~18 per point of counting), the preconditioning (~12 per point),
    and for each of the n_refined objects that refine 2 rounds of a
    reselection (~25 per point) and 8 Gauss-Newton iterations (~194 per
    point: projection, Jacobian, 27 weighted H / g sums, the cost and the
    trial cost; ~400 for the 6x6 solve and the exponential), the keep
    gate's count, then the final pass (~25 per point)."""
    flops = (O * H * (2800 + 18 * N) + O * N * (12 + 25)
             + n_refined * (2 * (25 * N + 8 * (194 * N + 400)) + 25 * N))
    nbytes = O * N * (12 + 8 + 1) + O * H * 4 * 8 + O * (64 + N + 8 + 1)
    return bound(nbytes, flops)


def check_k15(dev, rng):
    """K15, the whole of `pnp_ransac_batch` in one launch, under `k15_gate`
    at the front end's shapes (with and without refinement) and the backup
    pose's; timed against the schedule it replaced (K3 + the eager tail)
    and the plain version on the card, with its device time per call."""
    from suo_slam_tpu_torch.solvers import pnp

    x, y, mask, idx = pnp_inputs(dev, rng)
    O, N = mask.shape
    H = idx.shape[1]
    errs = [k15_gate(f"K15 (O={O}, N={N}, n_hyp={H})", x, y, mask, idx)[0],
            k15_gate("K15 without refinement", x, y, mask, idx, refine=False)[0],
            k15_gate("K15 backup pose (O=1, N=8, n_hyp=128)", *backup_inputs(dev, rng))[0]]
    n_ref = int(pnp._pnp_ransac_cuda(x, y, mask, idx).success.sum())
    ms = cuda_ms(lambda: pnp._pnp_ransac_cuda(x, y, mask, idx))
    eager = lambda: pnp.pnp_ransac_batch_plain(x, y, mask, idx, use_kernels=True)
    eager_ms = cuda_ms(eager, n=3, inner=2, warmup=1)
    plain_ms = cuda_ms(lambda: pnp.pnp_ransac_batch_plain(x, y, mask, idx), n=3, inner=2,
                       warmup=1)
    us, src = device_us(lambda: pnp._pnp_ransac_cuda(x, y, mask, idx), "pnp_ransac_kernel")
    eus, esrc = lib_device_us(eager, n=2)
    b = k15_bound(O, N, H, n_ref)
    _report(f"K15 pnp_ransac (O={O}, N={N}, n_hyp={H}, {n_ref} refined; device {us:.3f} us by "
            f"{src}; the K3 + eager-tail schedule {eager_ms:.4f} ms, device {eus:.3f} us by "
            f"{esrc})", max(errs), "1e-4 (pose; inliers equal but at the threshold's edge)",
            ms, plain_ms, None, b)
    return dict(name="pnp_ransac", route="cuda", source="suo_slam_tpu_torch/csrc/pnp_ransac.cu",
                replaces="suo_slam_tpu/solvers/pnp.py:200", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


class PnpCalls:
    """Counts the calls of `pnp.pnp_ransac_batch` (the front ends' and,
    through `pnp_ransac`, the backup pose's) while installed."""

    def __init__(self):
        from suo_slam_tpu_torch.solvers import pnp

        self.pnp, self.fn, self.n = pnp, pnp.pnp_ransac_batch, 0

    def __enter__(self):
        def spy(*a, **kw):
            self.n += 1
            return self.fn(*a, **kw)

        self.pnp.pnp_ransac_batch = spy
        return self

    def __exit__(self, *exc):
        self.pnp.pnp_ransac_batch = self.fn


def _views(rng, objs, n):
    return [make_view(rng, objs) for _ in range(n)]


def _drive(engine, objs, views, before=None):
    """Feed each view after reset(); returns (per-view seconds, results)."""
    import torch

    times, results = [], []
    for i, (img, T, bboxes, uv_gt) in enumerate(views):
        if before is not None:
            before(uv_gt)
        engine.reset()
        t0 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, np.arange(1, N_OBJ + 1), bboxes,
                            objs.model_kps, objs.masks, objs.masks)
        res = engine.collect_results()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(res[i]["poses"])
    return times, results


def stage_times(engine, objs, view, dev, n=5):
    """Each stage of one view run alone, bracketed by synchronizes."""
    import torch

    from suo_slam_tpu_torch.ops import roi
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import _fix_K_np
    from suo_slam_tpu_torch.solvers import pnp

    img, _, bboxes, _ = view
    net = engine._infer.net
    imgs = torch.from_numpy(img)[None].to(dev)
    boxes = torch.from_numpy(bboxes)[None].to(dev)
    valid = torch.ones((1, N_OBJ), dtype=torch.bool, device=dev)
    out = {}

    def timed(name, fn):
        vals = []
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(vals[1:])
        return r

    with torch.inference_mode():
        crops = timed("crop", lambda: roi.roi_crop_batch(imgs, boxes, valid, (256, 256))[0])
        raw = timed("net", lambda: net.backbone_logits(crops)[-1])
        o = timed("readout", lambda: net.readout(raw))
    k4 = np.zeros((N_OBJ, 4), np.float32)
    for i in range(N_OBJ):
        K = _fix_K_np(YCBV_K, bboxes[i])
        k4[i] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    k4 = torch.from_numpy(k4).to(dev)
    mk = torch.from_numpy(objs.model_kps).to(dev)
    mm = torch.from_numpy(objs.masks).to(dev)
    diam = torch.from_numpy(objs.diameter).to(dev)
    c = engine.cfg
    # the front end (`frontend_step`, read back) and, alone, its sampler and
    # its PnP (`pnp_ransac_batch`: K15) on the same inputs; "frontend_rest"
    # is the rest: the keypoint filter, information and the read-back
    keep = sk.filter_keypoints(o.uv, o.cov, o.kp_mask, mm, c.bbox_thresh, c.kp_var_thresh,
                               c.mask_thresh)
    idx = timed("sampler", lambda: engine._sampler(keep, c.pnp_hypotheses))
    y = (o.uv - k4[:, None, 2:]) / k4[:, None, :2]
    timed("pnp_ransac_batch", lambda: pnp.pnp_ransac_batch(mk, y, keep, idx))
    timed("frontend_step", lambda: {k: v.cpu() for k, v in sk.frontend_step(
        o.uv, o.cov, o.kp_mask, mk, mm, k4, diam, engine._sampler, c.manual_kp_std,
        c.bbox_thresh, c.kp_var_thresh, c.mask_thresh, c.pnp_hypotheses).items()})
    out["frontend_rest"] = out["frontend_step"] - out["sampler"] - out["pnp_ransac_batch"]
    timed("ba", engine.optimize)
    return out


def profile_run(run, per_ms, label):
    """`run()` once more under torch.profiler: the device time of its
    kernels, its share of the unprofiled latency `per_ms`, the number of
    kernels, the PyTorch operations that hold the most device time, and the
    device time per launch of each of the port's kernels (without the host
    time of its wrapper, which `cuda_ms` includes). Returns the trace's key
    averages, or None when the tracer lost the session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from suo_slam_tpu_torch import kernels

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    avg = prof.key_averages()
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:  # the tracer lost the session; the run itself is not repeated
        log(f"[profile] {label}: the trace holds no device time (not measured)")
        return None
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms in {sum(e.count for e in kern)} "
        f"kernels = {busy_ms / per_ms:.4f} of the {per_ms:.2f} ms latency "
        f"(profiled wall {wall * 1e3:.2f} ms)")
    log(f"[profile] {label}: device ms and calls by operation: " + json.dumps(
        {e.key: [round(e.self_device_time_total / 1e3, 3), e.count] for e in ops}))
    mine = {}
    for name in kernels.LAUNCHES:  # csrc kernels are named <counter name>_kernel*
        es = [e for e in kern if f"{name}_kernel" in e.key]
        n = sum(e.count for e in es)
        mine[name] = [round(sum(e.self_device_time_total for e in es) / max(n, 1), 3), n]
    log(f"[profile] {label}: the port's kernels, device us per launch and launches: "
        + json.dumps(mine))
    return avg


def phase_main_path(dev, rng, objs, net, seed, n_views=6):
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    engine = ObjectSlam(SlamConfig(single_view_mode=True), mesh_db=objs, net=net,
                        device=dev)
    views = _views(rng, objs, n_views + 1)
    kernels.reset_counts()
    with PnpCalls() as calls:
        times, results = _drive(engine, objs, views)
    counts = kernels.counts()
    log(f"[main] launches over {len(views)} views: {json.dumps(counts)}; "
        f"{calls.n} pnp_ransac_batch calls")
    missing = [k for k in SINGLE_VIEW_KERNELS if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the single-view path: {missing}, or "
                             f"K3 / K4 / K7 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    if not counts["pnp_ransac"] == calls.n == len(views):
        raise AssertionError(f"K15: {counts['pnp_ransac']} launches for {calls.n} "
                             f"pnp_ransac_batch calls over {len(views)} views (want one each)")
    per_view_ms = statistics.median(times[1:]) * 1e3
    log(f"[main] per-view latency: median {per_view_ms:.2f} ms over {n_views} views "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    log(f"[main] crops/s at the 8-crop bucket: {N_OBJ / (per_view_ms / 1e3):.1f}")
    st = stage_times(engine, objs, views[-1], dev)
    log("[main] per-stage ms (each stage alone, last view's inputs): "
        + json.dumps({k: round(v, 3) for k, v in st.items()}))
    profile_run(lambda: _drive(engine, objs, [views[-1]])[0][0], per_view_ms, "one view")
    # outputs: finite, expected shapes, and the network path against the same
    # net on the CPU for two crops of the last view
    for poses in results:
        for p in poses.values():
            if p["T_OtoC"] is not None and not np.isfinite(p["T_OtoC"]).all():
                raise AssertionError("non-finite pose on the main path")
    img, _, bboxes, _ = views[-1]
    fn = engine._infer
    valid = torch.ones((N_OBJ,), dtype=torch.bool)
    uv, cov, mp = fn(torch.from_numpy(img).to(dev), torch.from_numpy(bboxes).to(dev),
                     valid.to(dev), has_prior=False)
    for name, a, shape in (("uv", uv, (N_OBJ, NK, 2)), ("cov", cov, (N_OBJ, NK, 2, 2)),
                           ("mask", mp, (N_OBJ, NK))):
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise AssertionError(f"network path {name}: shape {tuple(a.shape)} or non-finite")
    cpu_net = full_width_net(seed)
    cpu_fn = sk.make_frame_inference(cpu_net, device="cpu")
    uv_c, cov_c, mp_c = cpu_fn(torch.from_numpy(img), torch.from_numpy(bboxes[:2]),
                               valid[:2], has_prior=False)
    errs = {"uv": (uv[:2].cpu() - uv_c).abs().max().item(),
            "cov": (cov[:2].cpu() - cov_c).abs().max().item(),
            "mask": (mp[:2].cpu() - mp_c).abs().max().item()}
    log(f"[main] network path vs CPU (2 crops): {json.dumps(errs)} (tol 1e-3: cuDNN f32"
        " against CPU f32 convolutions through 2 hourglass stacks)")
    if not all(v <= 1e-3 for v in errs.values()):
        raise AssertionError(f"network path disagrees with the CPU: {errs}")
    return counts


class GtInfer:
    """Injected inference: projected GT keypoints + seeded N(0, sigma) NDC
    noise, cov sigma^2 I, validity 1."""

    def __init__(self, dev, seed, sigma=0.005):
        self.dev = dev
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.uv = None

    def set_frame(self, uv_gt):
        self.uv = (uv_gt + self.rng.normal(scale=self.sigma, size=uv_gt.shape)).astype(np.float32)

    def __call__(self, img, boxes, obj_valid, prior_uv=None, prior_valid=None):
        import torch

        ob = boxes.shape[0]
        uv = np.zeros((ob, NK, 2), np.float32)
        uv[: self.uv.shape[0]] = self.uv
        cov = np.broadcast_to(np.eye(2, dtype=np.float32) * self.sigma ** 2, (ob, NK, 2, 2))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
        return t(uv), t(cov), t(np.ones((ob, NK), np.float32))


def phase_solver_check(dev, rng, objs, seed, n_views=6):
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    inf = GtInfer(dev, seed)
    engine = ObjectSlam(SlamConfig(single_view_mode=True), mesh_db=objs, infer_fn=inf,
                        device=dev)
    views = _views(rng, objs, n_views)
    _, results = _drive(engine, objs, views, before=inf.set_frame)
    rot, trans, ok = [], [], []
    for (img, T, bboxes, uv_gt), poses in zip(views, results):
        for o in range(N_OBJ):
            Te = poses[o + 1]["T_OtoC"]
            if Te is None:
                ok.append(False)
                continue
            m = objs.masks[o]
            p_gt = objs.model_kps[o][m] @ T[o, :3, :3].T + T[o, :3, 3]
            p_es = objs.model_kps[o][m] @ Te[:3, :3].T + Te[:3, 3]
            add = np.linalg.norm(p_gt - p_es, axis=-1).mean()
            c = (np.trace(Te[:3, :3].T @ T[o, :3, :3]) - 1) / 2
            rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
            trans.append(float(np.linalg.norm(Te[:3, 3] - T[o, :3, 3])))
            ok.append(add < 0.1 * objs.diameter[o])
    frac = float(np.mean(ok))
    log(f"[solver] {len(ok)} objects: median rotation error "
        f"{statistics.median(rot) if rot else float('nan'):.4f} deg, median translation "
        f"error {statistics.median(trans) if trans else float('nan'):.3f} mm, "
        f"ADD < 0.1 d for {frac:.3f}")
    if frac < 0.9:
        raise AssertionError(f"solver check: ADD < 0.1 d for only {frac:.3f} of objects")
    return frac


class SlamScene:
    """The eight objects fixed in the world (the first camera's frame, on a
    4 x 2 grid 0.75-0.85 m away) and a smooth camera orbit around the
    scene's centre: frame i yaws 4 deg x sin(i / 4) and bobs a few mm."""

    def __init__(self, rng, objs: Objects, n_frames):
        self.objs = objs
        self.T_obj = np.tile(np.eye(4), (N_OBJ, 1, 1))
        for o in range(N_OBJ):
            z = rng.uniform(750, 850)
            self.T_obj[o, :3, :3] = random_rotation(rng)
            self.T_obj[o, :3, 3] = [-150 + 100 * (o % 4), -60 + 120 * (o // 4), z]
        c = np.array([0.0, 0.0, 800.0])
        self.cams = np.tile(np.eye(4), (n_frames, 1, 1))
        for i in range(n_frames):
            a = math.radians(4.0) * math.sin(i / 4.0)
            R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                          [-math.sin(a), 0, math.cos(a)]])
            self.cams[i, :3, :3] = R
            self.cams[i, :3, 3] = c - R @ c + [0.0, 5.0 * math.sin(i / 3.0), 0.0]

    def frame(self, i):
        """(T_OtoC [8, 4, 4], bboxes [8, 4], uv_gt [8, 41, 2] NDC) of frame i."""
        T = self.cams[i] @ self.T_obj
        bboxes = np.zeros((N_OBJ, 4), np.float32)
        uv_gt = np.zeros((N_OBJ, NK, 2), np.float32)
        for o in range(N_OBJ):
            p = self.objs.model_kps[o] @ T[o, :3, :3].T + T[o, :3, 3]
            uvw = p @ YCBV_K.T
            uv = uvw[:, :2] / uvw[:, 2:]
            m = self.objs.masks[o]
            x1, y1 = uv[m].min(0) - 10
            x2, y2 = uv[m].max(0) + 10
            if x1 < 0 or y1 < 0 or x2 > W_IMG or y2 > H_IMG:
                raise AssertionError(f"object {o + 1} leaves frame {i}")
            bboxes[o] = (x1, y1, x2, y2)
            uv_gt[o] = np.stack([2 * (uv[:, 0] - x1) / (x2 - x1) - 1,
                                 1 - 2 * (uv[:, 1] - y1) / (y2 - y1)], -1)
        return T, bboxes, uv_gt

    @staticmethod
    def k4(bboxes):
        from suo_slam_tpu_torch.slam.engine import _fix_K_np

        out = np.zeros((len(bboxes), 4), np.float32)
        for o, bb in enumerate(bboxes):
            K = _fix_K_np(YCBV_K, bb)
            out[o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        return out


class GtPriorInfer:
    """The SLAM path's frame inference: runs the full-width net
    (`make_frame_inference`: K1 crop -> K5 prior render -> PkpNet -> K2
    readout) on every call, then returns, in place of its uv / cov /
    validity, the group's projected ground-truth keypoints + N(0, sigma)
    NDC noise, cov sigma^2 I and validity 1. The group's objects are found
    by their boxes (one small read-back of the boxes per call)."""

    supports_no_prior = True

    def __init__(self, fn, dev, seed, sigma=0.005):
        self.fn = fn
        self.dev = dev
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.last_prior_call = None
        self.n_prior_calls = 0

    def set_frame(self, bboxes, uv_gt):
        self.boxes = bboxes
        self.uv = (uv_gt + self.rng.normal(scale=self.sigma, size=uv_gt.shape)).astype(np.float32)

    def __call__(self, img, boxes, obj_valid, prior_uv, prior_valid, has_prior=True):
        import torch

        bx = boxes.cpu().numpy()
        out = self.fn(img, boxes, obj_valid, prior_uv, prior_valid, has_prior=has_prior)
        if has_prior:
            self.n_prior_calls += 1
            self.last_prior_call = ((img, boxes, obj_valid, prior_uv, prior_valid), out)
        ob = bx.shape[0]
        uv = np.zeros((ob, NK, 2), np.float32)
        for i in range(ob):
            hit = np.flatnonzero(np.all(np.abs(self.boxes - bx[i]) < 1e-3, axis=1))
            if hit.size:
                uv[i] = self.uv[hit[0]]
        cov = np.broadcast_to(np.eye(2, dtype=np.float32) * self.sigma ** 2, (ob, NK, 2, 2))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
        return t(uv), t(cov), t(np.ones((ob, NK), np.float32))


def _tracking_arrays(engine):
    """The tracking BA's problem on the engine's last view row (all objects
    fixed), as numpy arrays."""
    v = engine.view_slot[engine.view_ids[-1]]
    row = lambda a: a[v:v + 1]
    return dict(cam_T=row(engine.cam_T), obj_T=engine.obj_T, uv=row(engine.uv),
                info=row(engine.info), model_kp=engine.model_kp, cam_k=row(engine.cam_k4),
                valid=row(engine.valid), inliers=row(engine.inliers),
                cam_active=np.ones((1,), bool), obj_active=engine.obj_active)


def _ba_problem_of(arrays, device, f64=False):
    import torch

    from suo_slam_tpu_torch.solvers import ba

    return ba.BAProblem(**{k: torch.tensor(
        a.astype(np.float64) if f64 and a.dtype == np.float32 else a, device=device)
        for k, a in arrays.items()})


TRACKING = dict(iters_per_round=(10, 10, 10, 10), tracking_only=True, fix_first_cam=False)


def _tracking_ba_ms(engine, dev, fn, n=5):
    """`fn` (an `optimize`) on the tracking BA problem of the engine's last
    view row, host clock around a synchronized call, median of n."""
    import torch

    problem = _ba_problem_of(_tracking_arrays(engine), dev)
    vals = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn(problem, **TRACKING)
        torch.cuda.synchronize()
        vals.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(vals[1:])


def _add_ok(T_est, T_gt, objs, o):
    m = objs.masks[o]
    p_gt = objs.model_kps[o][m] @ T_gt[:3, :3].T + T_gt[:3, 3]
    p_es = objs.model_kps[o][m] @ T_est[:3, :3].T + T_est[:3, 3]
    return float(np.linalg.norm(p_gt - p_es, axis=-1).mean()) < 0.1 * objs.diameter[o]


def compare_ba(label, arrays, dev, act, **kw):
    """One BA problem through K14 (`optimize` on the card), the eager
    schedule with K4 + K7 and with the plain versions on the card, and the
    plain eager schedule in f64 on the CPU. K14 against the eager plain run:
    poses within 1e-4 (rotation absolute; translation relative to its norm,
    at least the 800 mm scene depth) and equal inlier masks, except edges
    within 1% of the chi2 threshold, each printed with its chi2; and no
    farther from the f64 result than twice the farther of the two eager
    runs, or 1e-5: f32 LM end states scatter that far around the f64 BA
    under another summation order (an f32 residual uv - pi(.) of ~3e-3 NDC
    keeps ~2e-5 of relative rounding, so the relative-gain exit at 1e-6
    stops on noise; on the card the eager K4 + K7 run ended 2.1e-6 from the
    f64 poses where the eager plain run ended 2.0e-8). Prints each run's
    host ms, iterations per round (the eager runs leave a round's loop at
    its `done` step) and K14's device time per call and per iteration."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pk = _ba_problem_of(arrays, dev)
    ba._ba_lm_cuda(pk, **kw)  # warm
    (rk, itk), ms_k = timed(lambda: ba._ba_lm_cuda(pk, **kw))
    (re, ite), ms_e = timed(lambda: ba._optimize_eager(pk, use_kernels=True, **kw))
    (rp, itp), ms_p = timed(lambda: ba._optimize_eager(pk, **kw))
    with torch.inference_mode():
        chi2 = ba._edge_chi2_plain(rk.cam_T, rk.obj_T, pk.uv, pk.info, pk.model_kp, pk.cam_k)
        r64, it64 = ba._optimize_eager(_ba_problem_of(arrays, "cpu", f64=True), **kw)
    ca, oa = act

    def gap(r1, r2):
        out = {}
        for name, a, b, m in (("cam", r1.cam_T, r2.cam_T, ca), ("obj", r1.obj_T, r2.obj_T, oa)):
            a = a.cpu().numpy()[m].astype(np.float64)
            b = b.cpu().numpy()[m].astype(np.float64)
            scale = np.maximum(np.linalg.norm(b[:, :3, 3], axis=-1), 800.0)
            rel_t = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) / scale
            out[name] = [float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max(initial=0.0)),
                         float(rel_t.max(initial=0.0))]
        return out

    worst = lambda g: max(max(e) for e in g.values())
    errs, g_k, g_p, g_e = gap(rk, rp), gap(rk, r64), gap(rp, r64), gap(re, r64)
    flips = (rk.inliers != rp.inliers).nonzero().tolist()
    fchi2 = [round(float(chi2[tuple(f)]), 4) for f in flips]
    n64 = lambda r: int((r.inliers.cpu() != r64.inliers).sum())
    log(f"[slam] {label}: K14 {ms_k:.2f} ms, eager K4 + K7 {ms_e:.2f} ms, eager plain "
        f"{ms_p:.2f} ms; iterations per round K14 {itk.tolist()}, eager K4 + K7 {ite}, eager "
        f"plain {itp}, f64 {it64}")
    log(f"[slam] {label}: K14 vs the eager plain run: rotation / relative translation errors "
        f"{json.dumps(errs)} (tol 1e-4); {int(rk.num_inliers)} inliers, {len(flips)} flipped "
        f"edges (v, o, k) {flips[:8]} with chi2 {fchi2[:8]} (threshold 5.991); against the "
        f"f64 BA: K14 {json.dumps(g_k)} and {n64(rk)} edges apart, eager plain "
        f"{json.dumps(g_p)} and {n64(rp)} apart, eager K4 + K7 {json.dumps(g_e)}")
    if worst(errs) > 1e-4:
        raise AssertionError(f"{label}: K14 disagrees with the eager plain schedule: {errs}")
    if any(abs(c - ba.CHI2_THRESH_2DOF) > 0.01 * ba.CHI2_THRESH_2DOF for c in fchi2):
        raise AssertionError(f"{label}: an edge away from the threshold flipped: {fchi2}")
    if worst(g_k) > max(2 * worst(g_p), 2 * worst(g_e), 1e-5):
        raise AssertionError(f"{label}: K14 is farther from the f64 BA than the eager runs: "
                             f"{g_k} vs {g_p}, {g_e}")
    us, src = device_us(lambda: ba._ba_lm_cuda(pk, **kw), "ba_lm_kernel", n=3)
    cyc = torch.zeros(len(ba.LM_PHASES), dtype=torch.int64, device=dev)
    ba._ba_lm_cuda(pk, **kw, cycles=cyc)
    cyc = cyc.tolist()
    log(f"[slam] {label}: K14 device {us:.3f} us per call by {src}, "
        f"{us / max(1, sum(itk.tolist())):.3f} us per iteration; SM cycles by phase "
        + json.dumps(dict(zip(ba.LM_PHASES, cyc))) + f" ({sum(cyc)} in all)")
    return ms_k, ms_e, ms_p


def compare_global_ba(engine, dev):
    """The SLAM path's global BA problem (V = 32, its poses moved ~0.2 mm
    off the engine's, inside the chi2 inlier basin) through `compare_ba`."""
    rng = np.random.default_rng(9)
    cam_T = engine.cam_T.copy()
    obj_T = engine.obj_T.copy()
    cam_T[1:, :3, 3] += rng.normal(scale=0.2, size=(engine.V - 1, 3)).astype(np.float32)
    obj_T[:, :3, 3] += rng.normal(scale=0.2, size=(engine.O, 3)).astype(np.float32)
    arrays = dict(cam_T=cam_T, obj_T=obj_T, uv=engine.uv, info=engine.info,
                  model_kp=engine.model_kp, cam_k=engine.cam_k4, valid=engine.valid,
                  inliers=engine.inliers, cam_active=engine.cam_active,
                  obj_active=engine.obj_active, cam_frozen=np.zeros(engine.V, bool))
    return compare_ba(f"global BA (V={engine.V}, O={engine.O})", arrays, dev,
                      (engine.cam_active, engine.obj_active))


def compare_tracking_ba(engine, dev):
    """The tracking BA's problem on the engine's last view row, its camera
    moved ~0.2 mm, through `compare_ba`."""
    arrays = _tracking_arrays(engine)
    arrays["cam_T"] = arrays["cam_T"].copy()
    arrays["cam_T"][0, :3, 3] += np.random.default_rng(10).normal(
        scale=0.2, size=3).astype(np.float32)
    return compare_ba("tracking BA (V=1)", arrays, dev,
                      (np.ones((1,), bool), engine.obj_active), **TRACKING)


def phase_slam(dev, rng, objs, net, seed, scene):
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    n_frames = len(scene.cams) - 1  # the last frame is the profiled one
    img = rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    fn = sk.make_frame_inference(net, device=dev)
    inf = GtPriorInfer(fn, dev, seed)
    engine = ObjectSlam(SlamConfig(), mesh_db=objs, infer_fn=inf, device=dev)
    ids = np.arange(1, N_OBJ + 1)

    def frame(i):
        _, bboxes, uv_gt = scene.frame(i)
        inf.set_frame(bboxes, uv_gt)
        t0 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks, objs.masks)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    kernels.reset_counts()
    with PnpCalls() as calls:
        times = [frame(i) for i in range(n_frames)]
    t0 = time.perf_counter()
    results = engine.collect_results(final=True)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    counts = kernels.counts()
    log(f"[slam] launches over {n_frames} frames + the final BA: {json.dumps(counts)}; "
        f"{calls.n} pnp_ransac_batch calls")
    if counts["pnp_ransac"] != calls.n or calls.n < 2 * n_frames:
        raise AssertionError(f"K15: {counts['pnp_ransac']} launches for {calls.n} "
                             f"pnp_ransac_batch calls over {n_frames} frames")
    log("[slam] launches per frame: " + json.dumps(
        {k: round(c / n_frames, 2) for k, c in counts.items()}))
    missing = [k for k, c in counts.items() if c == 0 and k != "add_dists"
               and k not in INT8_KERNELS + OFF_PATH_KERNELS + TRAIN_KERNELS]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the SLAM path: {missing}, or K3 / K4 / "
                             f"K7 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    n_global = len(engine.opt_times)  # frames 10, 20 and the final collect_results
    log(f"[slam] K14 launches: {counts['ba_lm']} = {counts['ba_lm'] - n_global} tracking BAs "
        f"over {n_frames} frames + {n_global} global BAs; K4 {counts['ba_edges']}, K7 "
        f"{counts['ba_schur']}")
    if engine.V != 32 or len(engine.opt_times) != 3:
        raise AssertionError(f"SLAM path: capacity {engine.V}, {len(engine.opt_times)} global BAs")
    per_frame_ms = statistics.median(times[1:]) * 1e3
    log(f"[slam] per-frame latency: median {per_frame_ms:.2f} ms over {n_frames - 1} frames "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    from suo_slam_tpu_torch.solvers import ba

    eager = lambda p, **kw: ba._optimize_eager(p, use_kernels=True, **kw)
    log(f"[slam] global BA ms (frames 10, 20, final): "
        f"{[round(t * 1e3, 2) for t in engine.opt_times]}; final collect_results "
        f"{final_s * 1e3:.2f} ms; tracking BA alone: K14 "
        f"{_tracking_ba_ms(engine, dev, ba.optimize):.2f} ms, the eager K4 + K7 schedule "
        f"{_tracking_ba_ms(engine, dev, eager):.2f} ms; {inf.n_prior_calls} with-prior "
        f"network calls")
    # the trajectory and the objects against the ground truth
    rot, trans, ok = [], [], []
    for i in range(n_frames):
        T_gt = scene.cams[i]
        Te = engine.cam_T[engine.view_slot[i]].astype(np.float64)
        c = (np.trace(Te[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
        rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
        trans.append(float(np.linalg.norm(Te[:3, 3] - T_gt[:3, 3])))
        T_OtoC, _, _ = scene.frame(i)
        for o in range(N_OBJ):
            p = results[i]["poses"].get(o + 1, {}).get("T_OtoC")
            ok.append(p is not None and np.isfinite(p).all() and _add_ok(p, T_OtoC[o], objs, o))
    frac = float(np.mean(ok))
    log(f"[slam] camera trajectory: max rotation error {max(rot):.4f} deg, max translation "
        f"error {max(trans):.3f} mm; ADD < 0.1 d for {frac:.3f} of {len(ok)} (frame, object) "
        f"poses")
    if frac < 0.9:
        raise AssertionError(f"SLAM path: ADD < 0.1 d for only {frac:.3f} of the poses")
    # the with-prior program on the card against the same net on the CPU
    if inf.last_prior_call is None:
        raise AssertionError("the SLAM path ran no with-prior network call")
    (img_d, boxes, valid, prior_uv, prior_valid), out = inf.last_prior_call
    if not prior_valid.any():
        raise AssertionError("the last with-prior call had no valid prior keypoint")
    cpu_fn = sk.make_frame_inference(full_width_net(seed), device="cpu")
    out_c = cpu_fn(img_d.cpu(), boxes[:2].cpu(), valid[:2].cpu(), prior_uv[:2].cpu(),
                   prior_valid[:2].cpu())
    errs = {n: (a[:2].cpu() - b).abs().max().item()
            for n, a, b in zip(("uv", "cov", "mask"), out, out_c)}
    log(f"[slam] with-prior network path vs CPU (2 crops, {int(prior_valid[:2].sum())} prior "
        f"keypoints): {json.dumps(errs)} (tol 1e-3)")
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"with-prior network path disagrees with the CPU: {errs}")
    compare_global_ba(engine, dev)
    compare_tracking_ba(engine, dev)
    # the profiled frame: its launches (counted at launch) and the bound of
    # its K8 / K9 calls, summed over their shapes
    from suo_slam_tpu_torch.models import hourglass as hg

    k89 = {"norm_relu": [0, 0.0], "upsample_add": [0, 0.0]}
    k8, k9 = hg._norm_relu_cuda, hg._upsample_add_cuda

    def spy_k8(x, inv, shift):
        k89["norm_relu"][0] += 1
        k89["norm_relu"][1] += bound(2 * x.numel() * x.element_size() + 2 * inv.numel() * 4,
                                     3 * x.numel())[0]
        return k8(x, inv, shift)

    def spy_k9(up1, low):
        k89["upsample_add"][0] += 1
        k89["upsample_add"][1] += bound((2 * up1.numel() + low.numel()) * up1.element_size(),
                                        up1.numel())[0]
        return k9(up1, low)

    hg._norm_relu_cuda, hg._upsample_add_cuda = spy_k8, spy_k9
    before = kernels.counts()
    try:
        with PnpCalls() as calls:
            avg = profile_run(lambda: frame(n_frames), per_frame_ms, "one SLAM frame")
    finally:
        hg._norm_relu_cuda, hg._upsample_add_cuda = k8, k9
    c = {k: v - before[k] for k, v in kernels.counts().items()}
    log(f"[slam] the profiled frame's launches: {json.dumps({k: v for k, v in c.items() if v})}; "
        f"{calls.n} pnp_ransac_batch calls; K8 / K9 calls and the sum of their bounds in ms "
        f"over the frame's shapes: "
        f"{json.dumps({k: [n, round(b, 5)] for k, (n, b) in k89.items()})}")
    if c["ba_lm"] != 1 or any(c[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"the profiled frame: K14 {c['ba_lm']} (want 1 tracking BA), "
                             f"K3 / K4 / K7 {[c[k] for k in OFF_PATH_KERNELS]} (want 0)")
    if not c["pnp_ransac"] == calls.n >= 2:
        raise AssertionError(f"the profiled frame: K15 {c['pnp_ransac']} launches for "
                             f"{calls.n} pnp_ransac_batch calls (want one each, two or more)")
    if avg is not None:
        from torch.autograd import DeviceType

        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        log(f"[slam] the profiled frame: {sum(e.count for e in kern)} kernels, device busy "
            f"{sum(e.self_device_time_total for e in kern) / 1e3:.2f} ms (before K15, on an H100 "
            f"80GB HBM3 at 700 W: 9,034 kernels, 33.00 ms)")
        if any("cholesky" in e.key for e in avg):
            raise AssertionError("the profiled frame ran a cholesky on the main path")
    return counts


def traced(fn, holds, label, attempts=3):
    """torch.profiler's key averages over one call of `fn` (a pure call: it
    is repeated), taken again while `holds(averages)` is false: the card's
    tracer now and then returns a short session without its kernels. None
    when every attempt came back without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        if holds(avg):
            return avg
        log(f"[profile] {label}: trace {i + 1} of {attempts} holds none of the kernels")
    return None


def device_us(fn, key, n=10, per_call=1):
    """Device microseconds per call of fn in the kernels whose names hold
    `key` (per_call of them per call), from torch.profiler over n calls
    (without the wrapper's host time, which `cuda_ms` includes), and where
    they were read. The time is averaged over the launches the trace holds,
    not over n: a retaken trace can also hold launches an earlier one lost,
    and a partial one fewer. When the tracer returns no such kernel, CUDA
    events around the n back-to-back calls (host time of the wrappers
    included) stand in for it."""
    import torch
    from torch.autograd import DeviceType

    def calls():
        for _ in range(n):
            fn()

    def mine(avg):
        return [e for e in avg if e.device_type == DeviceType.CUDA and key in e.key]

    fn()
    torch.cuda.synchronize()
    avg = traced(calls, lambda a: sum(e.count for e in mine(a)) > 0, key)
    if avg is not None:
        ks = mine(avg)
        launches = sum(e.count for e in ks)
        return sum(e.self_device_time_total for e in ks) * per_call / launches, "profiler"
    return 1e3 * cuda_ms(fn, n=5, inner=n), "CUDA events"


def lib_device_us(fn, n=5):
    """Device microseconds per call of a library yardstick: every kernel of
    one trace of n calls (the wrapper's host time, which `cuda_ms` includes,
    left out), over the calls the trace holds — the launches of its most
    launched kernel, since a short session can lose some; CUDA events when
    the tracer returns no kernel."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    cuda = lambda a: [e for e in a if e.device_type == DeviceType.CUDA]
    avg = traced(lambda: [fn() for _ in range(n)], lambda a: len(cuda(a)) > 0, "library")
    if avg is None:
        return 1e3 * cuda_ms(fn, n=5, inner=n), "CUDA events"
    ks = cuda(avg)
    calls = min(n, max(e.count for e in ks))
    return sum(e.self_device_time_total for e in ks) / calls, "profiler"


def _bf16_ulps(k, p):
    """|k - p| in units of the bf16 spacing at p (1 ulp: 2^(floor(log2|p|) - 7))."""
    import torch

    kd, pd = k.double(), p.double()
    e = torch.floor(torch.log2(pd.abs().clamp(min=2.0 ** -126)))
    return ((kd - pd).abs() / torch.exp2(e - 7)).max().item()


def _per_forward_launches(net, crops, names):
    """Launches of the named kernels in one forward of `net` on `crops`."""
    import torch

    from suo_slam_tpu_torch import kernels

    before = kernels.counts()
    with torch.inference_mode():
        net.backbone_logits(crops)
    torch.cuda.synchronize()
    after = kernels.counts()
    return {n: after[n] - before[n] for n in names}


def check_k8(dev, rng, net32, net16, crops):
    """K8 at the net's shapes (8 crops): the stem norm (64 ch at 128x128),
    a residual's first norm at 64x64 x 256 (the largest call) and a
    bottleneck norm at 64x64 x 128; f32 equal, bf16 within 1 ulp."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    shapes = [(N_OBJ, 64, 128, 128), (N_OBJ, 256, 64, 64), (N_OBJ, 128, 64, 64)]
    err32, ulps = 0.0, 0.0
    for shape in shapes:
        C = shape[1]
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).contiguous(
            memory_format=torch.channels_last)
        inv = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        shift = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev)
        k, p = hg._norm_relu_cuda(x, inv, shift), hg.norm_relu_plain(x, inv, shift)
        x16 = x.to(torch.bfloat16)
        k16, p16 = hg._norm_relu_cuda(x16, inv, shift), hg.norm_relu_plain(x16, inv, shift)
        torch.cuda.synchronize()
        err32 = max(err32, (k - p).abs().max().item())
        ulps = max(ulps, _bf16_ulps(k16, p16))
        if not (k16.is_contiguous(memory_format=torch.channels_last)
                and torch.equal(k16 == 0, p16 == 0)):
            raise AssertionError("K8 bf16: layout or zero pattern differs from the plain version")
    log(f"[kernel] K8 f32 max abs err {err32:.3e} (tol 0), bf16 max err {ulps:.3f} ulp (tol 1)")
    if not (err32 == 0.0 and ulps <= 1.0):
        raise AssertionError(f"K8 disagrees with its plain version: f32 {err32}, bf16 {ulps} ulp")
    per_fwd = {dt: _per_forward_launches(n, crops, ("norm_relu", "upsample_add"))
               for dt, n in (("f32", net32), ("bf16", net16))}
    log(f"[kernel] K8 / K9 launches per forward of the full-width net (8 crops): "
        f"{json.dumps(per_fwd)}")
    if any(v != {"norm_relu": 180, "upsample_add": 8} for v in per_fwd.values()):
        raise AssertionError(f"K8 / K9 launches per forward: {per_fwd}, expected 180 and 8")
    # timed at the largest call, a residual's first norm at 64x64 x 256
    x = torch.from_numpy(rng.normal(size=shapes[1]).astype(np.float32)).to(dev).contiguous(
        memory_format=torch.channels_last)
    inv = torch.ones(256, device=dev)
    shift = torch.zeros(256, device=dev)
    out = {}
    for name, xd in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        ms = cuda_ms(lambda: hg._norm_relu_cuda(xd, inv, shift))
        plain_ms = cuda_ms(lambda: hg.norm_relu_plain(xd, inv, shift))
        us, src = device_us(lambda: hg._norm_relu_cuda(xd, inv, shift), "norm_relu_kernel")
        n = xd.numel()
        b = bound(2 * n * xd.element_size() + 2 * 256 * 4, n * 3)
        out[name] = (ms, plain_ms, b)
        _report(f"K8 norm_relu ({name}, {list(xd.shape)}, device {us:.3f} us by {src})",
                err32 if name == "f32" else ulps, "0" if name == "f32" else "1 bf16 ulp", ms,
                plain_ms, None, b)
    ms, plain_ms, b = out["bf16"]
    return dict(name="norm_relu", route="cuda", source="suo_slam_tpu_torch/csrc/norm_relu.cu",
                replaces="suo_slam_tpu/models/hourglass.py:88", max_abs_err=err32, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def check_k9(dev, rng):
    """K9 at the hourglass junctions: up1 [8, 256, H, W] for H = 64, 32, 16,
    8 and low at half; f32 and bf16 equal to the plain version."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    err = 0.0
    for H in (64, 32, 16, 8):
        up1 = cl(rng.normal(size=(N_OBJ, 256, H, H)).astype(np.float32))
        low = cl(rng.normal(size=(N_OBJ, 256, H // 2, H // 2)).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            a, b = up1.to(dt), low.to(dt)
            k, p = hg._upsample_add_cuda(a, b), hg.upsample_add_plain(a, b)
            torch.cuda.synchronize()
            err = max(err, (k.float() - p.float()).abs().max().item())
    log(f"[kernel] K9 max abs err over 4 levels, f32 and bf16: {err:.3e} (tol 0)")
    if err != 0.0:
        raise AssertionError(f"K9 disagrees with its plain version: {err}")
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a = cl(rng.normal(size=(N_OBJ, 256, 64, 64)).astype(np.float32)).to(dt)
        b = cl(rng.normal(size=(N_OBJ, 256, 32, 32)).astype(np.float32)).to(dt)
        ms = cuda_ms(lambda: hg._upsample_add_cuda(a, b))
        plain_ms = cuda_ms(lambda: hg.upsample_add_plain(a, b))
        us, src = device_us(lambda: hg._upsample_add_cuda(a, b), "upsample_add_kernel")
        bnd = bound((2 * a.numel() + b.numel()) * a.element_size(), a.numel())
        out[name] = (ms, plain_ms, bnd)
        _report(f"K9 upsample_add ({name}, up1 {list(a.shape)}, device {us:.3f} us by {src})",
                err, "0",
                ms, plain_ms, None, bnd)
    ms, plain_ms, b = out["bf16"]
    return dict(name="upsample_add", route="cuda",
                source="suo_slam_tpu_torch/csrc/upsample_add.cu",
                replaces="suo_slam_tpu/models/hourglass.py:35", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def check_k10(dev, rng):
    """K10 at P = 4096 (the MeshDb subsample), B = 1 (one object per meter
    update, as the evaluation calls it) and B = 8: per-point distances equal
    to the plain version's, means within 1e-6 relative."""
    import torch

    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.eval import meter

    P = 4096
    res = {}
    for B in (1, 8):
        pts = torch.from_numpy(rng.uniform(-50, 50, (B, P, 3)).astype(np.float32)).to(dev)
        n = torch.full((B,), P, dtype=torch.int32, device=dev)
        if B > 1:
            n[1:] = torch.from_numpy(rng.integers(P // 2, P, B - 1).astype(np.int32)).to(dev)
        Tg = torch.from_numpy(np.stack([np.eye(4)] * B).astype(np.float32)).to(dev)
        Tg[:, :3, :3] = torch.from_numpy(np.stack([random_rotation(rng) for _ in range(B)])
                                         .astype(np.float32)).to(dev)
        Tg[:, 2, 3] = 800.0
        w = rng.normal(size=(B, 6)) * np.array([0.01] * 3 + [0.0] * 3)
        dT = lie.se3_exp(torch.from_numpy(w.astype(np.float32)).to(dev))
        dT[:, :3, 3] = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32) * 3).to(dev)
        Tp = dT @ Tg
        k = meter._add_dists_cuda(pts, n, Tp, Tg, per_point=True)
        p = meter.add_dists_plain(pts, n, Tp, Tg, per_point=True)
        torch.cuda.synchronize()
        pt_equal = torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
        rel = max(((a - b).abs() / b.abs()).max().item() for a, b in zip(k[:2], p[:2]))
        log(f"[kernel] K10 B={B}: per-point distances equal {pt_equal}, means rel err "
            f"{rel:.3e} (tol 1e-6); ADD {k[0][:4].tolist()}, ADD-S {k[1][:4].tolist()}")
        if not (pt_equal and rel <= 1e-6):
            raise AssertionError(f"K10 disagrees with its plain version (B={B}): {rel}")
        ms = cuda_ms(lambda: meter._add_dists_cuda(pts, n, Tp, Tg))
        plain_ms = cuda_ms(lambda: meter.add_dists_plain(pts, n, Tp, Tg), n=5, inner=2)

        def lib():  # the ADD-S minimum by cdist
            R, t = Tg[:, :3, :3], Tg[:, :3, 3]
            g = pts @ R.transpose(1, 2) + t[:, None]
            q = pts @ Tp[:, :3, :3].transpose(1, 2) + Tp[:, None, :3, 3]
            return torch.cdist(g, q).amin(-1)

        lib_ms = cuda_ms(lib)
        us, src = device_us(lambda: meter._add_dists_cuda(pts, n, Tp, Tg), "add_dists_",
                            per_call=2)
        pairs = float((n.double() ** 2).sum())
        b = bound(pts.numel() * 4 + B * (2 * 64 + 4 + 8), pairs * 9)
        res[B] = (rel, ms, plain_ms, lib_ms, b)
        _report(f"K10 add_dists (B={B}, P={P}, device {us:.3f} us per call of 2 kernels by "
                f"{src})",
                rel, "1e-6 relative; per-point equal", ms, plain_ms, lib_ms, b, lib)
    rel, ms, plain_ms, lib_ms, b = res[1]
    return dict(name="add_dists", route="cuda", source="suo_slam_tpu_torch/csrc/add_dists.cu",
                replaces="suo_slam_tpu/eval/meter.py:83", max_abs_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def phase_bf16_net(dev, rng, seed, net32, net16, crops):
    """The full-width net in bf16 against the same weights in f32 on the
    card. With random weights the heatmaps are flat and uv moves with the
    rounding, so the gate is the bf16 error the CPU shows on the same two
    crops: the card's bf16-vs-f32 gap (largest and mean |uv|) within 1.5x the
    CPU's, whose convolutions round elsewhere. Prints both nets' ms per call
    (8 crops, backbone + readout)."""
    import torch

    cpu = {dt: full_width_net(seed, dt).eval().to(memory_format=torch.channels_last)
           for dt in (torch.float32, torch.bfloat16)}
    with torch.inference_mode():
        o32, o16 = net32(crops), net16(crops)
        torch.cuda.synchronize()
        c2 = crops[:2].cpu()
        c32, c16 = cpu[torch.float32](c2), cpu[torch.bfloat16](c2)
    gap = (o16.uv[:2].cpu() - o32.uv[:2].cpu()).abs()
    ref = (c16.uv - c32.uv).abs()
    card_all = (o16.uv - o32.uv).abs()
    f32_cpu = (o32.uv[:2].cpu() - c32.uv).abs().max().item()
    log(f"[bf16] uv |bf16 - f32| on the card: max {card_all.max().item():.4f} mean "
        f"{card_all.mean().item():.5f} NDC (8 crops); the 2 crops: card max "
        f"{gap.max().item():.4f} mean {gap.mean().item():.5f}, CPU max {ref.max().item():.4f} "
        f"mean {ref.mean().item():.5f} (gate 1.5x the CPU's); f32 card vs CPU {f32_cpu:.2e}; "
        f"mask |bf16 - f32| max {(o16.kp_mask - o32.kp_mask).abs().max().item():.4f}")
    if not (torch.isfinite(o16.uv).all() and torch.isfinite(o16.cov).all()):
        raise AssertionError("bf16 net: non-finite outputs")
    if not (gap.max() <= 1.5 * ref.max() and gap.mean() <= 1.5 * ref.mean()):
        raise AssertionError("bf16 net on the card: uv farther from f32 than the CPU's bf16 net")
    # ms per call with K8 / K9 and with their plain versions in the same
    # net, in turns (kernels, plain, plain, kernels), host clock around
    # synchronized calls: the layer's own A/B
    from suo_slam_tpu_torch.models import hourglass as hg

    fused = (hg.norm_relu, hg.upsample_add)
    plain = (hg.norm_relu_plain, hg.upsample_add_plain)

    def wall_ms(n, reps=10):
        vals = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                n(crops)
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(vals[1:])

    t = {}
    try:
        for turn, fns in (("kernels", fused), ("plain", plain), ("plain", plain),
                          ("kernels", fused)):
            hg.norm_relu, hg.upsample_add = fns
            for name, n in (("f32", net32), ("bf16", net16)):
                t.setdefault(f"{name} {turn}", []).append(wall_ms(n))
    finally:
        hg.norm_relu, hg.upsample_add = fused
    log("[bf16] full-width net ms per call (8 crops, 256x256, backbone + readout; median of "
        "10 synchronized calls; two turns each, kernels / plain epilogues in the order "
        "K P P K): " + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()}))
    # the same calls' device time, from torch.profiler: all kernels, and the
    # convolutions alone, per call of 3
    from torch.autograd import DeviceType

    def kern(avg):
        return [e for e in avg if e.device_type == DeviceType.CUDA]

    def three_calls(n):
        with torch.inference_mode():
            for _ in range(3):
                n(crops)

    dev_ms = {}
    for name, n in (("f32", net32), ("bf16", net16)):
        avg = traced(lambda: three_calls(n), lambda a: len(kern(a)) > 0, f"{name} net")
        if avg is None:
            dev_ms[name] = "not measured"
            continue
        conv = sum(e.self_device_time_total for e in avg if e.device_type == DeviceType.CPU
                   and e.key == "aten::cudnn_convolution")
        dev_ms[name] = {"busy": round(sum(e.self_device_time_total for e in kern(avg)) / 3e3, 3),
                        "conv": round(conv / 3e3, 3),
                        "kernels": sum(e.count for e in kern(avg)) // 3}
    log("[bf16] full-width net device ms per call (8 crops, with K8 / K9): " + json.dumps(dev_ms))
    return t


# evaluation phase ---------------------------------------------------------------
EVAL_CONFIGS = [  # kp config rows: class, grip, spout, brand name, nutrition facts, bar code
    ("box_like", 0, 0, 1, 0, 1), ("cylinder_like", 1, 1, 0, 0, 0), ("hand_tool", 0, 0, 1, 1, 0),
    ("box_like", 1, 0, 0, 1, 0), ("cylinder_like", 0, 0, 1, 0, 1), ("hand_tool", 1, 1, 0, 0, 1),
    ("box_like", 0, 1, 1, 1, 0), ("cylinder_like", 0, 0, 0, 1, 1),
]
EVAL_VIEWS = 12


def write_png(path, img):
    """A PNG of a uint8 (gray or RGB) or uint16 (gray) array: zlib + numpy,
    one row filter (None)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    data = img.astype(">u2") if img.dtype == np.uint16 else img.astype(np.uint8)
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 16 if img.dtype == np.uint16 else 8,
                       0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


class EvalObjects:
    """The evaluation phase's 8 objects: the channels of their kp config rows
    (14-18 of the 41), keypoints and 6000 model points in a 100 mm cube;
    objects 1, 4 and 7 symmetric (a 180-degree turn about z), as in the
    SLAM phase."""

    def __init__(self, rng):
        from suo_slam_tpu_torch.kp import config as kp_config

        self.names = [kp_config.get_kps(c, *map(bool, f)) for c, *f in EVAL_CONFIGS]
        self.model_kps = np.zeros((N_OBJ, NK, 3), np.float32)
        self.masks = np.zeros((N_OBJ, NK), bool)
        self.points = []
        for o, names in enumerate(self.names):
            ch = np.array(sorted(names.values()))
            self.masks[o, ch] = True
            self.model_kps[o, ch] = rng.uniform(-50, 50, (len(ch), 3))
            self.points.append(rng.uniform(-50, 50, (6000, 3)).astype(np.float32))
        self.diameter = np.full((N_OBJ,), 100.0 * math.sqrt(3.0), np.float32)
        self.is_symmetric = np.zeros((N_OBJ,), bool)
        self.is_symmetric[[0, 3, 6]] = True


def write_bop_tree(root, objs, scene):
    """One YCB-V-layout BOP dataset under `root`: models_bop-compat (binary
    PLYs + models_info.json), kp_info, kp_configs, test/000000 with rgb,
    depth and mask PNGs and the scene JSONs, keyframe.txt."""
    import os
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    models = os.path.join(root, "models_bop-compat")
    for d in (models, os.path.join(root, "kp_info"), os.path.join(root, "kp_configs")):
        os.makedirs(d)
    info = {}
    for o in range(N_OBJ):
        pts = objs.points[o]
        with open(os.path.join(models, f"obj_{o + 1:06d}.ply"), "wb") as f:
            f.write(f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\nend_header\n"
                    .encode())
            f.write(pts.astype("<f4").tobytes())
        mi = {"diameter": float(objs.diameter[o])}
        if objs.is_symmetric[o]:
            mi["symmetries_discrete"] = [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]
        info[str(o + 1)] = mi
        kps = {n: {"pos_mean": objs.model_kps[o, ch].tolist(),
                   "pos_cov": np.eye(3).reshape(-1).tolist()}
               for n, ch in objs.names[o].items()}
        with open(os.path.join(root, "kp_info", f"obj_{o + 1:06d}_kp_info.json"), "w") as f:
            json.dump({"keypoints": kps, "view_pose": np.eye(4).reshape(-1).tolist()}, f)
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    with open(os.path.join(root, "kp_configs", "ycbv_kp_config.csv"), "w") as f:
        f.write("# instance,class,has_grip,has_spout,has_brand_name,has_nutrition_facts,"
                "has_bar_code\n")
        for o, (c, *fl) in enumerate(EVAL_CONFIGS):
            f.write(f"obj_{o + 1},{c},{','.join(map(str, fl))}\n")
    sdir = os.path.join(root, "test", "000000")
    for d in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(sdir, d))
    cams, gts, gt_infos, keyframes = {}, {}, {}, []
    for v in range(EVAL_VIEWS):
        T, bboxes, _ = scene.frame(v)
        img = np.full((H_IMG, W_IMG, 3), 40, np.uint8)
        depth = np.zeros((H_IMG, W_IMG), np.uint16)
        gts[str(v)], gt_infos[str(v)] = [], []
        for o in range(N_OBJ):
            x1, y1, x2, y2 = (int(round(c)) for c in bboxes[o])
            img[y1:y2, x1:x2] = (60 + 20 * o, 200 - 15 * o, 90 + 10 * o)
            depth[y1:y2, x1:x2] = int(T[o, 2, 3])
            mask = np.zeros((H_IMG, W_IMG), np.uint8)
            mask[y1:y2, x1:x2] = 255
            write_png(os.path.join(sdir, "mask_visib", f"{v:06d}_{o:06d}.png"), mask)
            gts[str(v)].append({"obj_id": o + 1, "cam_R_m2c": T[o, :3, :3].reshape(-1).tolist(),
                                "cam_t_m2c": T[o, :3, 3].tolist()})
            x1, y1, x2, y2 = (float(c) for c in bboxes[o])
            gt_infos[str(v)].append({"bbox_obj": [x1, y1, x2 - x1, y2 - y1],
                                     "bbox_visib": [x1, y1, x2 - x1, y2 - y1],
                                     "visib_fract": 1.0, "px_count_visib": 1000})
        write_png(os.path.join(sdir, "rgb", f"{v:06d}.png"), img)
        write_png(os.path.join(sdir, "depth", f"{v:06d}.png"), depth)
        cams[str(v)] = {"cam_K": YCBV_K.reshape(-1).tolist(), "depth_scale": 1.0,
                        "cam_R_w2c": scene.cams[v, :3, :3].reshape(-1).tolist(),
                        "cam_t_w2c": scene.cams[v, :3, 3].tolist()}
        keyframes.append(f"000000/{v:06d}")
    for name, d in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", gt_infos)):
        with open(os.path.join(sdir, f"{name}.json"), "w") as f:
            json.dump(d, f)
    with open(os.path.join(root, "keyframe.txt"), "w") as f:
        f.write("\n".join(keyframes) + "\n")


def phase_evaluate(dev, seed, net16):
    """The evaluation entry point on a BOP tree written here (see the module
    docstring, phase 7). Returns the kernel counts of the phase."""
    import contextlib
    import io
    import os
    import re

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.evaluate import Evaluator

    rng = np.random.default_rng(seed + 2)
    objs = EvalObjects(rng)
    scene = SlamScene(rng, objs, EVAL_VIEWS)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval")
    root = os.path.join(base, "bop_datasets", "ycbv")
    t0 = time.perf_counter()
    write_bop_tree(root, objs, scene)
    log(f"[eval] BOP tree of {EVAL_VIEWS} views x {N_OBJ} objects written in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels.reset_counts()
    out = {}
    for leg, kw in (("slam", dict(nviews=-1, debug_gt_kp=True)),
                    ("single_view_bf16", dict(nviews=1, net=net16))):
        ev = Evaluator("ycbv", root, "", detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev, **kw)
        ev.model_path = os.path.join(base, "results")
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summary = ev.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        if summary is None:
            raise AssertionError(f"evaluation leg {leg} failed:\n{text[-3000:]}")
        outdir = os.path.join(ev.model_path, ev.method_name())
        csv_path = os.path.join(outdir, ev.method_name() + ".csv")
        if not (os.path.isfile(os.path.join(outdir, "summary.txt")) and os.path.isfile(csv_path)):
            raise AssertionError(f"evaluation leg {leg}: summary.txt or the CSV is missing")
        rows = open(csv_path).read().splitlines()
        auc = float(re.search(r"AUC of ADD\(-S\): ([\d.]+)", text).group(1))
        cam = summary.get("cam_pose_pct")
        log(f"[eval] {leg}: {ev.method_name()}: AUC of ADD(-S) {auc:.1f}, ADD "
            f"{100 * summary['ours']['AUC of ADD']:.2f}, ADD-S "
            f"{100 * summary['ours']['AUC of ADD-S']:.2f}, camera poses found {cam}%, "
            f"{len(rows)} CSV rows; {wall:.2f} s for {EVAL_VIEWS} views = "
            f"{wall / EVAL_VIEWS * 1e3:.2f} ms per view (loading, engine and meter), tracking "
            f"{ev.object_slam.tracking_hz():.2f} Hz")
        out[leg] = (auc, cam, wall)
    counts = kernels.counts()
    log(f"[eval] launches over both legs: {json.dumps(counts)}")
    auc, cam, _ = out["slam"]
    if not (auc > 80.0 and cam == 100.0):
        raise AssertionError(f"evaluation (SLAM, GT keypoints): AUC {auc}, camera poses {cam}%")
    missing = [k for k in ("norm_relu", "upsample_add", "add_dists", "roi_crop",
                           "heatmap_readout", "pnp_ransac", "ba_lm") if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the evaluation path: {missing}, or "
                             f"K3 / K4 / K7 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    return counts


# int8 phase ---------------------------------------------------------------------
def _eval_root():
    import os

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval")
    return base, os.path.join(base, "bop_datasets", "ycbv")


def _int8_traffic(name, a, kw):
    """(bytes, int8 operations) a K11 / K12 / K13 call must move and do:
    each input read once, each output written once."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    x = a[0]
    if name == "int8_conv":
        qc = a[1]
        cout, kh, kw_, _ = qc.wq.shape
        Ho, Wo = ik.out_hw(x.shape[1], x.shape[2], qc)
        M = x.shape[0] * Ho * Wo
        out_b = 1 if kw.get("out_s8", a[4] if len(a) > 4 else False) else 2
        return (x.numel() + qc.wq.numel() + M * cout * out_b + 8 * cout,
                2.0 * M * cout * kh * kw_ * qc.cin)
    if name == "int8_quant":  # the prologue's operands, the input, the outputs
        xq = x.q if isinstance(x, ik.Deq) else x
        C = xq.shape[-1]
        n_out = (a[1] is not None) + (len(a) > 2 and a[2] is not None)
        nb = xq.numel() * xq.element_size() + n_out * (xq.numel() // C) * (kw.get("c_out") or C)
        if kw.get("x2") is not None:
            nb += xq.numel()
        if kw.get("add") is not None:
            nb += kw["add"].numel() * kw["add"].element_size()
        return nb, 0.0
    if name == "int8_maxpool":
        return x.numel() * 1.25, 0.0
    return x.numel() * 3.25, 0.0  # the junction: up1, low, bf16 out


def _quant_mode(a, kw):
    """A K12 call's mode: its input ("f32", "bf16", "s8", or the prologue
    "deq[+deq][+tensor|+vector]") and outputs ("raw", "norm", "pair"), with
    "padded" where it writes wider rows."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    x = a[0]
    if isinstance(x, ik.Deq):
        src = "deq" + ("+deq" if kw.get("x2") is not None else "")
        add = kw.get("add")
        if add is not None:
            src += "+vector" if add.dim() == 1 else "+tensor"
    else:
        src = str(x.dtype).replace("torch.", "").replace("bfloat16", "bf16").replace(
            "float32", "f32").replace("int8", "s8")
    raw, norm = a[1] is not None, len(a) > 2 and a[2] is not None
    out = "pair" if raw and norm else "raw" if raw else "norm"
    C = (x.q if isinstance(x, ik.Deq) else x).shape[-1]
    return f"{src} {out}" + (" padded" if (kw.get("c_out") or C) != C else "")


def _int8_calls(run, traffic=None):
    """`run()` with the int8 kernel entry points spied: the arguments of the
    first call of each distinct shape (K11 by input and weight shape and
    epilogue, K12 by input dtype, shape and outputs, K13 by shape); every
    call's (bytes, operations) go to `traffic` when given."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    names = ("int8_conv", "int8_quant", "int8_maxpool", "int8_upsample_add")
    orig = {n: getattr(ik, n) for n in names}
    seen = {}

    def key(name, a, kw):
        x = a[0]
        if name == "int8_conv":
            return (name, tuple(x.shape), tuple(a[1].wq.shape), a[1].stride,
                    bool(kw.get("out_s8", a[4] if len(a) > 4 else False)))
        if name == "int8_quant":
            return (name, _quant_mode(a, kw), tuple((x.q if isinstance(x, ik.Deq) else x).shape))
        return (name, tuple(x.shape))

    def spy(name):
        def f(*a, **kw):
            seen.setdefault(key(name, a, kw), (a, kw))
            if traffic is not None:
                traffic.append((name,) + _int8_traffic(name, a, kw))
            return orig[name](*a, **kw)
        return f

    try:
        for n in names:
            setattr(ik, n, spy(n))
        run()
    finally:
        for n, f in orig.items():
            setattr(ik, n, f)
    return seen


def _im2col(x, kh, kw, pad, cin_p):
    """[N, H, W, C] s8 -> [N*H*W, kh*kw*cin_p] patches in the K11 weights'
    (r, s, c) order (stride 1, channels zero-padded to cin_p), for the
    library GEMM yardstick."""
    import torch
    import torch.nn.functional as F

    N, H, W, C = x.shape
    xp = F.pad(x, (0, cin_p - C, pad, pad, pad, pad))
    cols = [xp[:, r:r + H, s:s + W] for r in range(kh) for s in range(kw)]
    return torch.cat(cols, dim=-1).reshape(N * H * W, kh * kw * cin_p)


def _int_mm(x, qc, M):
    """`torch._int_mm` (cuBLASLt s8 GEMM) on the convolution's GEMM as a
    function, or None where its shape rules (M > 16, K and N multiples of 8)
    or the layout refuse it; the im2col of a 3x3 input is made here, before
    any clock."""
    import torch

    cout, kh, kw, cin_p = qc.wq.shape
    if qc.stride != 1 or M <= 16 or cin_p % 8 or cout % 8:
        return None
    A = x.reshape(M, -1) if kh == 1 and x.shape[-1] == cin_p else _im2col(x, kh, kw, qc.pad,
                                                                         cin_p)
    B = qc.wq.reshape(cout, -1).t()
    try:
        torch._int_mm(A, B)
    except RuntimeError as e:
        log(f"[kernel] torch._int_mm refused [{M}, {A.shape[1]}] x [{B.shape[0]}, {cout}]: {e}")
        return None
    return lambda: torch._int_mm(A, B)


def check_k11(dev, calls, label="8 crops", stem=True, time_plain=True):
    """K11 at every distinct convolution of one forward (their real codes
    and epilogue vectors) and, with `stem`, the concat stem's 7x7 stride-2
    prior convolution: equal bf16 bits / s8 codes, each call's route from
    `plan_conv`; times, device times, bounds (int8 operations or bytes) and
    `torch._int_mm` on the same s8 GEMM (1x1: the activations as [M, Cin];
    3x3: an im2col of them, made before the clock), its wrapper and device
    time. Returns the JSON row (8 crops) and the per-shape numbers."""
    import torch

    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.models import int8_kernels as ik

    convs = [(k, v) for k, v in calls.items() if k[0] == "int8_conv"]
    if stem:
        g = torch.Generator(device=dev).manual_seed(12)
        qs = i8.quantize_conv(torch.nn.Conv2d(44, 64, 7, 2, 3).to(dev), 3, dev)
        xp = torch.randint(0, 128, (N_OBJ, 256, 256, 48), device=dev, generator=g,
                           dtype=torch.int32).to(torch.int8)
        xp[..., 41:] = 0  # as K12 writes the prior: 41 channels in 48-wide rows
        e1 = torch.full((64,), 1e-4, device=dev).to(torch.bfloat16).float()
        convs.append((("int8_conv", tuple(xp.shape), tuple(qs.wq.shape), 2, False),
                      ((xp, qs, e1, torch.zeros(64, device=dev), False), {})))
    rows, routes = [], {}
    for key, (a, kw) in convs:
        x, qc, e1, e2 = a[:4]
        out_s8 = kw.get("out_s8", a[4] if len(a) > 4 else False)
        cout, kh, kwd, cin_p = qc.wq.shape
        plan = ik.plan_conv(x.shape[0], x.shape[1], x.shape[2], cin_p, cout, kh, kwd,
                            qc.stride, qc.pad)
        k = ik._int8_conv_cuda(x, qc, e1, e2, out_s8)
        p = ik.int8_conv_plain(x, qc, e1, e2, out_s8)
        torch.cuda.synchronize()
        if not (k.dtype == p.dtype and torch.equal(k, p)):
            raise AssertionError(f"K11 disagrees with its plain version at {key} ({label}): "
                                 f"{(k.float() - p.float()).abs().max().item()}")
        del k, p
        Ho, Wo = ik.out_hw(x.shape[1], x.shape[2], qc)
        M = x.shape[0] * Ho * Wo
        b = bound(*_int8_traffic("int8_conv", a, kw), INT8_OPS_PER_S)
        routes[f"{kh}x{kwd} s{qc.stride} {list(x.shape)}"] = (plan.route, plan.tile)
        rows.append((key, x, qc, e1, e2, out_s8, M, b))
    log(f"[kernel] K11 ({label}) routes and pixel tiles: " + json.dumps(
        {k: f"{r} {list(t)}" for k, (r, t) in routes.items()}))
    if stem and routes.pop(next(k for k in routes if " s2 " in k))[0] != "mma_sync":
        raise AssertionError("K11: the stride-2 stem convolution left its mma.sync route")
    if any(r != "wgmma" for r, _ in routes.values()):
        raise AssertionError(f"K11 ({label}): a stride-1 convolution is not on the wgmma route")
    # time one call of each distinct weight shape at its largest input
    best = {}
    for r in rows:
        wk = (r[0][2], r[0][3])
        if wk not in best or r[6] > best[wk][6]:
            best[wk] = r
    out = {}
    for wk, (key, x, qc, e1, e2, out_s8, M, b) in sorted(best.items(), key=lambda t: -t[1][6]):
        f = lambda: ik._int8_conv_cuda(x, qc, e1, e2, out_s8)
        ms = cuda_ms(f, n=10, inner=5)
        plain_ms = (cuda_ms(lambda: ik.int8_conv_plain(x, qc, e1, e2, out_s8), n=3, inner=2,
                            warmup=1) if time_plain else None)
        us, src = device_us(f, "int8_conv_kernel", n=5)
        cout, kh, kwd, cin_p = qc.wq.shape
        lib = _int_mm(x, qc, M)
        lib_ms = cuda_ms(lib, n=10, inner=5) if lib else None
        lib_us = lib_device_us(lib) if lib else (None, None)
        del lib
        name = (f"{kh}x{kwd} {x.shape[-1]}->{cout} s{qc.stride} on {list(x.shape)} "
                f"{'s8' if out_s8 else 'bf16'} out")
        lib_txt = ("n/a" if lib_ms is None
                   else f"{lib_ms:.4f} ms, device {lib_us[0]:.3f} us by {lib_us[1]}")
        log(f"[kernel] K11 int8_conv ({label}, {name}): bit-equal | kernel {ms:.4f} ms, device "
            f"{us:.3f} us by {src} | plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'} | torch._int_mm "
            f"{lib_txt} | bound {b[0]:.5f} ms ({b[1]})")
        out[name] = (ms, us, plain_ms, lib_ms, b, lib_us[0])
    log(f"[kernel] K11 ({label}): {len(rows)} distinct convolution calls bit-equal to the plain "
        f"version, {len(best)} weight shapes timed")
    # the JSON row: the forward's own convolution with the most operations
    # (3x3 128->128 at 64x64 at full width), not the concat stem's
    name = max((n for n in out if " s1 " in n),
               key=lambda n: out[n][4][0] if out[n][4][1] == "operations" else 0)
    ms, us, plain_ms, lib_ms, b, _ = out[name]
    return dict(name="int8_conv", route="cuda", source="suo_slam_tpu_torch/csrc/int8_conv.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:254", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms), out


def check_k12(dev, calls, label="8 crops", time_plain=True):
    """K12 in every mode the forward used (f32 / bf16 / s8 input or a
    prologue of s8 operands; raw, normalised or both outputs; padded rows),
    on its real inputs: equal codes; wrapper and device times at each mode's
    largest call."""
    import torch

    from suo_slam_tpu_torch.models import int8_kernels as ik

    res = {}
    for key, (a, kw) in calls.items():
        if key[0] != "int8_quant":
            continue
        k = ik._int8_quant_cuda(*a, **kw)
        p = ik.int8_quant_plain(*a, **kw)
        torch.cuda.synchronize()
        if not all((u is None and v is None) or torch.equal(u, v) for u, v in zip(k, p)):
            raise AssertionError(f"K12 disagrees with its plain version at {key} ({label})")
        b = bound(*_int8_traffic("int8_quant", a, kw))
        n = key[2]
        if key[1] not in res or np.prod(n) > np.prod(res[key[1]][0]):
            res[key[1]] = (n, a, kw, b)
    out = {}
    for mode, (shape, a, kw, b) in res.items():
        f = lambda: ik._int8_quant_cuda(*a, **kw)
        ms = cuda_ms(f, n=10, inner=5)
        plain_ms = (cuda_ms(lambda: ik.int8_quant_plain(*a, **kw), n=5, inner=2)
                    if time_plain else None)
        us, src = device_us(f, "int8_quant_kernel", n=5)
        log(f"[kernel] K12 int8_quant ({label}, {mode}, {list(shape)}): bit-equal | kernel "
            f"{ms:.4f} ms, device {us:.3f} us by {src} | plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'} | bound "
            f"{b[0]:.5f} ms ({b[1]})")
        out[mode] = (ms, plain_ms, b, int(np.prod(shape)), us)
    log(f"[kernel] K12 ({label}): {len(res)} modes bit-equal to the plain version")
    key = max(out, key=lambda k: (k.endswith("pair"), k.startswith("deq"), out[k][3]))
    ms, plain_ms, b, _, _ = out[key]
    return dict(name="int8_quant", route="cuda", source="suo_slam_tpu_torch/csrc/int8_quant.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:223", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None), out


def check_k13(dev, calls):
    """K13's pool and junction at every level of the forward, on their real
    codes: equal codes / bf16 bits."""
    import torch

    from suo_slam_tpu_torch.models import int8_kernels as ik

    out = {}
    for key, (a, kw) in sorted(calls.items(), key=lambda t: str(t[0])):
        if key[0] == "int8_maxpool":
            kf, pf = ik._int8_maxpool_cuda, ik.int8_maxpool_plain
        elif key[0] == "int8_upsample_add":
            kf, pf = ik._int8_upsample_add_cuda, ik.int8_upsample_add_plain
        else:
            continue
        k, p = kf(*a), pf(*a)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K13 disagrees with its plain version at {key}")
        b = bound(*_int8_traffic(key[0], a, kw))
        ms = cuda_ms(lambda: kf(*a), n=10, inner=5)
        plain_ms = cuda_ms(lambda: pf(*a), n=5, inner=2)
        us, src = device_us(lambda: kf(*a), "int8_pool_junction_kernel", n=5)
        kind = "junction" if key[0] == "int8_upsample_add" else "max-pool"
        _report(f"K13 {kind} ({list(a[0].shape)}, device {us:.3f} us by {src})", 0.0,
                "0 (bit-equal)", ms, plain_ms, None, b)
        out[(kind, a[0].numel())] = (ms, plain_ms, b)
    key = max((k for k in out if k[0] == "junction"), key=lambda k: k[1])
    ms, plain_ms, b = out[key]
    return dict(name="int8_pool_junction", route="cuda",
                source="suo_slam_tpu_torch/csrc/int8_pool_junction.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:292", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def check_k2_bf16(dev, raw16):
    """K2 on the int8 net's bf16 logits against its plain version."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    k = hm._heatmap_readout_cuda(raw16, 1e-6)
    p = hm.heatmap_readout_plain(raw16, 1e-6)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(k, p))
    ms = cuda_ms(lambda: hm._heatmap_readout_cuda(raw16, 1e-6))
    plain_ms = cuda_ms(lambda: hm.heatmap_readout_plain(raw16, 1e-6))
    us, src = device_us(lambda: hm._heatmap_readout_cuda(raw16, 1e-6), "heatmap_readout_kernel")
    n = raw16.numel()
    b = bound(n * 2 + N_OBJ * NK * 7 * 4, n * 24)
    _report(f"K2 heatmap_readout (bf16 logits {list(raw16.shape)}, device {us:.3f} us by {src})",
            err, 1e-5, ms, plain_ms, None, b)
    if not err <= 1e-5:
        raise AssertionError(f"K2 on bf16 logits disagrees with its plain version: {err}")
    return err


def _with_plain_int8(fn):
    """fn() with the int8 wrappers routing CUDA tensors through the plain
    versions instead of K11-K13."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    ops = ("conv", "quant", "maxpool", "upsample_add")
    kernels = {op: getattr(ik, f"_int8_{op}_cuda") for op in ops}
    try:
        for op in ops:
            setattr(ik, f"_int8_{op}_cuda", getattr(ik, f"int8_{op}_plain"))
        return fn()
    finally:
        for op, f in kernels.items():
            setattr(ik, f"_int8_{op}_cuda", f)


def _net_device_ms(nets, n_crops, calls=3):
    """Device ms per call of each net in `nets` (name -> call) from one
    torch.profiler trace of `calls` calls: busy time, crops per second of
    device time, kernels per call, the port's kernels and the torch
    operations that hold the most device time."""
    from torch.autograd import DeviceType

    dev_ms = {}
    for name, f in nets.items():
        avg = traced(lambda: [f() for _ in range(calls)], lambda a: any(
            e.device_type == DeviceType.CUDA for e in a), f"{name} net")
        if avg is None:
            dev_ms[name] = "not measured"
            continue
        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        by = {k: sum(e.self_device_time_total for e in kern if f"{k}_kernel" in e.key)
              / (1e3 * calls) for k in INT8_KERNELS + ("heatmap_readout", "norm_relu",
                                                       "upsample_add")}
        ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)[:6]
        busy = sum(e.self_device_time_total for e in kern) / (1e3 * calls)
        dev_ms[name] = {"busy": round(busy, 4), "crops/s": round(n_crops / busy * 1e3, 1),
                        "kernels": sum(e.count for e in kern) // calls,
                        "by kernel": {k: round(v, 4) for k, v in by.items() if v},
                        "by torch operation": {
                            e.key: round(e.self_device_time_total / (1e3 * calls), 4)
                            for e in ops}}
    return dev_ms


def _int8_128(dev, seed, net16, qw, scales, n=128):
    """Phase 8 at the JAX bench's batch, 128 crops: launches per prior-free
    forward, K11 at every distinct convolution and K12 in every mode
    bit-equal to their plain versions on the forward's own inputs (kernel
    and device times; the plain versions are not timed), then the int8 and
    bf16 nets' device ms per call and crops/s."""
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import int8_forward as i8

    g = torch.Generator(device=dev).manual_seed(seed + 128)
    crops = torch.rand((n, 256, 256, 3), device=dev, generator=g)
    apply_np = i8.make_int8_apply(net16, no_prior=True)
    f = lambda: apply_np(qw, scales, crops)
    f()
    torch.cuda.synchronize()
    kernels.reset_counts()
    f()
    torch.cuda.synchronize()
    c = kernels.counts()
    c = {k: c[k] for k in INT8_KERNELS + ("heatmap_readout",)}
    log(f"[int8 {n}] launches per prior-free forward ({n} crops): {json.dumps(c)}")
    if (c["int8_conv"], c["int8_quant"], c["int8_pool_junction"]) != (185, 84, 17):
        raise AssertionError(f"int8 launches per forward at {n} crops: {c}")
    calls = _int8_calls(f)
    check_k11(dev, calls, f"{n} crops", stem=False, time_plain=False)
    check_k12(dev, calls, f"{n} crops", time_plain=False)
    del calls
    torch.cuda.empty_cache()

    def bf16_call():
        with torch.inference_mode():
            return net16(crops)

    log(f"[int8 {n}] full-width net device ms per call ({n} crops, 256x256, backbone + "
        f"readout, prior-free int8 and bf16): "
        + json.dumps(_net_device_ms({"int8": f, "bf16": bf16_call}, n)))
    del crops
    torch.cuda.empty_cache()


def phase_int8(dev, rng, seed, net32, net16, crops, objs, scene):
    """int8 serving on the card (the module docstring's phase 8). Returns the
    kernels' JSON entries and the launches of the int8 path's runs."""
    import contextlib
    import io
    import os

    import torch

    from suo_slam_tpu_torch import calibrate_int8 as ci8
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.evaluate import Evaluator
    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    t0 = time.perf_counter()
    scales = i8.calibrate(net16, [crops])  # the worst-case all-ones prior
    qw = i8.quantize_weights(net16)
    apply, apply_np = i8.make_int8_apply(net16), i8.make_int8_apply(net16, no_prior=True)
    uv0 = torch.from_numpy(rng.uniform(-0.8, 0.8, (N_OBJ, NK, 2)).astype(np.float32)).to(dev)
    pv = torch.from_numpy(rng.uniform(size=(N_OBJ, NK)) < 0.4).to(dev)
    prior = hm.render_prior_heatmaps(uv0, pv, (64, 64), hm.prior_sigma_for((64, 64)))
    torch.cuda.synchronize()
    log(f"[int8] calibration ({len(scales)} points) and weight quantization "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    # launches per forward, then every distinct kernel call of a forward
    per_fwd = {}
    for name, f in (("with prior", lambda: apply(qw, scales, crops, prior)),
                    ("prior-free", lambda: apply_np(qw, scales, crops))):
        f()
        torch.cuda.synchronize()
        kernels.reset_counts()
        f()
        torch.cuda.synchronize()
        c = kernels.counts()
        per_fwd[name] = {k: c[k] for k in INT8_KERNELS + ("heatmap_readout",)}
    log(f"[int8] launches per forward (8 crops): {json.dumps(per_fwd)}")
    want = {"with prior": (186, 85), "prior-free": (185, 84)}
    for name, c in per_fwd.items():
        if (c["int8_conv"], c["int8_quant"], c["int8_pool_junction"],
                c["heatmap_readout"]) != want[name] + (17, 1):
            raise AssertionError(f"int8 launches per forward ({name}): {c}")
    calls, traffic = {}, []
    calls.update(_int8_calls(lambda: apply(qw, scales, crops, prior)))
    calls.update(_int8_calls(lambda: apply_np(qw, scales, crops), traffic))
    tot = {}
    for name, nb, ops in traffic:
        t = tot.setdefault(name, [0, 0.0, 0.0, 0.0])
        t[0] += 1
        t[1] += nb
        t[2] += ops
        t[3] += bound(nb, ops, INT8_OPS_PER_S)[0]
    log("[int8] the prior-free forward's K11-K13 calls (8 crops): calls, GB, G int8 "
        "operations and the sum of their bounds in ms: " + json.dumps(
            {k: [v[0], round(v[1] / 1e9, 4), round(v[2] / 1e9, 3), round(v[3], 4)]
             for k, v in tot.items()})
        + f"; total bound {sum(v[3] for v in tot.values()):.4f} ms")
    (k11, _), (k12, _) = check_k11(dev, calls), check_k12(dev, calls)
    entries = [k11, k12, check_k13(dev, calls)]
    del calls
    # the whole net: kernels against plain versions on the card, then against f32
    o8 = apply(qw, scales, crops, prior)
    o8p = _with_plain_int8(lambda: apply(qw, scales, crops, prior))
    torch.cuda.synchronize()
    if not torch.equal(o8.prob_logits, o8p.prob_logits):
        d = (o8.prob_logits.float() - o8p.prob_logits.float()).abs()
        raise AssertionError(f"int8 net: kernels and plain versions differ on "
                             f"{int((d > 0).sum())} logits (max {d.max().item()})")
    k2_err = check_k2_bf16(dev, o8.prob_logits)
    with torch.inference_mode():
        o32 = net32(crops, prior)
    cpu16 = full_width_net(seed, torch.bfloat16).eval()
    cpu32 = full_width_net(seed).eval()
    c2, p2 = crops[:2].cpu(), prior[:2].cpu()
    oc8 = i8.make_int8_apply(cpu16)(None, scales, c2, p2)
    with torch.inference_mode():
        oc32 = cpu32(c2, p2)
    gap = (o8.uv[:2].cpu() - o32.uv[:2].cpu()).abs()
    ref = (oc8.uv - oc32.uv).abs()
    card_all = (o8.uv - o32.uv).abs()
    same = torch.equal(o8.prob_logits[:2].cpu(), oc8.prob_logits)
    log(f"[int8] int8 net (8 crops, with prior) equal to its plain-version run on the card: "
        f"logits equal, uv max diff {(o8.uv - o8p.uv).abs().max().item():.2e}; uv |int8 - f32| "
        f"on the card: max {card_all.max().item():.4f} mean {card_all.mean().item():.5f} NDC; "
        f"the 2 crops: card max {gap.max().item():.4f} mean {gap.mean().item():.5f}, CPU max "
        f"{ref.max().item():.4f} mean {ref.mean().item():.5f} (gate 1.5x the CPU's); card and "
        f"CPU int8 logits equal: {same}")
    if not (torch.isfinite(o8.uv).all() and torch.isfinite(o8.cov).all()):
        raise AssertionError("int8 net: non-finite outputs")
    if not (gap.max() <= 1.5 * ref.max() and gap.mean() <= 1.5 * ref.mean()):
        raise AssertionError("int8 net on the card: uv farther from f32 than the CPU's int8 net")

    # host ms per call, int8 (prior-free program, as the frame's
    # non-symmetric group) and bf16 in turns (I B B I), and device ms
    def wall_ms(f, reps=10):
        vals = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                f()
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(vals[1:])

    def bf16_call():
        with torch.inference_mode():
            return net16(crops)

    nets = {"int8": lambda: apply_np(qw, scales, crops), "bf16": bf16_call}
    t = {}
    for turn in ("int8", "bf16", "bf16", "int8"):
        t.setdefault(turn, []).append(wall_ms(nets[turn]))
    log("[int8] full-width net ms per call (8 crops, 256x256, backbone + readout, prior-free; "
        "median of 10 synchronized calls, turns I B B I): "
        + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()})
        + "; device ms per call: " + json.dumps(_net_device_ms(nets, N_OBJ)))
    _int8_128(dev, seed, net16, qw, scales)

    # the evaluation entry point with a sidecar from calibrate_int8, then a
    # short SLAM run; the int8 path's launches
    base, root = _eval_root()
    ds = BopDataset(root, "test", bop_dset="ycbv", ignore_symmetry=True,
                    kp_config_root=os.path.join(root, "kp_configs"))
    sc, n_frames, n_crops = ci8.calibrate_dataset(net16, ds, n_frames=EVAL_VIEWS, device=dev)
    side = os.path.join(base, "int8_scales.npz")
    i8.save_scales(side, sc)
    log(f"[int8] calibrate_int8: {len(sc)} scales from {n_crops} crops of {n_frames} frames "
        f"-> {side}")
    kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, "", nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev, net=net16,
                       int8=True, int8_scales=side)
    ev.model_path = os.path.join(base, "results_int8")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = ev.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    text = buf.getvalue()
    outdir = os.path.join(ev.model_path, ev.method_name())
    if summary is None or f"int8 scales sidecar: {side}" not in text or not os.path.isfile(
            os.path.join(outdir, "summary.txt")):
        raise AssertionError(f"int8 evaluation leg failed:\n{text[-3000:]}")
    log(f"[int8] Evaluator(nviews=1, int8=True): {ev.method_name()} ran to its end, "
        f"{wall / EVAL_VIEWS * 1e3:.2f} ms per view over {EVAL_VIEWS} views; launches "
        + json.dumps({k: v for k, v in kernels.counts().items() if v}))
    engine = ObjectSlam(SlamConfig(int8_inference=True, int8_calib_frames=2), mesh_db=objs,
                        net=net16, device=dev)
    inf = GtPriorInfer(engine._infer, dev, seed)
    engine._infer = inf
    img = rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    ids = np.arange(1, N_OBJ + 1)
    times, ok = [], []
    before = kernels.counts()
    for i in range(6):
        T_OtoC, bboxes, uv_gt = scene.frame(i)
        inf.set_frame(bboxes, uv_gt)
        t1 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks,
                            objs.masks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    results = engine.collect_results(final=True)
    counts = kernels.counts()
    for i in range(6):
        T_OtoC, _, _ = scene.frame(i)
        for o in range(N_OBJ):
            p = results[i]["poses"].get(o + 1, {}).get("T_OtoC")
            ok.append(p is not None and np.isfinite(p).all() and _add_ok(p, T_OtoC[o], objs, o))
    state = inf.fn.int8_state
    slam_counts = {k: counts[k] - before[k] for k in counts}
    log(f"[int8] SLAM, 6 frames, int8_calib_frames=2: {inf.n_prior_calls} with-prior int8 "
        f"calls, {state['n_calib']} calibration frames; ms per frame "
        f"{[round(x, 2) for x in times]}; ADD < 0.1 d for {float(np.mean(ok)):.3f} of "
        f"{len(ok)} poses; launches " + json.dumps({k: v for k, v in slam_counts.items() if v}))
    if inf.n_prior_calls == 0 or slam_counts["prior_render"] == 0 or state["n_calib"] != 2:
        raise AssertionError("int8 SLAM run: no with-prior int8 call, no K5 or no calibration")
    if float(np.mean(ok)) < 0.9:
        raise AssertionError(f"int8 SLAM run: ADD < 0.1 d for only {np.mean(ok):.3f}")
    missing = [k for k in INT8_KERNELS + ("roi_crop", "heatmap_readout", "prior_render",
                                          "pnp_ransac") if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the int8 path: {missing}, or K3 / K4 / "
                             f"K7 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    return entries, counts, k2_err


# training phase ------------------------------------------------------------------
TRAIN_VIEWS = 40  # YCB-V train_real keeps every 5th frame: 8 training frames
TRAIN_N = 16  # rows of the kernel checks' tensors (the CLI's step has 2 x 16)
# the train step's expected launches per forward (2 stacks x 2 modules x 256)
NORMS_PER_FWD, JUNCTIONS_PER_FWD = 180, 8


def write_train_split(root, objs, rng):
    """`train_real` beside phase 7's test split: TRAIN_VIEWS 480x640 PNG views
    with the YCB-V intrinsics, each a random 5-8 of the eight objects (so a
    batch pads its object slots), on phase 7's camera orbit."""
    import os

    scene = SlamScene(rng, objs, TRAIN_VIEWS)
    sdir = os.path.join(root, "train_real", "000000")
    for d in ("rgb", "mask_visib"):
        os.makedirs(os.path.join(sdir, d), exist_ok=True)
    cams, gts, gt_infos = {}, {}, {}
    for v in range(TRAIN_VIEWS):
        T, bboxes, _ = scene.frame(v)
        keep = np.sort(rng.choice(N_OBJ, int(rng.integers(5, N_OBJ + 1)), replace=False))
        img = np.full((H_IMG, W_IMG, 3), 40, np.uint8)
        gts[str(v)], gt_infos[str(v)] = [], []
        for o in keep:
            x1, y1, x2, y2 = (int(round(c)) for c in bboxes[o])
            img[y1:y2, x1:x2] = (60 + 20 * o, 200 - 15 * o, 90 + 10 * o)
            gts[str(v)].append({"obj_id": int(o) + 1,
                                "cam_R_m2c": T[o, :3, :3].reshape(-1).tolist(),
                                "cam_t_m2c": T[o, :3, 3].tolist()})
            x1, y1, x2, y2 = (float(c) for c in bboxes[o])
            gt_infos[str(v)].append({"bbox_obj": [x1, y1, x2 - x1, y2 - y1],
                                     "bbox_visib": [x1, y1, x2 - x1, y2 - y1],
                                     "visib_fract": 1.0, "px_count_visib": 1000})
        write_png(os.path.join(sdir, "rgb", f"{v:06d}.png"), img)
        cams[str(v)] = {"cam_K": YCBV_K.reshape(-1).tolist(), "depth_scale": 1.0}
    for name, d in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", gt_infos)):
        with open(os.path.join(sdir, f"{name}.json"), "w") as f:
            json.dump(d, f)


def _row_mask(dev):
    """TRAIN_N rows with every fourth one a padded slot."""
    import torch

    return torch.arange(TRAIN_N, device=dev) % 4 != 3


def check_k16_k17(dev, rng):
    """K16 (masked batch statistics) and K17 (the norm + ReLU backward, with
    the statistics' terms) at the train step's norm shapes, N = 16 rows of
    which 4 padded, f32 and bf16: the stem norm (64 ch at 128x128), the
    largest residual norm (256 ch at 64x64) and a bottleneck norm (128 ch at
    64x64). Statistics within 1e-6 relative (f64 sums in another order),
    K17's sums within 1e-5 of their scale, dx within 1e-5 of its largest
    magnitude in f32 and 1 bf16 ulp of it in bf16. Times at the largest
    shape; the library yardstick is F.batch_norm(training=True) + relu,
    forward (K16 + K8's work) and backward (K17's)."""
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models import hourglass as hg

    mask = _row_mask(dev)
    shapes = [(TRAIN_N, 64, 128, 128), (TRAIN_N, 256, 64, 64), (TRAIN_N, 128, 64, 64)]
    err = {"stats": 0.0, "sums": 0.0, "dx f32": 0.0, "dx bf16": 0.0}
    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    for shape in shapes:
        C = shape[1]
        x32 = cl((rng.normal(size=shape) * 1.5 + rng.normal(size=(1, C, 1, 1))).astype(np.float32))
        dy32 = cl(rng.normal(size=shape).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            mk, vk = hg._bn_stats_cuda(x, mask)
            mp, vp = hg.bn_stats_plain(x, mask)
            torch.cuda.synchronize()
            err["stats"] = max(err["stats"], ((mk - mp).abs() / mp.abs().clamp(min=1e-3)).max().item(),
                               ((vk - vp).abs() / vp.abs().clamp(min=1e-3)).max().item())
            scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
            rstd = torch.rsqrt(vp + 1e-5)
            inv = rstd * scale
            shift = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev) * 0.3 - mp * inv
            k = hg._norm_relu_bwd_cuda(x, dy, inv, shift, mp, rstd, mask)
            p = hg.norm_relu_bwd_plain(x, dy, inv, shift, mp, rstd, mask)
            torch.cuda.synchronize()
            for a, b in zip(k[1:], p[1:]):
                err["sums"] = max(err["sums"], (a - b).abs().max().item()
                                  / max(b.abs().max().item(), 1.0))
            key = "dx f32" if dt == torch.float32 else "dx bf16"
            err[key] = max(err[key], (k[0].float() - p[0].float()).abs().max().item()
                           / p[0].float().abs().max().item())
    log(f"[train] K16 / K17 errors over {len(shapes)} shapes, f32 and bf16, 4 of 16 rows "
        f"padded: " + json.dumps({k: f"{v:.3e}" for k, v in err.items()})
        + " (tol: stats 1e-6 relative, sums 1e-5 of scale, dx f32 1e-5 of max, bf16 2^-8)")
    if not (err["stats"] <= 1e-6 and err["sums"] <= 1e-5 and err["dx f32"] <= 1e-5
            and err["dx bf16"] <= 2.0 ** -8):
        raise AssertionError(f"K16 / K17 disagree with their plain versions: {err}")
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = cl((rng.normal(size=shapes[1]) * 1.5).astype(np.float32)).to(dt)
        dy = cl(rng.normal(size=shapes[1]).astype(np.float32)).to(dt)
        mp, vp = hg.bn_stats_plain(x, mask)
        rstd = torch.rsqrt(vp + 1e-5)
        inv, shift = rstd, -mp * rstd
        w = torch.ones(256, device=dev, requires_grad=True)
        bb = torch.zeros(256, device=dev, requires_grad=True)
        xg = x.detach().requires_grad_(True)
        y = torch.relu(F.batch_norm(xg, None, None, w, bb, training=True))
        dyl = dy.contiguous()
        k16 = lambda: hg._bn_stats_cuda(x, mask)
        k17 = lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mp, rstd, mask)
        lib16 = lambda: torch.relu(F.batch_norm(x, None, None, None, None, training=True))
        lib17 = lambda: torch.autograd.grad(y, (xg, w, bb), dyl, retain_graph=True)
        n = x.numel()
        es = x.element_size()
        res = {}
        for label, fn, plain, lib, nbytes, ops in (
                ("K16 bn_stats", k16, lambda: hg.bn_stats_plain(x, mask), lib16,
                 n * es + 2 * 256 * 4, 3 * n),
                ("K17 norm_relu_bwd", k17,
                 lambda: hg.norm_relu_bwd_plain(x, dy, inv, shift, mp, rstd, mask), lib17,
                 3 * n * es + 6 * 256 * 4, 12 * n)):
            ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(plain, n=5, inner=2), cuda_ms(lib)
            us, src = lib_device_us(fn)
            b = bound(nbytes, ops)
            _report(f"{label} ({name}, {list(x.shape)}, 4 of 16 rows padded, device {us:.3f} us "
                    f"by {src})", err["stats"] if label.startswith("K16") else err[f"dx {name}"],
                    "1e-6 rel" if label.startswith("K16") else
                    ("1e-5 of max" if name == "f32" else "2^-8 of max"),
                    ms, plain_ms, lib_ms, b, lib)
            res[label] = (ms, plain_ms, lib_ms, b, us)
        out[name] = res
    entries = []
    for label, kname, src, rep in (
            ("K16 bn_stats", "bn_stats", "suo_slam_tpu_torch/csrc/bn_train.cu",
             "suo_slam_tpu/models/hourglass.py:69"),
            ("K17 norm_relu_bwd", "norm_relu_bwd", "suo_slam_tpu_torch/csrc/bn_train.cu",
             "suo_slam_tpu/models/hourglass.py:88")):
        ms, plain_ms, lib_ms, b, us = out["bf16"][label]
        entries.append(dict(name=kname, route="cuda", source=src, replaces=rep,
                            max_abs_err=err["stats"] if kname == "bn_stats" else err["dx bf16"],
                            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                            library_ms=lib_ms))
    return entries


def check_k18(dev, rng):
    """K18 at each junction of the train step (up1 [16, 256, H, H] for H =
    64, 32, 16, 8), f32 and bf16: equal to its plain version (same f32
    additions in the same order, one rounding). Library: 4 x
    F.avg_pool2d(dy, 2)."""
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models import hourglass as hg

    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    err = 0.0
    for H in (64, 32, 16, 8):
        dy32 = cl(rng.normal(size=(TRAIN_N, 256, H, H)).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            dy = dy32.to(dt)
            k, p = hg._upsample_add_bwd_cuda(dy), hg.upsample_add_bwd_plain(dy)
            torch.cuda.synchronize()
            err = max(err, (k.float() - p.float()).abs().max().item())
    log(f"[train] K18 max abs err over 4 levels, f32 and bf16: {err:.3e} (tol 0)")
    if err != 0.0:
        raise AssertionError(f"K18 disagrees with its plain version: {err}")
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        dy = cl(rng.normal(size=(TRAIN_N, 256, 64, 64)).astype(np.float32)).to(dt)
        fn = lambda: hg._upsample_add_bwd_cuda(dy)
        lib = lambda: F.avg_pool2d(dy, 2) * 4
        ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(lambda: hg.upsample_add_bwd_plain(dy)), cuda_ms(lib)
        us, src = lib_device_us(fn)
        b = bound(dy.numel() * dy.element_size() * 5 / 4, dy.numel())
        _report(f"K18 upsample_add_bwd ({name}, dy {list(dy.shape)}, device {us:.3f} us by "
                f"{src})", err, "0", ms, plain_ms, lib_ms, b, lib)
        out[name] = (ms, plain_ms, lib_ms, b)
    ms, plain_ms, lib_ms, b = out["bf16"]
    return dict(name="upsample_add_bwd", route="cuda",
                source="suo_slam_tpu_torch/csrc/upsample_add.cu",
                replaces="suo_slam_tpu/models/hourglass.py:35", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k19(dev, rng):
    """K19 on the readout's [16, 64, 64, 41] f32 logits (the head's NHWC
    view of channels_last, and its transpose) against its plain version:
    within 1e-4 of the largest gradient (f - E[f] cancels near a heatmap's
    peak, and the two round the moments' sums in other orders). Library:
    autograd of softmax + einsum."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    x = torch.from_numpy((rng.normal(size=(TRAIN_N, 41, 64, 64)) * 3).astype(np.float32)).to(
        dev).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
         for s in ((TRAIN_N, 41, 2), (TRAIN_N, 41, 2, 2), (TRAIN_N, 41))]
    err = 0.0
    for view in (x, x.transpose(1, 2)):
        k = hm._heatmap_readout_bwd_cuda(view, *g)
        p = hm.heatmap_readout_bwd_plain(view, *g)
        torch.cuda.synchronize()
        if k.stride() != view.stride():
            raise AssertionError("K19 did not write the logits' layout")
        err = max(err, ((k - p).abs().max() / p.abs().max()).item())
    log(f"[train] K19 max err, plain and transposed: {err:.3e} of the largest gradient (tol 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"K19 disagrees with its plain version: {err}")
    xg = x.detach().requires_grad_(True)
    H, W = 64, 64
    u, v = hm.ndc_grid(H, W, torch.float32, dev)
    feats = torch.stack([u, v, u * u, v * v, u * v], -1).reshape(H * W, 5)
    p = torch.softmax(xg.reshape(TRAIN_N, H * W, 41), 1)
    m = torch.einsum("npk,pf->nkf", p, feats)
    gm = torch.randn_like(m)
    fn = lambda: hm._heatmap_readout_bwd_cuda(x, *g)
    lib = lambda: torch.autograd.grad(m, xg, gm, retain_graph=True)
    ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(lambda: hm.heatmap_readout_bwd_plain(x, *g)), \
        cuda_ms(lib)
    us, src = lib_device_us(fn)
    b = bound(2 * x.numel() * 4 + TRAIN_N * 41 * 7 * 4, 40 * x.numel())
    _report(f"K19 heatmap_readout_bwd (f32, {list(x.shape)}, device {us:.3f} us by {src})",
            err, "1e-4 of max", ms, plain_ms, lib_ms, b, lib)
    return dict(name="heatmap_readout_bwd", route="cuda",
                source="suo_slam_tpu_torch/csrc/heatmap_readout.cu",
                replaces="suo_slam_tpu/models/pkpnet.py:125", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper of the train step (K1, K2, K5, K8, K9, K16-K19)
    takes its plain version on CUDA tensors for the duration; no kernel may
    launch meanwhile (a call site the patches miss would raise here)."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.ops import roi

    patches = [(hg, "_norm_relu_fwd", hg.norm_relu_plain), (hg, "bn_stats", hg.bn_stats_plain),
               (hg, "norm_relu_bwd", hg.norm_relu_bwd_plain),
               (hg, "_upsample_add_fwd", hg.upsample_add_plain),
               (hg, "upsample_add_bwd", hg.upsample_add_bwd_plain),
               (hm, "_heatmap_readout_fwd", hm.heatmap_readout_plain),
               (hm, "heatmap_readout_bwd", hm.heatmap_readout_bwd_plain),
               (hm, "render_prior_heatmaps", hm.render_prior_heatmaps_plain),
               (roi, "roi_crop_batch", roi.roi_crop_batch_plain)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    before = kernels.counts()
    try:
        for m, k, f in patches:
            setattr(m, k, f)
        yield
        launched = {k: v - before[k] for k, v in kernels.counts().items() if v != before[k]}
        if launched:
            raise AssertionError(f"kernels launched while the plain versions ran: {launched}")
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


@contextlib.contextmanager
def plain_on_cuda_counter():
    """Counts calls of the train path's plain versions on CUDA tensors (the
    wrappers must launch their kernels there)."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.ops import roi

    hits = {}
    names = [(hg, "norm_relu_plain"), (hg, "bn_stats_plain"), (hg, "norm_relu_bwd_plain"),
             (hg, "upsample_add_plain"), (hg, "upsample_add_bwd_plain"),
             (hm, "heatmap_readout_plain"), (hm, "heatmap_readout_bwd_plain"),
             (hm, "render_prior_heatmaps_plain"), (roi, "roi_crop_batch_plain")]
    saved = [(m, k, getattr(m, k)) for m, k in names]

    def wrap(k, f):
        def g(*a, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                hits[k] = hits.get(k, 0) + 1
            return f(*a, **kw)
        return g

    try:
        for m, k, f in saved:
            setattr(m, k, wrap(k, f))
        yield hits
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


def _first_batch(root, dev, seed, truncate_obj=16):
    """The CLI's first training batch (2 frames, `gt+noise` boxes, priors),
    padded to 16 object slots, on the card."""
    import os

    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.data.loader import ConcatLoader
    from suo_slam_tpu_torch.train import harness

    ds = BopDataset(root, "train_real", bop_dset="ycbv", ignore_symmetry=False, no_aug=True,
                    det_type="gt+noise", kp_config_root=os.path.join(root, "kp_configs"),
                    seed=seed)
    np_batch = next(iter(ConcatLoader([ds], 2, truncate_obj, seed=seed, workers=1).epoch()))
    return harness.to_batch(np_batch, dev, o_pad=truncate_obj)


def _step_record(dt, seed, batch, keep, dev):
    """One full-width train step from seeded flax-style weights: loss, its
    terms, every parameter gradient and the new running statistics."""
    import torch

    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    net = PkpNet(n_stack=2, n_modules=2, features=256, dtype=dt).to(dev)
    state = harness.init_state(net, seed=seed)
    _, m = harness.make_train_step()(state, batch, 0.0, dropout_mask=keep)
    torch.cuda.synchronize()
    named = dict(net.named_parameters())
    conv_bias = {k for k in named if k.endswith(".bias") and k[:-5] + ".weight" in named
                 and k not in ("classifier.bias", "backbone.heads.1.bias")}
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={k: p.grad.float().clone() for k, p in named.items() if k not in conv_bias},
                stats={k: b.clone() for k, b in net.named_buffers()})


def _distances(a, b):
    import torch

    terms = max(abs(a["metrics"][k] - v) / max(abs(v), 1e-3) for k, v in b["metrics"].items())
    grad = max(((a["grads"][k] - b["grads"][k]).abs().max()
                / b["grads"][k].abs().max().clamp(min=1e-30)).item() for k in b["grads"])
    va = torch.cat([g.reshape(-1).double() for g in a["grads"].values()])
    vb = torch.cat([g.reshape(-1).double() for g in b["grads"].values()])
    cos = (va @ vb / va.norm() / vb.norm()).item()
    stats = max(((a["stats"][k] - b["stats"][k]).abs().max()
                 / b["stats"][k].abs().max().clamp(min=1.0)).item() for k in b["stats"])
    return dict(terms=terms, grad=grad, cos=cos, stats=stats)


# fixed gates of the full-width step, kernels against plain versions: the
# forward's kernels reproduce their plain versions' rounding (K8, K9, K2 and
# K1 / K5 exactly, K16 to f64 sums), so the loss, its terms and the
# statistics are held to 1e-5; the gradients go through the
# backward kernels' other summation orders, which the ill-conditioned step
# (see tests/test_torch_train_step.py) amplifies, so they are held by the
# whole gradient's cosine and, in f32, by each tensor within half its
# largest magnitude (an all-zero or sign-flipped gradient is 1 or 2 away)
STEP_GATES = {"f32": dict(terms=1e-5, stats=1e-5, cos=0.999, grad=0.5),
              "bf16": dict(terms=1e-2, stats=2e-2, cos=0.99)}


def train_step_parity(dev, seed, root):
    """One full-width train step (2 x 16 crop slots, the CLI's first batch,
    seeded flax-style weights, one dropout mask) with the kernels against the
    same step with every wrapper on its plain version, in f32 and bf16, cuDNN
    deterministic, within the fixed `STEP_GATES`: loss and terms (relative),
    running statistics (against their scale), gradients (the whole
    gradient's cosine; each tensor against its largest magnitude). bf16
    rounds each activation to 2^-9 relative: its terms and statistics are
    held to 1e-2 and 2e-2."""
    import torch

    batch = _first_batch(root, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand((32, NK), generator=g, device=dev) < 0.5
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            gate = STEP_GATES[name]
            kern = _step_record(dt, seed, batch, keep, dev)
            with plain_versions():
                plain = _step_record(dt, seed, batch, keep, dev)
            d = _distances(kern, plain)
            log(f"[train] full-width step ({name}), kernels vs plain: "
                + json.dumps({k: f"{v:.6e}" for k, v in d.items()})
                + f" (gates {json.dumps(gate)}); loss {kern['metrics']['loss']:.6f}"
                + f" (plain {plain['metrics']['loss']:.6f})")
            ok = (d["terms"] <= gate["terms"] and d["stats"] <= gate["stats"]
                  and d["cos"] >= gate["cos"] and d["grad"] <= gate.get("grad", np.inf))
            finite = all(np.isfinite(v) for v in kern["metrics"].values())
            if not (ok and finite):
                raise AssertionError(f"train step ({name}): kernels vs plain {d}, gates {gate}")
            out[name] = d
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    return out


def step_timing(dev, seed, root):
    """The bf16 full-width step's host ms (median of 5 synchronized steps),
    device ms and kernels (torch.profiler over one step), busy share, peak
    memory and launches per step."""
    import torch
    from torch.autograd import DeviceType

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    batch = _first_batch(root, dev, seed)
    net = PkpNet(dtype=torch.bfloat16).to(dev)
    state = harness.init_state(net, seed=seed)
    step = harness.make_train_step()
    for _ in range(2):
        state, _ = step(state, batch, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    state, _ = step(state, batch, 0.0)
    torch.cuda.synchronize()
    per_step = {k: v for k, v in kernels.counts().items() if v}
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, m = step(state, batch, 0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host = statistics.median(times)
    # kernels only: a record_function range (Adam's `Optimizer.step`) also
    # shows on the device's timeline, spanning kernels counted already
    kern = lambda a: [e for e in a if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
    avg = traced(lambda: step(state, batch, 0.0), lambda a: len(kern(a)) > 0, "train step")
    if avg is None:
        dev_ms, n_k = "not measured", "not measured"
    else:
        dev_ms = sum(e.self_device_time_total for e in kern(avg)) / 1e3
        n_k = sum(e.count for e in kern(avg))
        top = sorted(kern(avg), key=lambda e: -e.self_device_time_total)[:14]
        log("[train] the step's device time by kernel (ms, launches): " + json.dumps(
            [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count] for e in top]))
    busy = dev_ms / host if isinstance(dev_ms, float) else "not measured"
    log(f"[train] full-width bf16 step (2 frames x 16 slots, 256x256 crops): host {host:.2f} ms "
        f"(median of 5: {[round(t, 2) for t in times]}), device {dev_ms} ms in {n_k} kernels, "
        f"busy share {busy}, peak memory {peak:.2f} GiB; launches per step "
        + json.dumps(per_step))
    want = {"bn_stats": NORMS_PER_FWD, "norm_relu_bwd": NORMS_PER_FWD, "norm_relu": NORMS_PER_FWD,
            "upsample_add": JUNCTIONS_PER_FWD, "upsample_add_bwd": JUNCTIONS_PER_FWD,
            "heatmap_readout": 1, "heatmap_readout_bwd": 1, "roi_crop": 1, "prior_render": 1}
    if any(per_step.get(k) != v for k, v in want.items()):
        raise AssertionError(f"launches per train step {per_step}, expected {want}")
    return dict(host_ms=host, device_ms=dev_ms, kernels=n_k, busy=busy, peak_gib=peak)


def overfit(dev, seed, root, steps=30):
    """30 steps on one fixed batch (full width, bf16, epoch 0's weights):
    the mean loss of the last 5 must fall below that of the first 5."""
    import torch

    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    batch = _first_batch(root, dev, seed + 5)
    state = harness.init_state(PkpNet(dtype=torch.bfloat16).to(dev), seed=seed + 5)
    step = harness.make_train_step()
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, 0.0)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"[train] overfit of one batch, {steps} steps: loss {[round(x, 4) for x in losses]}; "
        f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"overfit: the loss did not fall ({first} -> {last})")
    return first, last


def phase_train(dev, seed):
    """Training on the card (the module docstring's phase 9). Returns the
    K16-K19 entries and the launches of the CLI run."""
    import io
    import os
    import re
    import shutil

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.evaluate import Evaluator
    from suo_slam_tpu_torch.train import __main__ as cli

    base, root = _eval_root()
    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    write_train_split(root, EvalObjects(np.random.default_rng(seed + 2)), rng)
    log(f"[train] train_real split of {TRAIN_VIEWS} views written in "
        f"{time.perf_counter() - t0:.2f} s")
    entries = check_k16_k17(dev, rng) + [check_k18(dev, rng), check_k19(dev, rng)]
    train_step_parity(dev, seed, root)
    step_timing(dev, seed, root)
    overfit(dev, seed, root)

    # the CLI, full width and bf16 (its defaults), from the repository's
    # results directory contract, then its auto-resume
    work = os.path.join(base, "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = ["--device", dev.type, "--dataset", "ycbv", "--data_split", "real", "--no_augmentations",
            "--steps_per_epoch", "4", "--val_steps", "2", "--data_root", root,
            "--kp_config_root", os.path.join(root, "kp_configs")]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        buf = io.StringIO()
        kernels.reset_counts()
        t1 = time.perf_counter()
        with plain_on_cuda_counter() as hits, contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--epochs", "2"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = kernels.counts()
        text = buf.getvalue()
        buf2 = io.StringIO()
        with contextlib.redirect_stdout(buf2):
            rc2 = cli.main(argv + ["--epochs", "3"])
        text2 = buf2.getvalue()
    finally:
        os.chdir(cwd)
    with open(os.path.join(work, "cli.log"), "w") as f:
        f.write(text + "\n---- resume ----\n" + text2)
    (outdir,) = [os.path.join(work, "results", d) for d in os.listdir(os.path.join(work, "results"))]
    losses = [float(x) for x in re.findall(r"train loss ([-\d.eE+naninf]+)", text)]
    files = sorted(os.listdir(outdir))
    log(f"[train] CLI, 2 epochs x 4 steps + 2 val batches, full width bf16: rc {rc}, "
        f"{wall:.2f} s; epoch train losses {losses}; files {files}")
    for line in text.splitlines():
        if line.startswith(("Epoch", "Training on", "Validating")):
            log(f"[train]   {line.strip()}")
    steps, vals = 8, 4
    want = {"bn_stats": NORMS_PER_FWD * steps, "norm_relu_bwd": NORMS_PER_FWD * steps,
            "upsample_add_bwd": JUNCTIONS_PER_FWD * steps, "heatmap_readout_bwd": steps,
            "norm_relu": NORMS_PER_FWD * (steps + vals),
            "upsample_add": JUNCTIONS_PER_FWD * (steps + vals),
            "heatmap_readout": steps + vals, "roi_crop": steps + vals,
            "prior_render": steps + vals}
    got = {k: counts[k] for k in want}
    log(f"[train] CLI launches: {json.dumps(got)} (want {json.dumps(want)}); plain versions "
        f"on CUDA tensors: {json.dumps(hits)}")
    need = {f"checkpoint-{e}{s}" for e in (0, 1) for s in ("", ".meta.json")} | {
        "checkpoint-latest", "checkpoint-latest.meta.json", "params.txt"}
    if rc != 0 or not need <= set(files) or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"training CLI: rc {rc}, files {files}, losses {losses}:\n"
                             f"{text[-3000:]}")
    if got != want or hits:
        raise AssertionError(f"training CLI launches {got} (want {want}), plain on CUDA {hits}")
    if rc2 != 0 or "Auto-resuming from" not in text2 or "Epoch: 2 [" not in text2 \
            or not os.path.isfile(os.path.join(outdir, "checkpoint-2")):
        raise AssertionError(f"training CLI did not auto-resume at epoch 2:\n{text2[-3000:]}")
    log("[train] second run: auto-resumed at epoch 2, wrote checkpoint-2")

    # the trained checkpoint through the evaluation entry point
    ck = os.path.join(outdir, "checkpoint-latest")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, ck, nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev)
        ev.model_path = os.path.join(base, "results_trained")
        summary = ev.run()
    if summary is None or ev.model_epoch != 2:
        raise AssertionError(f"Evaluator on the trained checkpoint:\n{buf.getvalue()[-3000:]}")
    log(f"[train] Evaluator(nviews=1) on {ck} (epoch {ev.model_epoch}): ran to its end, "
        f"{ev.method_name()}")
    return entries, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--frames", type=int, default=22)
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    dev = phase_card()
    phase_build()
    rng = np.random.default_rng(args.seed)
    objs = Objects(rng)
    net = full_width_net(args.seed)
    from suo_slam_tpu_torch.slam import kernels as sk

    net = sk.make_frame_inference(net, device=dev).net  # on the card, eval, channels_last
    net16 = sk.make_frame_inference(full_width_net(args.seed, torch.bfloat16), device=dev).net
    crops = torch.from_numpy(rng.uniform(0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
    scene = SlamScene(np.random.default_rng(args.seed + 1), objs, args.frames + 1)
    entries = [check_k1(dev, rng, objs), check_k2(dev, rng, net), check_k3(dev, rng, objs),
               check_k4(dev, rng, objs), check_k5(dev, rng), check_k6(dev, rng, objs),
               check_k7(dev, scene), check_k8(dev, rng, net, net16, crops), check_k9(dev, rng),
               check_k10(dev, rng), check_k14(dev, np.random.default_rng(args.seed + 14), objs),
               check_k15(dev, np.random.default_rng(args.seed + 15))]
    phase_bf16_net(dev, rng, args.seed, net, net16, crops)
    phase_main_path(dev, rng, objs, net, args.seed, args.views)
    phase_solver_check(dev, rng, objs, args.seed, args.views)
    counts = phase_slam(dev, rng, objs, net, args.seed, scene)
    eval_counts = phase_evaluate(dev, args.seed, net16)
    int8_entries, int8_counts, k2_bf16_err = phase_int8(dev, rng, args.seed, net, net16, crops,
                                                        objs, scene)
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"], k2_bf16_err)
    train_entries, train_counts = phase_train(dev, args.seed)
    entries += int8_entries + train_entries
    for e in entries:
        e["launches"] = (eval_counts if e["name"] in EVAL_KERNELS else int8_counts
                         if e["name"] in INT8_KERNELS else train_counts
                         if e["name"] in TRAIN_KERNELS else counts)[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
