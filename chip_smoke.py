"""Chip smoke test of the PyTorch/CUDA port: the single-view frame, SLAM
mode and the evaluation entry point of SUO-SLAM on one NVIDIA GPU, through the
entry points a user calls.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: nvidia-smi name and power limit, torch / CUDA versions, the f32
     precision flags;
  2. build: every `suo_slam_tpu_torch/csrc/*.cu` with nvcc (one process per
     source, in parallel) and the seconds it took;
  3. kernels: K1-K10 against their plain PyTorch versions on the same CUDA
     inputs at the main paths' shapes, with the stated tolerances; kernel,
     plain and library times (median of CUDA-event timings) and each
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
     the launch counters of K1-K4 must rise; the prior-free network path is
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
     K1-K7 must rise; the camera trajectory error and ADD < 0.1 d for >= 90%
     of the (frame, object) poses; the with-prior program against the CPU
     for two crops (1e-3). Prints per-frame latency, tracking and global BA
     ms, launches per frame, and a torch.profiler summary of one frame;
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
     convolution shape of the forward, with its real codes, plus the concat
     stem's 7x7 stride-2 prior convolution), K12 (each mode and dtype) and
     K13 (each level) bit-equal to their plain versions on the same CUDA
     inputs, with kernel, plain, `torch._int_mm` (cuBLASLt s8 GEMM; an
     im2col of the 3x3 input) times and bounds (int8 operations at 1,979
     TOP/s or bytes at 3.35 TB/s); K2 on the bf16 logits against its plain
     version; launches per forward; the whole int8 net against its
     plain-version run on the card (equal logits) and against the f32 net
     (uv gap within 1.5x the CPU's on the same two crops); the int8 and
     bf16 nets' host and device ms per call; a scales sidecar written by
     `calibrate_int8` over the phase-7 BOP tree, then `Evaluator(nviews=1,
     int8=True)` to its end; a 6-frame SLAM run with
     `SlamConfig(int8_inference=True, int8_calib_frames=2)` under phase 6's
     ground-truth wrapper (the with-prior int8 program and K5);
  9. the kernels JSON line (K1-K7's launches from the SLAM path, K8-K10's
     from the evaluation phase, K11-K13's from the int8 phase's evaluation
     and SLAM runs), the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

The script imports nothing of JAX or of the JAX package; its scenes are made
with numpy from --seed.
"""

from __future__ import annotations

import argparse
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
SINGLE_VIEW_KERNELS = ("roi_crop", "heatmap_readout", "pnp_hypotheses", "ba_edges")
EVAL_KERNELS = ("norm_relu", "upsample_add", "add_dists")  # launches from the evaluation phase
INT8_KERNELS = ("int8_conv", "int8_quant", "int8_pool_junction")  # from the int8 phase


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
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")
    return secs


def _report(name, err, tol, ms, plain_ms, lib_ms, b):
    tol = tol if isinstance(tol, str) else f"{tol:.1e}"
    log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms"
        f" | plain {plain_ms:.4f} ms | library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
        f" | bound {b[0]:.5f} ms ({b[1]})")


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
    lib_ms = cuda_ms(lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                           padding_mode="border", align_corners=False))
    x1 = bboxes[:, 0].clip(0, W_IMG)
    x2 = bboxes[:, 2].clip(0, W_IMG)
    y1 = bboxes[:, 1].clip(0, H_IMG)
    y2 = bboxes[:, 3].clip(0, H_IMG)
    read = min(float(np.sum((x2 - x1 + 2) * (y2 - y1 + 2))), H_IMG * W_IMG) * 3 * 4
    n_out = N_OBJ * 256 * 256
    b = bound(n_out * 3 * 4 + read + bboxes.nbytes + N_OBJ, n_out * 54)
    _report("K1 roi_crop", err, tol, ms, plain_ms, lib_ms, b)
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
    _report("K2 heatmap_readout", err, tol, ms, plain_ms, lib_ms, b)
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


def _ba_problem(dev, rng, objs, V=16):
    """The engine's single-view BA problem: capacity V x 8 x 41, one active
    view, objects at perturbed poses, NDC measurements with info 1e4 I."""
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
    obj_T[:, :3, 3] += rng.normal(scale=5.0, size=(N_OBJ, 3))
    cam_active = np.zeros((V,), bool)
    cam_active[0] = True
    t = lambda a: torch.as_tensor(a).to(dev)
    return ba.BAProblem(
        cam_T=t(np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))),
        obj_T=t(obj_T.astype(np.float32)), uv=t(uv), info=t(info),
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
    lib_ms = cuda_ms(lambda: torch.bmm(JW, J))
    e = V * O * K
    in_bytes = V * 64 + O * 64 + e * (8 + 16 + 1) + O * K * 12 + V * O * 16
    out_bytes = V * O * (144 + 12) * 4 + e * 8
    # ~200 f32 ops per edge (projection, residual, chi2, Huber, 2x12 J,
    # weighting) + 156 outputs x 2K products x 2 per (v, o)
    b = bound(in_bytes + out_bytes, e * 200 + V * O * 156 * 2 * K * 2)
    b_chi2 = bound(in_bytes - e + e * 8, e * 45)
    _report("K4 ba_edges (H/g mode, H)", err, tol, ms, plain_ms, lib_ms, b)
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
                replaces="suo_slam_tpu/ops/heatmap.py:166", max_abs_err=err, ms=ms,
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
                ms, plain_ms, lib_ms, b)
    err, ms, plain_ms, lib_ms, b = res["global"]
    return dict(name="ba_schur", route="cuda", source="suo_slam_tpu_torch/csrc/ba_schur.cu",
                replaces="suo_slam_tpu/solvers/ba.py:267", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


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
    timed("pnp", lambda: {k: v.cpu() for k, v in sk.frontend_step(
        o.uv, o.cov, o.kp_mask, mk, mm, k4, diam, engine._sampler, c.manual_kp_std,
        c.bbox_thresh, c.kp_var_thresh, c.mask_thresh, c.pnp_hypotheses).items()})
    timed("ba", engine.optimize)
    return out


def profile_run(run, per_ms, label):
    """`run()` once more under torch.profiler: the device time of its
    kernels, its share of the unprofiled latency `per_ms`, the number of
    kernels, the PyTorch operations that hold the most device time, and the
    device time per launch of each of the port's kernels (without the host
    time of its wrapper, which `cuda_ms` includes)."""
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
        return
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


def phase_main_path(dev, rng, objs, net, seed, n_views=6):
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    engine = ObjectSlam(SlamConfig(single_view_mode=True), mesh_db=objs, net=net,
                        device=dev)
    views = _views(rng, objs, n_views + 1)
    kernels.reset_counts()
    times, results = _drive(engine, objs, views)
    counts = kernels.counts()
    log(f"[main] launches over {len(views)} views: {json.dumps(counts)}")
    missing = [k for k in SINGLE_VIEW_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the single-view path: {missing}")
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


def _tracking_ba_ms(engine, dev, n=5):
    """The tracking BA alone on the engine's last view row (all objects
    fixed, rounds (10, 10, 10, 10)), host clock around a synchronized call."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    v = engine.view_slot[engine.view_ids[-1]]
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    problem = ba.BAProblem(
        cam_T=t(engine.cam_T[v:v + 1]), obj_T=t(engine.obj_T), uv=t(engine.uv[v:v + 1]),
        info=t(engine.info[v:v + 1]), model_kp=t(engine.model_kp),
        cam_k=t(engine.cam_k4[v:v + 1]), valid=t(engine.valid[v:v + 1]),
        inliers=t(engine.inliers[v:v + 1]), cam_active=t(np.ones((1,), bool)),
        obj_active=t(engine.obj_active))
    vals = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            ba.optimize(problem, iters_per_round=(10, 10, 10, 10), tracking_only=True,
                        fix_first_cam=False)
        torch.cuda.synchronize()
        vals.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(vals[1:])


def _add_ok(T_est, T_gt, objs, o):
    m = objs.masks[o]
    p_gt = objs.model_kps[o][m] @ T_gt[:3, :3].T + T_gt[:3, 3]
    p_es = objs.model_kps[o][m] @ T_est[:3, :3].T + T_est[:3, 3]
    return float(np.linalg.norm(p_gt - p_es, axis=-1).mean()) < 0.1 * objs.diameter[o]


def compare_global_ba(engine, dev):
    """The SLAM path's global BA problem (V = 32, its poses moved ~0.2 mm
    off the engine's, inside the chi2 inlier basin) through `ba.optimize` on
    the card twice: with K7 and with the plain solve (K4 in both). Poses
    within 1e-4 (rotation absolute; translation relative to its norm, at
    least the 800 mm scene depth) and equal inlier masks, except edges
    within 1% of the chi2 threshold, each printed with its chi2. The same
    problem in f64 on the CPU (plain versions) is printed beside it as the
    reference both f32 runs approximate."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    rng = np.random.default_rng(9)
    cam_T = engine.cam_T.copy()
    obj_T = engine.obj_T.copy()
    cam_T[1:, :3, 3] += rng.normal(scale=0.2, size=(engine.V - 1, 3)).astype(np.float32)
    obj_T[:, :3, 3] += rng.normal(scale=0.2, size=(engine.O, 3)).astype(np.float32)
    arrays = dict(cam_T=cam_T, obj_T=obj_T, uv=engine.uv, info=engine.info,
                  model_kp=engine.model_kp, cam_k=engine.cam_k4, valid=engine.valid,
                  inliers=engine.inliers, cam_active=engine.cam_active,
                  obj_active=engine.obj_active, cam_frozen=np.zeros(engine.V, bool))

    def problem(device, f64=False):
        return ba.BAProblem(**{k: torch.tensor(
            a.astype(np.float64) if f64 and a.dtype == np.float32 else a, device=device)
            for k, a in arrays.items()})

    kernel_solve = ba._solve_normal_eq_schur_cuda
    with torch.inference_mode():
        pk = problem(dev)
        rk = ba.optimize(pk)
        ba._solve_normal_eq_schur_cuda = lambda *a: ba._solve_normal_eq_schur_plain(*a[:-1])
        rp = ba.optimize(pk)
        ba._solve_normal_eq_schur_cuda = kernel_solve
        chi2 = ba._edge_chi2(rk.cam_T, rk.obj_T, pk.uv, pk.info, pk.model_kp, pk.cam_k)
        r64 = ba.optimize(problem("cpu", f64=True))
    ca, oa = engine.cam_active, engine.obj_active

    def gap(r1, r2):
        out = {}
        for name, a, b, act in (("cam", r1.cam_T, r2.cam_T, ca), ("obj", r1.obj_T, r2.obj_T, oa)):
            a = a.cpu().numpy()[act].astype(np.float64)
            b = b.cpu().numpy()[act].astype(np.float64)
            scale = np.maximum(np.linalg.norm(b[:, :3, 3], axis=-1), 800.0)
            out[name] = [float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max()),
                         float((np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) / scale).max())]
        return out

    errs = gap(rk, rp)
    flips = (rk.inliers != rp.inliers).nonzero().tolist()
    fchi2 = [round(float(chi2[tuple(f)]), 4) for f in flips]
    n64 = lambda r: int((r.inliers.cpu() != r64.inliers).sum())
    log(f"[slam] global BA with K7 vs the plain solve: rotation / relative translation errors "
        f"{json.dumps(errs)} (tol 1e-4); {int(rk.num_inliers)} inliers, {len(flips)} flipped "
        f"edges (v, o, k) {flips[:8]} with chi2 {fchi2[:8]} (threshold 5.991); against the "
        f"f64 BA: K7 {json.dumps(gap(rk, r64))} and {n64(rk)} edges apart, plain "
        f"{json.dumps(gap(rp, r64))} and {n64(rp)} apart")
    if max(max(e) for e in errs.values()) > 1e-4:
        raise AssertionError(f"global BA with K7 disagrees with the plain solve: {errs}")
    if any(abs(c - ba.CHI2_THRESH_2DOF) > 0.01 * ba.CHI2_THRESH_2DOF for c in fchi2):
        raise AssertionError(f"global BA: an edge away from the threshold flipped: {fchi2}")


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
    times = [frame(i) for i in range(n_frames)]
    t0 = time.perf_counter()
    results = engine.collect_results(final=True)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    counts = kernels.counts()
    log(f"[slam] launches over {n_frames} frames + the final BA: {json.dumps(counts)}")
    log("[slam] launches per frame: " + json.dumps(
        {k: round(c / n_frames, 2) for k, c in counts.items()}))
    missing = [k for k, c in counts.items()
               if c == 0 and k != "add_dists" and k not in INT8_KERNELS]
    if missing:
        raise AssertionError(f"kernels not launched on the SLAM path: {missing}")
    if engine.V != 32 or len(engine.opt_times) != 3:
        raise AssertionError(f"SLAM path: capacity {engine.V}, {len(engine.opt_times)} global BAs")
    per_frame_ms = statistics.median(times[1:]) * 1e3
    log(f"[slam] per-frame latency: median {per_frame_ms:.2f} ms over {n_frames - 1} frames "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    log(f"[slam] global BA ms (frames 10, 20, final): "
        f"{[round(t * 1e3, 2) for t in engine.opt_times]}; final collect_results "
        f"{final_s * 1e3:.2f} ms; tracking BA alone {_tracking_ba_ms(engine, dev):.2f} ms; "
        f"{inf.n_prior_calls} with-prior network calls")
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
    profile_run(lambda: frame(n_frames), per_frame_ms, "one SLAM frame")
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
                rel, "1e-6 relative; per-point equal", ms, plain_ms, lib_ms, b)
    rel, ms, plain_ms, lib_ms, b = res[1]
    return dict(name="add_dists", route="cuda", source="suo_slam_tpu_torch/csrc/add_dists.cu",
                replaces="suo_slam_tpu/eval/meter.py:82", max_abs_err=rel, ms=ms,
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
                           "heatmap_readout") if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the evaluation path: {missing}")
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
                2.0 * M * cout * kh * kw_ * x.shape[-1])
    if name == "int8_quant":
        n_out = (a[1] is not None) + (len(a) > 2 and a[2] is not None)
        return x.numel() * (x.element_size() + n_out), 0.0
    if name == "int8_maxpool":
        return x.numel() * 1.25, 0.0
    return x.numel() * 3.25, 0.0  # the junction: up1, low, bf16 out


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
            return (name, x.dtype, tuple(x.shape), a[1] is not None,
                    len(a) > 2 and a[2] is not None)
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


def _int_mm_ms(x, qc, M):
    """`torch._int_mm` (cuBLASLt s8 GEMM) on the convolution's GEMM, or None
    where its shape rules (M > 16, K and N multiples of 8) or the layout
    refuse it; the im2col of a 3x3 input is made before the clock."""
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
    return cuda_ms(lambda: torch._int_mm(A, B), n=10, inner=5)


def check_k11(dev, calls):
    """K11 at every distinct convolution of one forward (their real codes
    and epilogue vectors) and the concat stem's 7x7 stride-2 prior
    convolution: equal bf16 bits / s8 codes; times, bounds (int8 operations
    or bytes) and `torch._int_mm` on the same s8 GEMM (1x1: the activations
    as [M, Cin]; 3x3: an im2col of them, not timed)."""
    import torch

    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.models import int8_kernels as ik

    convs = [(k, v) for k, v in calls.items() if k[0] == "int8_conv"]
    g = torch.Generator(device=dev).manual_seed(12)
    stem = torch.nn.Conv2d(44, 64, 7, 2, 3).to(dev)
    qs = i8.quantize_conv(stem, 3, dev)
    xp = torch.randint(0, 128, (N_OBJ, 256, 256, 41), device=dev, generator=g,
                       dtype=torch.int32).to(torch.int8)
    e1 = torch.full((64,), 1e-4, device=dev).to(torch.bfloat16).float()
    convs.append((("int8_conv", tuple(xp.shape), tuple(qs.wq.shape), 2, False),
                  ((xp, qs, e1, torch.zeros(64, device=dev), False), {})))
    rows, err = [], 0.0
    for key, (a, kw) in convs:
        x, qc, e1, e2 = a[:4]
        out_s8 = kw.get("out_s8", a[4] if len(a) > 4 else False)
        k = ik._int8_conv_cuda(x, qc, e1, e2, out_s8)
        p = ik.int8_conv_plain(x, qc, e1, e2, out_s8)
        torch.cuda.synchronize()
        if not (k.dtype == p.dtype and torch.equal(k, p)):
            raise AssertionError(f"K11 disagrees with its plain version at {key}: "
                                 f"{(k.float() - p.float()).abs().max().item()}")
        Ho, Wo = ik.out_hw(x.shape[1], x.shape[2], qc)
        M = x.shape[0] * Ho * Wo
        b = bound(*_int8_traffic("int8_conv", a, kw), INT8_OPS_PER_S)
        rows.append((key, x, qc, e1, e2, out_s8, M, b))
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
        plain_ms = cuda_ms(lambda: ik.int8_conv_plain(x, qc, e1, e2, out_s8), n=3, inner=2,
                           warmup=1)
        us, src = device_us(f, "int8_conv_kernel", n=5)
        cout, kh, kwd, cin_p = qc.wq.shape
        lib_ms = _int_mm_ms(x, qc, M)
        name = (f"{kh}x{kwd} {x.shape[-1]}->{cout} s{qc.stride} on {list(x.shape)} "
                f"{'s8' if out_s8 else 'bf16'} out")
        _report(f"K11 int8_conv ({name}, device {us:.3f} us by {src})", 0.0, "0 (bit-equal)",
                ms, plain_ms, lib_ms, b)
        out[name] = (ms, us, plain_ms, lib_ms, b)
    log(f"[kernel] K11: {len(rows)} distinct convolution calls bit-equal to the plain version, "
        f"{len(best)} weight shapes timed")
    # the JSON row: the forward's own convolution with the most operations
    # (3x3 128->128 at 64x64 at full width), not the concat stem's
    name = max((n for n in out if " s1 " in n),
               key=lambda n: out[n][4][0] if out[n][4][1] == "operations" else 0)
    ms, us, plain_ms, lib_ms, b = out[name]
    return dict(name="int8_conv", route="cuda", source="suo_slam_tpu_torch/csrc/int8_conv.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:254", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k12(dev, calls):
    """K12 in every mode the forward used (f32 / bf16 / s8 input; raw,
    normalised or both outputs), on its real inputs: equal codes."""
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
            raise AssertionError(f"K12 disagrees with its plain version at {key}")
        x = a[0]
        mode = ("pair" if key[3] and key[4] else "raw" if key[3] else "norm")
        b = bound(*_int8_traffic("int8_quant", a, kw))
        mk = (str(x.dtype).replace("torch.", ""), mode)
        if mk not in res or x.numel() > res[mk][0].numel():
            res[mk] = (x, a, kw, b)
    out = {}
    for (dt, mode), (x, a, kw, b) in res.items():
        f = lambda: ik._int8_quant_cuda(*a, **kw)
        ms = cuda_ms(f, n=10, inner=5)
        plain_ms = cuda_ms(lambda: ik.int8_quant_plain(*a, **kw), n=5, inner=2)
        us, src = device_us(f, "int8_quant_kernel", n=5)
        _report(f"K12 int8_quant ({dt} in, {mode}, {list(x.shape)}, device {us:.3f} us by {src})",
                0.0, "0 (bit-equal)", ms, plain_ms, None, b)
        out[(dt, mode)] = (ms, plain_ms, b, x.numel())
    key = max(out, key=lambda k: (k[1] == "pair", k[0] == "bfloat16", out[k][3]))
    ms, plain_ms, b, _ = out[key]
    return dict(name="int8_quant", route="cuda", source="suo_slam_tpu_torch/csrc/int8_quant.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:223", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


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
    entries = [check_k11(dev, calls), check_k12(dev, calls), check_k13(dev, calls)]
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
    from torch.autograd import DeviceType

    dev_ms = {}
    for name, f in nets.items():
        avg = traced(lambda: [f() for _ in range(3)], lambda a: any(
            e.device_type == DeviceType.CUDA for e in a), f"{name} net")
        if avg is None:
            dev_ms[name] = "not measured"
            continue
        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        by = {k: sum(e.self_device_time_total for e in kern if f"{k}_kernel" in e.key) / 3e3
              for k in INT8_KERNELS + ("heatmap_readout", "norm_relu", "upsample_add")}
        ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)[:6]
        dev_ms[name] = {"busy": round(sum(e.self_device_time_total for e in kern) / 3e3, 3),
                        "kernels": sum(e.count for e in kern) // 3,
                        "by kernel": {k: round(v, 3) for k, v in by.items() if v},
                        "by torch operation": {e.key: round(e.self_device_time_total / 3e3, 3)
                                               for e in ops}}
    log("[int8] full-width net ms per call (8 crops, 256x256, backbone + readout, prior-free; "
        "median of 10 synchronized calls, turns I B B I): "
        + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()})
        + "; device ms per call: " + json.dumps(dev_ms))

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
    missing = [k for k in INT8_KERNELS + ("roi_crop", "heatmap_readout", "prior_render")
               if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the int8 path: {missing}")
    return entries, counts, k2_err


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
               check_k10(dev, rng)]
    phase_bf16_net(dev, rng, args.seed, net, net16, crops)
    phase_main_path(dev, rng, objs, net, args.seed, args.views)
    phase_solver_check(dev, rng, objs, args.seed, args.views)
    counts = phase_slam(dev, rng, objs, net, args.seed, scene)
    eval_counts = phase_evaluate(dev, args.seed, net16)
    int8_entries, int8_counts, k2_bf16_err = phase_int8(dev, rng, args.seed, net, net16, crops,
                                                        objs, scene)
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"], k2_bf16_err)
    entries += int8_entries
    for e in entries:
        e["launches"] = (eval_counts if e["name"] in EVAL_KERNELS else int8_counts
                         if e["name"] in INT8_KERNELS else counts)[e["name"]]
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
