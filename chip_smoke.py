"""Chip smoke test of the PyTorch/CUDA port: the single-view SUO-SLAM frame on
one NVIDIA GPU, through the entry points a user calls.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: nvidia-smi name and power limit, torch / CUDA versions, the f32
     precision flags;
  2. build: every `suo_slam_tpu_torch/csrc/*.cu` with nvcc (one process per
     source, in parallel) and the seconds it took;
  3. kernels: K1-K4 against their plain PyTorch versions on the same CUDA
     inputs at the main path's shapes, with the stated tolerances; kernel,
     plain and library times (median of CUDA-event timings) and each
     kernel's bound on an H100 (bytes at 3.35 TB/s or f32 operations at
     67 TFLOP/s, counted from this run's inputs);
  4. the main path: full-width PkpNet (2 stacks x 2 modules x 256 features,
     256x256 crops, seeded random weights, non-trivial BatchNorm statistics)
     in `ObjectSlam(single_view_mode=True)` over synthetic 480x640 views with
     8 objects each, `reset()` before every view as `evaluate.py --nviews 1`
     does: per-view latency and per-stage times; every kernel's launch
     counter must rise; the network path's outputs are held against the same
     net on the CPU for two crops; one more view runs under torch.profiler
     (device-busy share of the per-view latency, top device operations);
  5. solver check: the same engine with an injected ground-truth inference
     (projected keypoints + N(0, 0.005) NDC noise, cov sigma^2 I, validity
     1): ADD < 0.1 diameter for >= 90% of the objects;
  6. the kernels JSON line, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

The script imports nothing of JAX or of the JAX package; its scene is made
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
H_IMG, W_IMG = 480, 640
YCBV_K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]])
N_OBJ = 8
NK = 41


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


def bound(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
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
    points in a 100 mm cube."""

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


def full_width_net(seed):
    """PkpNet at full width with seeded random weights and non-trivial
    BatchNorm running statistics."""
    import torch

    from suo_slam_tpu_torch.models.hourglass import MaskedBatchNorm
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    torch.manual_seed(seed)
    net = PkpNet(n_stack=2, n_modules=2, features=256, prior_mode="post_stem")
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


def profile_view(engine, objs, view, per_view_ms):
    """One more view under torch.profiler: the device time of the view's
    kernels, its share of the unprofiled per-view latency, the number of
    kernels, the PyTorch operations that hold the most device time, and the
    device time per launch of each of the port's kernels (without the host
    time of its wrapper, which `cuda_ms` includes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from suo_slam_tpu_torch import kernels

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t, _ = _drive(engine, objs, [view])
    avg = prof.key_averages()
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    log(f"[profile] one view: device busy {busy_ms:.2f} ms in {sum(e.count for e in kern)} "
        f"kernels = {busy_ms / per_view_ms:.4f} of the {per_view_ms:.2f} ms per-view latency "
        f"(profiled wall {t[0] * 1e3:.2f} ms)")
    log("[profile] device ms and calls by operation: " + json.dumps(
        {e.key: [round(e.self_device_time_total / 1e3, 3), e.count] for e in ops}))
    mine = {}
    for name in kernels.LAUNCHES:  # csrc kernels are named <counter name>_kernel
        es = [e for e in kern if f"{name}_kernel" in e.key]
        n = sum(e.count for e in es)
        mine[name] = [round(sum(e.self_device_time_total for e in es) / max(n, 1), 3), n]
    log("[profile] the port's kernels, device us per launch and launches: "
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
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    per_view_ms = statistics.median(times[1:]) * 1e3
    log(f"[main] per-view latency: median {per_view_ms:.2f} ms over {n_views} views "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    log(f"[main] crops/s at the 8-crop bucket: {N_OBJ / (per_view_ms / 1e3):.1f}")
    st = stage_times(engine, objs, views[-1], dev)
    log("[main] per-stage ms (each stage alone, last view's inputs): "
        + json.dumps({k: round(v, 3) for k, v in st.items()}))
    profile_view(engine, objs, views[-1], per_view_ms)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=6)
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
    entries = [check_k1(dev, rng, objs), check_k2(dev, rng, net), check_k3(dev, rng, objs),
               check_k4(dev, rng, objs)]
    counts = phase_main_path(dev, rng, objs, net, args.seed, args.views)
    phase_solver_check(dev, rng, objs, args.seed, args.views)
    for e in entries:
        e["launches"] = counts[e["name"]]
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
