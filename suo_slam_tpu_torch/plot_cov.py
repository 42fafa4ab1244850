"""Covariance calibration check: `python -m suo_slam_tpu_torch.plot_cov`.

Port of the JAX package's root `plot_cov.py`, with its flags plus
`--device` (default cuda). It runs the net (f32, eval mode, prior-free, as
the JAX CLI runs it) over the frames of a split, ROI crops by K1 and the
readout by K2 on the card, and reports the share of keypoint errors inside
the 99% chi-square bound of the predicted 2D covariance: the line goes to
`percent_sigma_inbounds.txt` in the JAX CLI's words, and `sigma_plot.png`
scatters each labeled keypoint's error against its predicted sigma
sqrt((cuu + cvv) / 2), both in NDC, with the bound's line sqrt(9.21) sigma.
The card's machine has no matplotlib: the plot is a numpy raster (points in
blue, the line in red, axes from 0; no text) written by `data/png.py`.

    python -m suo_slam_tpu_torch.plot_cov -c results/<run>/checkpoint-latest \\
        --dataset ycbv --split train_real --data_root <bop root>/ycbv [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .eval.calibration import CHI2_99_2DOF, cov_chi2, pct_inbounds

PLOT_HW = (600, 720)
MARGIN = 40


def _line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.clip(np.rint(np.linspace(x0, x1, n)).astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.rint(np.linspace(y0, y1, n)).astype(int), 0, img.shape[0] - 1)
    for d in (-1, 0, 1):  # 3 pixels wide
        img[np.clip(ys + d, 0, img.shape[0] - 1), xs] = color
        img[ys, np.clip(xs + d, 0, img.shape[1] - 1)] = color


def sigma_plot(sigmas, errs, lim) -> np.ndarray:
    """The scatter of errs against sigmas with the 99% line up to `lim`:
    [H, W, 3] uint8 RGB."""
    h, w = PLOT_HW
    img = np.full((h, w, 3), 255.0)
    xmax = 1.1 * max(lim, 1e-12)
    top = float(np.percentile(errs, 99.5)) if len(errs) else 0.0
    ymax = 1.1 * max(np.sqrt(CHI2_99_2DOF) * lim, top, 1e-12)
    px = lambda x: MARGIN + np.asarray(x) / xmax * (w - 2 * MARGIN)
    py = lambda y: h - MARGIN - np.asarray(y) / ymax * (h - 2 * MARGIN)
    # points: 3 x 3 squares, each blended at alpha 0.5 (overlaps darken)
    cov = np.zeros((h, w))
    xi = np.clip(np.rint(px(sigmas)).astype(int), 1, w - 2)
    yi = np.clip(np.rint(py(errs)).astype(int), 1, h - 2)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            np.add.at(cov, (yi + dy, xi + dx), 1.0)
    keep = 0.5 ** cov
    img = img * keep[..., None] + np.array([31.0, 119.0, 180.0]) * (1 - keep[..., None])
    img = img.astype(np.uint8)
    _line(img, px(0), py(0), px(0), py(ymax), (0, 0, 0))
    _line(img, px(0), py(0), px(xmax), py(0), (0, 0, 0))
    _line(img, px(0), py(0), px(lim), py(np.sqrt(CHI2_99_2DOF) * lim), (214, 39, 40))
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint_path", "-c", required=True)
    ap.add_argument("--dataset", "-d", default="ycbv", choices=["ycbv", "tless"])
    ap.add_argument("--split", default="train_pbr")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--kp_config_root", default=None)
    ap.add_argument("--max_frames", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--norm", default="batch", choices=["group", "batch"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) runs the kernels on the card; cpu the plain "
                         "PyTorch versions.")
    args = ap.parse_args(argv)
    data_root = args.data_root or os.path.join(os.getcwd(), "data/bop_datasets", args.dataset)
    out_dir = args.out or os.path.dirname(args.checkpoint_path) or "."
    os.makedirs(out_dir, exist_ok=True)

    import torch

    from ._device import resolve_device
    from .data import png
    from .data.bop import BopDataset, collate
    from .eval.loading import load_eval_network
    from .ops import roi as roi_ops

    dev = resolve_device(args.device)
    # the checkpoint's recorded norm wins over --norm (announced by the loader)
    net, _ = load_eval_network(args.checkpoint_path, bf16=False, norm=args.norm)
    net = net.to(dev).eval()
    ds = BopDataset(data_root, args.split, bop_dset=args.dataset, no_aug=True,
                    ignore_symmetry=False, kp_config_root=args.kp_config_root, seed=0)

    errs, sigmas, chi2s = [], [], []
    n = min(len(ds), args.max_frames)
    for i in range(n):
        batch = collate([ds[i]])
        t = lambda k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
        with torch.inference_mode():
            crops = roi_ops.roi_crop_batch(t("images"), t("boxes"), t("obj_mask"), (256, 256))
            out = net(crops.reshape((-1,) + crops.shape[2:]))
        uv = out.uv.float().cpu().numpy()
        cov = out.cov.float().cpu().numpy()
        gt, mask = batch["uv_gt"][0], batch["kp_mask"][0]
        errs.append(np.linalg.norm(gt - uv, axis=-1)[mask])
        sigmas.append(np.sqrt(0.5 * (cov[..., 0, 0] + cov[..., 1, 1]))[mask])
        chi2s.append(cov_chi2(uv, cov, gt)[mask])
        print(f"[{i + 1}/{n}]", end="\r", flush=True)
    errs, sigmas, chi2s = np.concatenate(errs), np.concatenate(sigmas), np.concatenate(chi2s)
    pct = pct_inbounds(chi2s)
    msg = (f"{pct:.2f}% of {len(chi2s)} keypoint errors inside the 99% "
           f"chi2 bound of the predicted covariance")
    print("\n" + msg)
    with open(os.path.join(out_dir, "percent_sigma_inbounds.txt"), "w") as f:
        f.write(msg + "\n")
    lim = max(1e-3, float(np.percentile(sigmas, 99))) if len(sigmas) else 1e-3
    plot = os.path.join(out_dir, "sigma_plot.png")
    png.imwrite(plot, sigma_plot(sigmas, errs, lim)[..., ::-1])  # imwrite takes BGR
    print("Wrote", plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
