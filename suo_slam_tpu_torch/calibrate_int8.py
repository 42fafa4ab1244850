"""Offline int8 activation-scale calibration.

Port of the JAX package's `calibrate_int8.py`. Runs an even sample of a BOP
dataset's frames through the f32 calibration traversal
(`models/int8_forward.calibrate`) with the worst-case prior and writes the
per-point absmax tuple as the checkpoint's sidecar
(`eval/loading.default_scales_path`). `python -m suo_slam_tpu_torch.evaluate
--int8` finds the sidecar, so int8 serving does not depend on a session's
first frames; a sidecar written by either package serves the other. The
crops come from the engine's own ROI stage (K1 on the card), so the recorded
ranges are those of serving.

    python -m suo_slam_tpu_torch.calibrate_int8 --dataset ycbv \\
        --data_root <bop root>/ycbv --checkpoint_path <ref>.pth.tar \\
        [--n_frames 64] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def sample_frames(dataset, n_frames):
    """Evenly sample (scene, view) pairs across all scenes."""
    pairs = [(s, v) for s in dataset.scene_ids() for v in dataset.view_ids(s)]
    if len(pairs) <= n_frames:
        return pairs
    idx = np.linspace(0, len(pairs) - 1, n_frames).astype(int)
    return [pairs[i] for i in idx]


def collect_crop_batches(dataset, frames, input_hw, batch_size=16, device="cuda"):
    """Frames -> list of [B, H, W, 3] ROI-crop batches on `device`, cropped
    by the engine's ROI stage (`ops/roi.roi_crop_batch`)."""
    from .ops import roi as roi_ops

    crops_all = []
    for scene_id, view_id in frames:
        obj_ids = dataset.obj_ids(scene_id, view_id)
        if not len(obj_ids):
            continue
        sample = dataset.get_raw(scene_id, view_id, obj_ids, p_give_prior=0.0)
        img = torch.as_tensor(np.ascontiguousarray(sample["img"], np.float32),
                              device=device)[None]
        boxes = torch.as_tensor(np.asarray(sample["bboxes"], np.float32), device=device)[None]
        valid = torch.ones((1, boxes.shape[1]), dtype=torch.bool, device=device)
        crops_all.append(roi_ops.roi_crop_batch(img, boxes, valid, tuple(input_hw))[0])
    if not crops_all:
        raise SystemExit("no frames with detections found for calibration")
    flat = torch.cat(crops_all)
    return [flat[i: i + batch_size] for i in range(0, len(flat), batch_size)]


def calibrate_dataset(net, dataset, n_frames=64, batch_size=16, input_hw=(256, 256),
                      device="cuda"):
    """The scales tuple of `net` (on `device`) over an even sample of
    `dataset`'s frames. Returns (scales, number of frames, number of crops)."""
    from .models import int8_forward as i8

    frames = sample_frames(dataset, n_frames)
    batches = collect_crop_batches(dataset, frames, input_hw, batch_size, device)
    # the worst-case prior (prior_batches=None): see int8_forward.calibrate
    scales = i8.calibrate(net, batches)
    return scales, len(frames), sum(int(b.shape[0]) for b in batches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=("ycbv", "tless"), default="ycbv")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--checkpoint_path", required=True)
    ap.add_argument("--kp_config_root", default=None)
    ap.add_argument("--split", default=None, help="dataset split (default: the eval split)")
    ap.add_argument("--n_frames", type=int, default=64,
                    help="frames sampled evenly across scenes")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--input_hw", type=int, nargs=2, default=(256, 256),
                    help="ROI crop size fed to the net (engine input_hw)")
    ap.add_argument("--out", default=None,
                    help="output .npz (default: the sidecar beside the checkpoint)")
    ap.add_argument("--no_bf16", dest="bf16", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) crops with K1 on the card; cpu runs the "
                         "plain PyTorch versions.")
    args = ap.parse_args(argv)

    from ._device import resolve_device
    from .data.bop import BopDataset
    from .eval.loading import default_scales_path, load_eval_network
    from .models import int8_forward as i8

    dev = resolve_device(args.device)
    split = args.split or ("test" if args.dataset == "ycbv" else "test_primesense")
    dataset = BopDataset(args.data_root, split, bop_dset=args.dataset, ignore_symmetry=True,
                         kp_config_root=args.kp_config_root, seed=666)
    net, epoch = load_eval_network(args.checkpoint_path, bf16=args.bf16)
    net = net.to(dev).eval()
    print(f"calibrating over up to {args.n_frames} frames (checkpoint epoch {epoch}) ...")
    scales, n_frames, n_crops = calibrate_dataset(
        net, dataset, args.n_frames, args.batch_size, tuple(args.input_hw), dev)
    out = args.out or default_scales_path(args.checkpoint_path)
    i8.save_scales(out, scales)
    print(f"saved {len(scales)} activation scales (from {n_crops} crops of {n_frames} "
          f"frames) to {out}")
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
