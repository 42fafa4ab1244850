"""Command-line flags of the evaluation CLI (`suo_slam_tpu_torch.evaluate`).

Port of the `eval` mode of `suo_slam_tpu/args.py`: the same flag names and
defaults (bf16 network on, saved detections, `--nviews -1` SLAM, data root
`./data/bop_datasets/<dataset>`), plus `--device` (default `cuda`; `cpu` runs
the plain PyTorch version of every kernel). `--int8` serves the network
with the s8-resident executor on the scales sidecar of `--int8_scales` (or
the one beside the checkpoint, `calibrate_int8`), else with online
calibration. The flags of the paths not ported yet are accepted, so that a
JAX command line parses, and the `Evaluator` refuses them; `--eval_window`
and `--int8_online_ok` only qualify those paths. The training flags come
with the training slice (ROADMAP A12).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser


def get_args(argv_override=None):
    parser = ArgumentParser(description="Evaluate PkpNet (PyTorch + CUDA)")
    parser.add_argument("--checkpoint_path", "-c", default="results/latest/model_best",
                        help="Checkpoint to run.")
    parser.add_argument("--dataset", "-d", default="ycbv", choices=["ycbv", "tless"])
    parser.add_argument("--no_network_cov", "-u", action="store_true",
                        help="Ignore the predicted covariance.")
    parser.add_argument("--show_viz", action="store_true")
    parser.add_argument("--detection_type", "-t", default="saved",
                        choices=["gt", "gt+noise", "saved"])
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 compute in the backbone (the default).")
    parser.add_argument("--no_bf16", dest="bf16", action="store_false")
    parser.add_argument("--norm", default="batch", choices=["group", "batch"],
                        help="Backbone normalization (only 'batch' is ported).")
    parser.add_argument("--nviews", type=int, default=-1,
                        help="1 = single-view PnP, N>1 = SfM per frame, -1 = full SLAM.")
    parser.add_argument("--no_viz", action="store_true")
    parser.add_argument("--viz_cov", action="store_true")
    parser.add_argument("--do_viz_extra", action="store_true")
    parser.add_argument("--no_prior_det", "-p", action="store_true")
    parser.add_argument("--debug_gt_kp", action="store_true")
    parser.add_argument("--gt_cam_pose", action="store_true")
    parser.add_argument("--debug_saved_only", action="store_true")
    parser.add_argument("--give_all_prior", action="store_true")
    parser.add_argument("--ref_manual_info", action="store_true",
                        help="Identity edge information in BA for a run with manual "
                             "information (RANSAC and re-init keep 1/sigma^2).")
    parser.add_argument("--batched", action="store_true",
                        help="Single-view throughput mode (not ported yet).")
    parser.add_argument("--eval_window", type=int, default=16,
                        help="Views per precompute window for --batched.")
    parser.add_argument("--pipeline_scenes", type=int, default=0,
                        help="Scene-pipelined throughput mode (not ported yet); 0/1 "
                             "disables.")
    parser.add_argument("--int8", action="store_true",
                        help="int8-resident network inference (norm='batch' nets).")
    parser.add_argument("--int8_scales", default=None,
                        help="int8 activation-scales sidecar (default: the one beside "
                             "the checkpoint if present, else online calibration).")
    parser.add_argument("--int8_online_ok", action="store_true",
                        help="Accept online calibration under --pipeline_scenes "
                             "(not ported yet).")
    parser.add_argument("--data_root", default=None,
                        help="Override BOP dataset root (default ./data/bop_datasets/<dataset>).")
    parser.add_argument("--kp_config_root", default=None,
                        help="Override kp_configs dir (default repo kp_configs/).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) runs the kernels on the card; cpu "
                             "their plain PyTorch versions.")
    args = parser.parse_args(argv_override)
    if args.data_root is None:
        args.data_root = os.path.join(os.getcwd(), "data/bop_datasets", args.dataset)
    return args
