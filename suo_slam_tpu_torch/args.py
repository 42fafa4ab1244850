"""Command-line flags of the evaluation CLI (`suo_slam_tpu_torch.evaluate`,
`get_args`) and of the training CLI (`suo_slam_tpu_torch.train`,
`get_train_args`).

Port of `suo_slam_tpu/args.py`. Evaluation: the same flag names and
defaults (bf16 network on, saved detections, `--nviews -1` SLAM, data root
`./data/bop_datasets/<dataset>`), plus `--device` (default `cuda`; `cpu` runs
the plain PyTorch version of every kernel). `--int8` serves the network
with the s8-resident executor on the scales sidecar of `--int8_scales` (or
the one beside the checkpoint, `calibrate_int8`), else with online
calibration. `--batched` (with `--eval_window`) and `--pipeline_scenes`
(with `--int8_online_ok`) run the throughput modes. The visualization flags
are accepted, so that a JAX command line parses, and the `Evaluator`
refuses them (not ported yet). Training: the `train` mode's
flags and defaults (YCB-V: batch 2, 30 epochs, `real+synt`; T-LESS: batch
16, 1000 epochs, `primesense`; the `SUO_WORKERS`, `SUO_BATCH_SIZE` and
`SUO_TRUNCATE_OBJ` overrides), plus `--device`; the training CLI refuses
the options it does not run, naming their ROADMAP items.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


NORM_HELP = ("Backbone normalization. Default 'batch' matches the reference's BatchNorm and is "
             "required by the int8 inference path (--int8 folds BN into conv epilogues); "
             "'group' is a sync-free batch-independent alternative.")


def _env_int(name, default):
    return int(os.environ.get(name, default))


def _common(parser: ArgumentParser) -> None:
    parser.add_argument("--data_root", default=None,
                        help="Override BOP dataset root (default ./data/bop_datasets/<dataset>).")
    parser.add_argument("--kp_config_root", default=None,
                        help="Override kp_configs dir (default repo kp_configs/).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) runs the kernels on the card; cpu "
                             "their plain PyTorch versions.")


def _finish(parser: ArgumentParser, argv_override):
    args = parser.parse_args(argv_override)
    if args.data_root is None:
        args.data_root = os.path.join(os.getcwd(), "data/bop_datasets", args.dataset)
    return args


def get_train_args(argv_override=None):
    """The training CLI's flags (`suo_slam_tpu/args.py`, mode "train")."""
    probe = argv_override if argv_override is not None else sys.argv
    is_tless = "tless" in probe
    parser = ArgumentParser(description="Train PkpNet (PyTorch + CUDA)")
    parser.add_argument("--checkpoint_path", "-c", default=None,
                        help="Checkpoint to resume from.")
    parser.add_argument("--dataset", "-d", default="ycbv", choices=["ycbv", "tless"])
    parser.add_argument("--no_network_cov", "-u", action="store_true",
                        help="Ignore predicted covariance (and skip the MLE loss).")
    parser.add_argument("--show_viz", action="store_true")
    parser.add_argument("--detection_type", "-t", default="gt+noise", choices=["gt", "gt+noise"])
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 compute in the backbone (the default).")
    parser.add_argument("--no_bf16", dest="bf16", action="store_false")
    parser.add_argument("--norm", default="batch", choices=["group", "batch"],
                        help=NORM_HELP)
    parser.add_argument("--workers", "-j", type=int, default=_env_int("SUO_WORKERS", 4))
    parser.add_argument("--loader", default="thread", choices=["thread", "process"],
                        help="Worker tier of the train loader (thread only is ported).")
    parser.add_argument("--batch_size", "-b", type=int,
                        default=_env_int("SUO_BATCH_SIZE", 16 if is_tless else 2))
    parser.add_argument("--epochs", type=int, default=1000 if is_tless else 30)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--ext", default="")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--pretrain", default=None)
    parser.add_argument("--data_split", default="primesense" if is_tless else "real+synt",
                        help='"+"-separated: real, synt, pbr (or primesense).')
    parser.add_argument("--truncate_obj", type=int, default=_env_int("SUO_TRUNCATE_OBJ", 16))
    parser.add_argument("--mask_occluded", action="store_true")
    parser.add_argument("--no_augmentations", action="store_true")
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="Cap steps per epoch (0 = full dataset); for smoke runs.")
    parser.add_argument("--val_steps", type=int, default=0,
                        help="Cap validation batches per epoch (0 = the whole split).")
    parser.add_argument("--val_start_epoch", type=int, default=5,
                        help="First epoch eligible for val-driven model_best.")
    parser.add_argument("--no_val", action="store_true",
                        help="Skip the held-out validation epoch.")
    parser.add_argument("--val_select_best", action="store_true",
                        help="Let the test-split val epoch drive model_best / best.txt "
                             "(off: the val split is the eval split; selection uses the "
                             "training loss).")
    parser.add_argument("--use_cache", action="store_true",
                        help="The native frame cache loader (not ported).")
    _common(parser)
    return _finish(parser, argv_override)


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
                        help=NORM_HELP)
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
                        help="Single-view throughput mode (--nviews 1, a real network): "
                             "the network runs a window of views per call; the results "
                             "equal the sequential sweep's.")
    parser.add_argument("--eval_window", type=int, default=16,
                        help="Views per precompute window for --batched.")
    parser.add_argument("--pipeline_scenes", type=int, default=0,
                        help="Pipelined throughput mode: K scenes (--nviews -1) or K SfM "
                             "keyframes (--nviews N>1) on K worker threads, one network "
                             "call per round; 0/1 disables, ignored with --nviews 1, "
                             "exclusive with --batched.")
    parser.add_argument("--int8", action="store_true",
                        help="int8-resident network inference (norm='batch' nets).")
    parser.add_argument("--int8_scales", default=None,
                        help="int8 activation-scales sidecar (default: the one beside "
                             "the checkpoint if present, else online calibration).")
    parser.add_argument("--int8_online_ok", action="store_true",
                        help="Accept online int8 calibration under --pipeline_scenes "
                             "(its output may differ from the sequential sweep's); "
                             "without it, --int8 --pipeline_scenes needs a sidecar.")
    _common(parser)
    return _finish(parser, argv_override)
