"""Training CLI for PkpNet on BOP datasets: `python -m suo_slam_tpu_torch.train`.

Port of the JAX package's root `train.py`: the same flags (plus `--device`,
default `cuda`), results directory contract (auto-resume from the newest
`results/pkpnet_<dataset>_<split>_<ext>_<timestamp>`, with the checkpoint's
recorded `norm` / `no_network_cov` winning over the flags; `checkpoint-<N>`,
`checkpoint-latest`, `model_best` in the JAX package's format; `params.txt`),
losses (annealed MLE + variance + BCE), `--pretrain`, the epoch loop with
`--steps_per_epoch`, the validation epoch over the test split's keyframes
(`reset_rng` and a fixed seed, so it repeats exactly) and the selection of
`model_best` (training loss, or the validation error under
`--val_select_best`). The loss sum stays on the device; the host reads it on
print steps and at the epoch's end.

The data tier takes the JAX CLI's three modes: the thread loader (the
default), `--loader process` (a spawned process pool, `--workers`
processes) and `--use_cache` (the native frame cache,
`<data_root>/<split>.suocache`, packed at first use); augmentations are on
unless `--no_augmentations`. `-u` / `--no_network_cov` trains the L2 +
heatmap-variance loss, whose spread term the readout (K2, K19 backward)
gives without a probability map.

Refused, naming the ROADMAP item: more than one visible card (A15); the
datasets refuse VOC backgrounds (A21) and pbr splits (A22). The per-epoch
prediction dump is A11: one line says so.

    SUO_TINY_NET=1 python -m suo_slam_tpu_torch.train --device cpu \\
        --dataset ycbv --data_split real --epochs 2 [--loader process] [-u] ...
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .. import _device
from ..args import get_train_args
from ..data.bop import BopDataset
from ..data.fastload import CacheLoader
from ..data.loader import ConcatLoader
from ..models import convert
from ..models.pkpnet import PkpNet
from . import checkpoint as ckpt
from . import harness


def build_datasets(args):
    splits = [p if p.startswith("train") else f"train_{p}" for p in args.data_split.split("+")]
    return [BopDataset(args.data_root, split, bop_dset=args.dataset, map_by="view",
                       mask_occluded=args.mask_occluded, ignore_symmetry=False,
                       no_aug=args.no_augmentations, det_type=args.detection_type,
                       kp_config_root=args.kp_config_root, seed=123 + i)
            for i, split in enumerate(splits)]


def build_val_datasets(args):
    """The test split's keyframes ([] when the split is not on disk)."""
    split = "test_primesense" if args.dataset == "tless" else "test"
    if not os.path.isdir(os.path.join(args.data_root, split)):
        return []
    return [BopDataset(args.data_root, split, bop_dset=args.dataset, map_by="view",
                       ignore_symmetry=False, det_type="gt",
                       kp_config_root=args.kp_config_root, seed=666)]


def _refuse(dev) -> None:
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise SystemExit("suo_slam_tpu_torch.train: more than one card is visible: "
                         "data-parallel training is not ported (ROADMAP A15); set "
                         "CUDA_VISIBLE_DEVICES to one card")


def build_loader(args, datasets):
    """The training loader of the flags: the frame cache, or the thread /
    process loader."""
    if args.use_cache:
        paths = [os.path.join(args.data_root, f"{ds.split}.suocache") for ds in datasets]
        loader = CacheLoader(datasets, paths, args.batch_size, args.truncate_obj,
                             n_threads=args.workers)
        print(f"Native cache loader: {loader.total} frames ({len(datasets)} splits), "
              f"{len(loader)} steps/epoch")
        return loader
    loader = ConcatLoader(datasets, args.batch_size, args.truncate_obj, workers=args.workers,
                          mode=args.loader)
    print(f"Training on {loader.total} frames, {len(loader)} steps/epoch "
          f"({loader.workers} decode {loader.mode} workers)")
    return loader


def _ram_ok(max_percent: float = 99.0) -> bool:
    """Host RAM use below the limit (the reference exits above 99%)."""
    try:
        import psutil
    except ImportError:
        return True
    return psutil.virtual_memory().percent < max_percent


def main(argv=None) -> int:
    args = get_train_args(argv)
    dev = _device.resolve_device(args.device)
    print("======= Train Args ================")
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")
    print("===================================")

    results_root = os.path.join(os.getcwd(), "results")
    split_tag = args.data_split
    resume_path = None
    if args.checkpoint_path:
        resume_path = args.checkpoint_path
    elif not args.no_resume:
        resume_dir = ckpt.find_resume_dir(results_root, args.dataset, split_tag, args.ext)
        if resume_dir is not None:
            resume_path = os.path.join(resume_dir, "checkpoint-latest")
    if resume_path is not None:
        trained = ckpt.peek_checkpoint_args(resume_path)
        for flag in ("norm", "no_network_cov"):
            if flag in trained and trained[flag] != getattr(args, flag):
                print(f"Resume: overriding --{flag}={getattr(args, flag)} with the "
                      f"checkpoint's recorded {trained[flag]!r}")
                setattr(args, flag, trained[flag])
    _refuse(dev)

    tiny = bool(int(os.environ.get("SUO_TINY_NET", "0")))  # smoke tests
    net = PkpNet(calc_cov=not args.no_network_cov, norm=args.norm,
                 dtype=torch.bfloat16 if args.bf16 else torch.float32,
                 **(dict(n_stack=1, n_modules=1, features=16) if tiny else {})).to(dev)
    state = harness.init_state(net, seed=0, lr=args.lr)

    start_epoch, best_val, best_train, outdir = 0, float("inf"), float("inf"), None
    if resume_path is not None:
        print(f"{'Resuming' if args.checkpoint_path else 'Auto-resuming'} from {resume_path}")
        state, start_epoch, _, best_val, best_train = ckpt.load_checkpoint(resume_path, state)
        start_epoch += 1
        outdir = os.path.dirname(resume_path)
    if args.pretrain:
        variables, _, _ = ckpt.load_model_only(args.pretrain)
        net.load_state_dict(convert.from_jax_variables(variables))
    if outdir is None:
        outdir = os.path.join(results_root, ckpt.output_dir_name(args.dataset, split_tag,
                                                                 args.ext))
        os.makedirs(outdir, exist_ok=True)
    print(f"Writing results to {outdir}")
    with open(os.path.join(outdir, "params.txt"), "w") as f:
        json.dump(vars(args), f, indent=2)

    loader = build_loader(args, build_datasets(args))
    try:
        return _train(args, dev, net, state, loader, outdir, start_epoch, best_val, best_train)
    finally:
        loader.close()


def _train(args, dev, net, state, loader, outdir, start_epoch, best_val, best_train) -> int:
    """The epoch loop: training steps, the validation epoch, checkpoints."""
    do_anneal = args.pretrain is None
    step_fn = harness.make_train_step(do_anneal=do_anneal)
    eval_step = harness.make_eval_step(do_anneal=do_anneal)
    val_loader = None
    if not args.no_val:
        val_datasets = build_val_datasets(args)
        if val_datasets:
            # workers=1: in-line loading keeps the sample -> stream mapping fixed
            val_loader = ConcatLoader(val_datasets, args.batch_size, args.truncate_obj,
                                      seed=666, workers=1)
            print(f"Validating on {val_loader.total} held-out frames, "
                  f"{len(val_loader)} batches/epoch")
        else:
            print("WARNING: no test split on disk — model_best falls back to training loss")
    print("per-epoch viz dump: not ported (ROADMAP A11)")

    args_dict = vars(args).copy()
    for epoch in range(start_epoch, args.epochs):
        t_epoch = t0 = time.time()
        sum_loss, n_steps = torch.zeros((), device=dev), 0
        for i, np_batch in enumerate(loader.epoch()):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            batch = harness.to_batch(np_batch, dev, o_pad=args.truncate_obj)
            state, metrics = step_fn(state, batch, float(epoch))
            sum_loss = sum_loss + metrics["loss"]
            n_steps += 1
            if not _ram_ok():
                print("RAM usage too high (>99%). Exiting.")
                return 1
            if (i + 1) % 10 == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"Epoch: {epoch} [{i + 1}/{len(loader)}] "
                      f"loss_tot={m['loss']:.3f} uv_loss={m['uv_loss']:.3f} "
                      f"var_loss=({m['var_lambda']:.3f},{m['var_loss']:.3f}) "
                      f"mask_loss=({m['mask_lambda']:.3f},{m['mask_loss']:.3f}) "
                      f"sec/it={(time.time() - t0) / (i + 1):.2f}", flush=True)
        train_loss = float(sum_loss) / max(1, n_steps)

        val_err = None
        if val_loader is not None:
            v_sum, v_n = 0.0, 0
            for d in val_loader.datasets:
                d.reset_rng()  # identical prior draws every epoch
            for j, np_batch in enumerate(val_loader.epoch(shuffle=False, seed=666)):
                if args.val_steps and j >= args.val_steps:
                    break
                m = eval_step(net, harness.to_batch(np_batch, dev, o_pad=args.truncate_obj),
                              float(epoch))
                v_sum += float(m["uv_loss"])
                v_n += 1
                print(f"Test: [{j + 1}/{len(val_loader)}] uv_loss={v_sum / v_n:.3f} avg",
                      end="\r", flush=True)
            if v_n:
                val_err = v_sum / v_n
                print(f"\nEpoch {epoch} val uv_loss: {val_err:.4f}")

        # model_best: the training loss by default; the validation error only
        # under --val_select_best (the val split is the evaluation split)
        is_best = False
        if args.val_select_best and val_err is not None:
            if epoch >= args.val_start_epoch and val_err < best_val:
                with open(os.path.join(outdir, "best.txt"), "w") as f:
                    f.write(f"epoch={epoch}\nval_err={val_err}\nprev_best={best_val}")
                best_val, is_best = val_err, True
        elif not args.val_select_best and train_loss < best_train:
            best_train, is_best = train_loss, True
        ckpt.save_checkpoint(outdir, state, epoch, args_dict, best_val, is_best=is_best,
                             best_train=best_train)
        print(f"Epoch {epoch} done in {time.time() - t_epoch:.1f}s, train loss {train_loss:.4f}"
              + (f", val uv_loss {val_err:.4f}" if val_err is not None else "")
              + (" (best)" if is_best else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
