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

The default splits train as the JAX CLI's do: YCB-V `real+synt` composites
VOC backgrounds over `train_synt`, T-LESS `primesense` composites them and
pastes occluders, and `pbr` reads JPEG frames (`data/bop.py`,
`data/jpeg.py`); `--use_cache` packs any of them.

More than one card trains data-parallel, one process a card, as the JAX
CLI shards its step over every visible device: started plainly with N
cards visible, the CLI spawns N ranks (a card each, NCCL); started under
`torchrun` (`python -m torch.distributed.run --nproc_per_node N -m
suo_slam_tpu_torch.train ...`) it joins the group torchrun's environment
describes (NCCL on the cards, gloo with `--device cpu`). The global batch
is `--batch_size` frames, each rank training on its contiguous share
(`train/harness.make_sharded_train_step`: the joined batch's step); a
batch size that is no multiple of the cards trains on one card, with a
line saying so. Every rank replays the loader's shared stream and collates
the joined batch (a slice's collate is not the joined batch's slice: the
batch's largest frame and object count and the truncation draws of the
frames before it set it), then keeps its frames. Rank 0 alone writes the
checkpoints, `params.txt` and the dumps, and validates (unsharded, as the
JAX CLI does); the other ranks wait at a barrier after each epoch.

After each epoch's checkpoint the CLI dumps, as the JAX CLI does, the
net's predictions on the epoch's last training batch and the first
validation batch into `viz_<split>_epoch_<N>/sample.png`, and copies the
test split's folder to `viz_best/` when the epoch is the best.

    SUO_TINY_NET=1 python -m suo_slam_tpu_torch.train --device cpu \\
        --dataset ycbv --data_split real --epochs 2 [--loader process] [-u] ...
"""

from __future__ import annotations

import json
import os
import shutil
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
from ..parallel import mesh as pm
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


def plan_world(dev, batch_size: int) -> int:
    """The ranks a plain start trains on: every visible card when there are
    several and they divide the batch, else one (with a line saying so)."""
    if dev.type != "cuda" or dev.index is not None:
        return 1
    n = torch.cuda.device_count()
    if n > 1 and batch_size % n:
        print(f"batch size {batch_size} is no multiple of the {n} visible cards: "
              "training on one card")
        return 1
    return max(n, 1)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _under_torchrun() -> bool:
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _spawned_rank(rank: int, argv, world: int, init_method: str) -> None:
    """One rank of a plain multi-card start (`torch.multiprocessing.spawn`)."""
    args = get_train_args(argv)
    devices = [torch.device("cuda", i) for i in range(world)]
    _device.resolve_device(devices[rank])
    m = pm.data_parallel_mesh(devices, rank=rank, init_method=init_method)
    try:
        rc = _run(args, devices[rank], m)
    finally:
        m.close()
    if rc:
        raise SystemExit(rc)


def _main_torchrun(args) -> int:
    """A rank started by torchrun: join its group (or, where the cards do
    not divide the batch, rank 0 trains alone)."""
    world, local = int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", "0"))
    rank = int(os.environ.get("RANK", local))
    dev = torch.device("cuda", local) if args.device == "cuda" else torch.device("cpu")
    _device.resolve_device(dev)
    if args.batch_size % world:
        if rank:
            return 0
        print(f"batch size {args.batch_size} is no multiple of the {world} ranks: "
              "training on one card")
        return _run(args, dev, None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL binds the current card
    m = pm.data_parallel_mesh(None if dev.type == "cuda" else [dev] * world,
                              init_method="env://")
    try:
        return _run(args, dev, m)
    finally:
        m.close()


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


def _dump_epoch_viz(outdir, epoch, net, np_batch, dev, max_objs=4, split="train"):
    """The per-epoch prediction PNG (the reference dumps one every epoch into
    `viz_<split>_epoch_<N>`, `train.py:33-38,119-156`): the batch's first
    frame, its objects cropped (K1 on the card) and run through the net
    with its running statistics and no prior (K8, K9, K2), the first
    `max_objs` drawn by `eval/viz.make_frame_viz`. It leaves training as it
    was: no generator, no gradient, no statistics change. Only the write is
    best-effort (an OSError prints a line, as the JAX CLI prints its
    failures); a fault in the crop or the net stops the run. Returns the
    folder, or None when the write failed."""
    from ..data import png
    from ..eval.viz import make_frame_viz
    from ..ops import roi as roi_ops

    img = np_batch["images"][0]
    boxes = np_batch["boxes"][0]
    omask = np_batch["obj_mask"][0]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            crops = roi_ops.roi_crop_batch(
                torch.as_tensor(img[None], device=dev), torch.as_tensor(boxes[None], device=dev),
                torch.as_tensor(omask[None], device=dev), (256, 256))[0]
            out = net(crops)
    finally:
        net.train(was_training)
    uv = out.uv.float().cpu().numpy()
    cov = None if out.cov is None else out.cov.float().cpu().numpy()
    kp_mask = out.kp_mask.float().cpu().numpy()
    dets = {}
    for i in range(min(int(omask.sum()), max_objs)):
        obj_id = int(np_batch["obj_ids"][0][i]) if "obj_ids" in np_batch else i + 1
        dets[obj_id] = {
            "bbox": boxes[i],
            "uv": uv[i],
            "cov": None if cov is None else cov[i],
            "kp_mask": (kp_mask[i] > 0.3) & np_batch["kp_model_masks"][0][i],
        }
    viz = make_frame_viz(img, dets, {}, np_batch["K"][0])
    viz_dir = os.path.join(outdir, f"viz_{split}_epoch_{epoch}")
    try:
        os.makedirs(viz_dir, exist_ok=True)
        png.imwrite(os.path.join(viz_dir, "sample.png"), viz[..., ::-1])
    except OSError as e:
        print(f"viz dump failed: {e}")
        return None
    return viz_dir


def _ram_ok(max_percent: float = 99.0) -> bool:
    """Host RAM use below the limit (the reference exits above 99%)."""
    try:
        import psutil
    except ImportError:
        return True
    return psutil.virtual_memory().percent < max_percent


def main(argv=None) -> int:
    args = get_train_args(argv)
    if _under_torchrun():
        return _main_torchrun(args)
    dev = _device.resolve_device(args.device)
    world = plan_world(dev, args.batch_size)
    if world > 1:
        pm.spawn_ranks(world, "suo_slam_tpu_torch.train.__main__", "_spawned_rank",
                       argv if argv is not None else sys.argv[1:], world,
                       f"tcp://localhost:{_free_port()}")
        return 0
    return _run(args, dev, None)


def _run(args, dev, mesh) -> int:
    """Training on `dev`, as one rank of `mesh` (data parallel) or alone
    (mesh None)."""
    rank0 = mesh is None or mesh.rank == 0
    if not rank0:  # rank 0 alone prints the run's log
        sys.stdout = open(os.devnull, "w")
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
    if mesh is not None:
        pm.broadcast_module(net, mesh)  # every rank starts from rank 0's weights
        print(f"Data parallel: {mesh.world_size} ranks ({mesh.backend}), "
              f"{args.batch_size // mesh.world_size} frames a rank")
    if rank0:
        if outdir is None:
            outdir = os.path.join(results_root, ckpt.output_dir_name(args.dataset, split_tag,
                                                                     args.ext))
            os.makedirs(outdir, exist_ok=True)
        print(f"Writing results to {outdir}")
        with open(os.path.join(outdir, "params.txt"), "w") as f:
            json.dump(vars(args), f, indent=2)

    loader = build_loader(args, build_datasets(args))
    try:
        return _train(args, dev, net, state, loader, outdir, start_epoch, best_val, best_train,
                      mesh)
    finally:
        loader.close()


def _train(args, dev, net, state, loader, outdir, start_epoch, best_val, best_train,
           mesh=None) -> int:
    """The epoch loop: training steps, the validation epoch, checkpoints
    (on rank 0 of a mesh; the other ranks wait for it at a barrier)."""
    rank0 = mesh is None or mesh.rank == 0
    do_anneal = args.pretrain is None
    step_fn = (harness.make_train_step(do_anneal=do_anneal) if mesh is None
               else harness.make_sharded_train_step(mesh, do_anneal=do_anneal))
    eval_step = harness.make_eval_step(do_anneal=do_anneal)
    val_loader = None
    if not args.no_val and rank0:
        val_datasets = build_val_datasets(args)
        if val_datasets:
            # workers=1: in-line loading keeps the sample -> stream mapping fixed
            val_loader = ConcatLoader(val_datasets, args.batch_size, args.truncate_obj,
                                      seed=666, workers=1)
            print(f"Validating on {val_loader.total} held-out frames, "
                  f"{len(val_loader)} batches/epoch")
        else:
            print("WARNING: no test split on disk — model_best falls back to training loss")

    args_dict = vars(args).copy()
    for epoch in range(start_epoch, args.epochs):
        t_epoch = t0 = time.time()
        sum_loss, n_steps = torch.zeros((), device=dev), 0
        train_np_batch = None
        for i, np_batch in enumerate(loader.epoch()):
            if args.steps_per_epoch and i >= args.steps_per_epoch:
                break
            train_np_batch = np_batch
            mine = np_batch if mesh is None else pm.shard_batch(mesh, {
                k: np_batch[k] for k in harness.Batch._fields})
            batch = harness.to_batch(mine, dev, o_pad=args.truncate_obj)
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
        val_np_batch = None
        if val_loader is not None:
            v_sum, v_n = 0.0, 0
            for d in val_loader.datasets:
                d.reset_rng()  # identical prior draws every epoch
            for j, np_batch in enumerate(val_loader.epoch(shuffle=False, seed=666)):
                if args.val_steps and j >= args.val_steps:
                    break
                if val_np_batch is None:
                    val_np_batch = np_batch
                m = eval_step(net, harness.to_batch(np_batch, dev, o_pad=args.truncate_obj),
                              float(epoch))
                v_sum += float(m["uv_loss"])
                v_n += 1
                print(f"Test: [{j + 1}/{len(val_loader)}] uv_loss={v_sum / v_n:.3f} avg",
                      end="\r", flush=True)
            if v_n:
                val_err = v_sum / v_n
                print(f"\nEpoch {epoch} val uv_loss: {val_err:.4f}")

        if not rank0:  # rank 0 validates and writes; wait for it
            mesh.barrier()
            continue
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
        if train_np_batch is not None:
            _dump_epoch_viz(outdir, epoch, net, train_np_batch, dev, split="train")
        if val_np_batch is not None:
            viz_dir = _dump_epoch_viz(outdir, epoch, net, val_np_batch, dev, split="test")
            if is_best and viz_dir is not None:
                viz_best = os.path.join(outdir, "viz_best")
                if os.path.exists(viz_best):
                    shutil.rmtree(viz_best)
                shutil.copytree(viz_dir, viz_best)
        print(f"Epoch {epoch} done in {time.time() - t_epoch:.1f}s, train loss {train_loss:.4f}"
              + (f", val uv_loss {val_err:.4f}" if val_err is not None else "")
              + (" (best)" if is_best else ""))
        if mesh is not None:
            mesh.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
