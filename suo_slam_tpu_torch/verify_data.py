"""Data check before training or evaluating: `python -m suo_slam_tpu_torch.verify_data`.

Port of the JAX package's `scripts/verify_data.py` (its flags, checks, PASS
/ SKIP / FAIL lines and exit code) through the port's own readers; it
imports no JAX and no OpenCV. It checks a `data/bop_datasets/` tree laid
out as the reference's README describes, then prints the commands to run
on it. Every check is independent; a failed one is reported and the exit
code is 1.

    python -m suo_slam_tpu_torch.verify_data [--bop_root data/bop_datasets]
        [--dataset ycbv|tless|all] [--checkpoint path] [--kp_config_root dir]

Checked per dataset:
  - the layout (models directories, keyframe / target lists);
  - the mesh database (`data/mesh.py`: models_info.json and every PLY);
  - the kp_info schema (names of the 41-keypoint vocabulary, pos_mean[3],
    pos_cov[9], view_pose[16]) for every object in models_info;
  - one `BopDataset.get_raw` on each split present, `train_pbr` (JPEG
    frames) and the synthetic splits' VOC compositing included;
  - the saved detections (`eval/detections.py`: PoseCNN with offsets.txt for
    YCB-V, Pix2Pose for T-LESS) and their detection map;
then the VOC backgrounds (one decoded through `data/jpeg.py` and resized to
480x640 as the composite does) and, with `--checkpoint`, the network's
load (`eval/loading.py`). The evaluation sweeps of `scripts/eval_all_*.sh`
have no port yet; the printed commands drive the port's CLIs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"

YCBV_SPLITS = ("train_real", "train_synt", "train_pbr", "test")
TLESS_SPLITS = ("train_primesense", "test_primesense")


def _fmt(status, name, detail=""):
    pad = " " * max(1, 44 - len(name))
    return f"  [{status}] {name}{pad}{detail}"


class Report:
    def __init__(self):
        self.rows = []

    def add(self, status, name, detail=""):
        self.rows.append((status, name, detail))
        print(_fmt(status, name, detail), flush=True)

    @property
    def failed(self):
        return [r for r in self.rows if r[0] == FAIL]


def check(report, name, fn, skip_reason=None):
    """Run one check; an exception is a FAIL row with its message."""
    if skip_reason is not None:
        report.add(SKIP, name, skip_reason)
        return None
    try:
        detail = fn()
        report.add(PASS, name, detail or "")
        return True
    except Exception as e:  # noqa: BLE001 - report and go on
        report.add(FAIL, name, f"{type(e).__name__}: {e}")
        return False


def _require(path, isdir):
    def run():
        if not (os.path.isdir(path) if isdir else os.path.isfile(path)):
            raise FileNotFoundError(path)
    return run


def _models_dir(ds_root, dataset):
    return os.path.join(ds_root, "models_bop-compat" if dataset == "ycbv" else "models_cad")


def check_layout(report, ds_root, dataset):
    models = (["models_bop-compat", "models_bop-compat_eval"] if dataset == "ycbv"
              else ["models_cad", "models_eval"])
    for d in models:
        check(report, f"{dataset}/{d}/", _require(os.path.join(ds_root, d), True))
    extra = "keyframe.txt" if dataset == "ycbv" else "all_target_tless.json"
    check(report, f"{dataset}/{extra}", _require(os.path.join(ds_root, extra), False))


def check_mesh_db(report, ds_root, dataset):
    from .data.mesh import load_mesh_db

    models_dir = os.path.join(ds_root, "models_bop-compat_eval" if dataset == "ycbv"
                              else "models_eval")
    if not os.path.isdir(models_dir):
        models_dir = _models_dir(ds_root, dataset)

    def run():
        db = load_mesh_db(models_dir)
        return f"{len(db.diameter)} meshes, {int(db.is_symmetric.sum())} symmetric"

    check(report, f"{dataset} mesh database", run)


def check_kp_info(report, ds_root, dataset):
    from .kp import config as kp_config

    def run():
        with open(os.path.join(_models_dir(ds_root, dataset), "models_info.json")) as f:
            obj_ids = sorted(int(k) for k in json.load(f))
        names = set(kp_config.kp_list)
        n_kp = 0
        for obj_id in obj_ids:
            p = os.path.join(ds_root, "kp_info", f"obj_{obj_id:06d}_kp_info.json")
            with open(p) as f:
                info = json.load(f)
            assert "keypoints" in info and "view_pose" in info, p
            assert len(info["view_pose"]) == 16, f"{p}: view_pose != 16 floats"
            for name, kp in info["keypoints"].items():
                assert name in names, f"{p}: unknown keypoint name {name!r}"
                assert len(kp["pos_mean"]) == 3, f"{p}:{name} pos_mean != 3"
                assert len(kp["pos_cov"]) == 9, f"{p}:{name} pos_cov != 9"
                n_kp += 1
        return f"{len(obj_ids)} objects, {n_kp} labeled keypoints"

    check(report, f"{dataset} kp_info schema", run)


def check_splits(report, ds_root, dataset, kp_config_root):
    from .data.bop import BopDataset

    any_present = False
    for split in YCBV_SPLITS if dataset == "ycbv" else TLESS_SPLITS:
        name = f"{dataset}/{split} get_raw"
        if not os.path.isdir(os.path.join(ds_root, split)):
            check(report, name, None, skip_reason="split not on disk")
            continue
        any_present = True

        def run(split=split):
            ds = BopDataset(ds_root, split, bop_dset=dataset,
                            ignore_symmetry="test" in split,
                            kp_config_root=kp_config_root, seed=0)
            s = ds.scene_ids()[0]
            v = ds.view_ids(s)[0]
            obj_ids = ds.obj_ids(s, v)
            if dataset == "tless" and split == "train_primesense":
                obj_ids = obj_ids[:1]  # one object a sample, as the paste path asserts
            raw = ds.get_raw(s, v, obj_ids)
            bg = f", {len(ds.bg_image_files)} backgrounds" if ds.bg_image_files else ""
            return (f"scene {s} view {v}: {len(obj_ids)} objects, "
                    f"{int(raw['kp_masks'].sum())} projected kps, img {raw['img'].shape}{bg}")

        check(report, name, run)
    if not any_present:
        report.add(FAIL, f"{dataset} splits", "no split directory found")


def check_saved_detections(report, bop_root, dataset):
    from .eval import detections as det

    if dataset == "ycbv":
        name = "ycbv PoseCNN detections"
        need = [os.path.join(bop_root, "saved_detections", "ycbv_posecnn.pkl"),
                os.path.join(bop_root, "ycbv", "offsets.txt")]
        load = det.load_posecnn_results
    else:
        name = "tless Pix2Pose detections"
        need = [os.path.join(bop_root, "saved_detections",
                             "tless_pix2pose_retinanet_siso_top1.pkl")]
        load = det.load_pix2pose_results
    missing = [p for p in need if not os.path.isfile(p)]
    if missing:
        check(report, name, None,
              skip_reason=f"missing {missing[0]} (GT-detection eval still works)")
        return

    def run():
        data = det.build_detection_map(load(bop_root))
        return f"{len(data)} frames, {sum(len(v) for v in data.values())} detections"

    check(report, name, run)


def check_voc(report, bop_root):
    bg_dir = os.environ.get("SUO_BG_IMAGES_DIR",
                            os.path.join(bop_root, "VOCdevkit/VOC2012/JPEGImages"))
    if not os.path.isdir(bg_dir):
        check(report, "VOC backgrounds", None,
              skip_reason=f"{bg_dir} absent (needed only for synthetic TRAINING splits)")
        return

    def run():
        from .data import augmentations, bop

        exts = (".jpg", ".jpeg", ".JPEG", ".png")
        files = sorted(f for f in os.listdir(bg_dir) if f.endswith(exts))
        assert files, f"no images in {bg_dir}"
        img = bop._imread(os.path.join(bg_dir, files[0]))
        out = augmentations.resize_linear(img, (640, 480))
        return (f"{len(files)} images; {files[0]} {img.shape[0]}x{img.shape[1]} decoded, "
                f"resized to {out.shape[0]}x{out.shape[1]}")

    check(report, "VOC backgrounds", run)


def check_checkpoint(report, chkpt):
    if not chkpt:
        check(report, "checkpoint load", None,
              skip_reason="pass --checkpoint to test conversion/load")
        return

    def run():
        from .eval.loading import load_eval_network

        net, epoch = load_eval_network(chkpt, bf16=False)
        n = sum(p.numel() for p in net.parameters())
        kind = "torch-converted" if chkpt.endswith((".pth.tar", ".pth")) else "native"
        return f"{kind}, epoch {epoch}, {n / 1e6:.1f}M params"

    check(report, "checkpoint load", run)


def print_commands(bop_root, datasets, chkpt):
    ck = chkpt or "results/<run>/model_best"
    print("\nAll required checks passed. Commands (the port's CLIs):")
    for ds in datasets:
        root = os.path.join(bop_root, ds)
        ev = (f"python -m suo_slam_tpu_torch.evaluate --dataset {ds} --no_viz "
              f"--checkpoint_path {ck} --data_root {root}")
        n_pipe = 12 if ds == "ycbv" else 20
        split = "real+synt" if ds == "ycbv" else "primesense"
        print(f"\n  # {ds}: train on the default split")
        print(f"  python -m suo_slam_tpu_torch.train --dataset {ds} --data_split {split} "
              f"--data_root {root}")
        print(f"  # SLAM and single-view evaluation")
        print(f"  {ev} --nviews -1")
        print(f"  {ev} --nviews 1")
        print(f"  # throughput mode (the same results):")
        print(f"  {ev} --nviews -1 --pipeline_scenes {n_pipe}")
        print(f"  # metric-code sanity on the shipped detections:")
        print(f"  python -m suo_slam_tpu_torch.evaluate --dataset {ds} --nviews 1 --no_viz "
              f"--debug_saved_only --checkpoint_path '' --data_root {root}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bop_root", default="data/bop_datasets")
    ap.add_argument("--dataset", default="all", choices=["ycbv", "tless", "all"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--kp_config_root", default=None,
                    help="Override kp_configs dir (default: <ds_root>/kp_configs "
                         "if present, else the repo's kp_configs/)")
    args = ap.parse_args(argv)

    bop_root = os.path.abspath(args.bop_root)
    datasets = ["ycbv", "tless"] if args.dataset == "all" else [args.dataset]
    datasets = [d for d in datasets if os.path.isdir(os.path.join(bop_root, d))]
    report = Report()
    if not datasets:
        report.add(FAIL, "bop_root", f"no ycbv/ or tless/ under {bop_root}")

    for ds in datasets:
        ds_root = os.path.join(bop_root, ds)
        kp_root = args.kp_config_root
        if kp_root is None:
            cand = os.path.join(ds_root, "kp_configs")
            kp_root = cand if os.path.isdir(cand) else None
        print(f"\n== {ds} ({ds_root}) ==")
        check_layout(report, ds_root, ds)
        check_mesh_db(report, ds_root, ds)
        check_kp_info(report, ds_root, ds)
        check_splits(report, ds_root, ds, kp_root)
        check_saved_detections(report, bop_root, ds)
    print()
    check_voc(report, bop_root)
    check_checkpoint(report, args.checkpoint)

    if report.failed:
        print(f"\n{len(report.failed)} check(s) FAILED:")
        for status, name, detail in report.failed:
            print(_fmt(status, name, detail))
        return 1
    print_commands(bop_root, datasets, args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
