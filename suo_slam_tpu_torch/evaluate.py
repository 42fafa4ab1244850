"""Evaluation over BOP datasets: single-view, SfM and SLAM modes.

Port of the sequential path of the JAX package's `evaluate.py`: the same
flags (`suo_slam_tpu_torch/args.py`), the same per-dataset settings, the same
outputs — a per-method outdir (`method_name()`) with `summary.txt` (the
ADD/ADD-S AUC table, the share of camera poses found, tracking Hz, the mean
keypoint stdev) and the BOP'19 CSV `scene_id,im_id,obj_id,score,R(9),t(3),
time`, plus the VSD recall for T-LESS — driving the port's `ObjectSlam` on
the card (`--device cpu` runs the plain PyTorch versions).

    python -m suo_slam_tpu_torch.evaluate --dataset ycbv --nviews -1 \\
        --checkpoint_path <ref>.pth.tar --no_viz [--device cpu] [--int8]

`--int8` serves the network with the s8-resident executor: its scales come
from `--int8_scales`, else from the sidecar beside the checkpoint
(`python -m suo_slam_tpu_torch.calibrate_int8` writes it), else from online
calibration over the first frames. Not ported yet, and refused with
SystemExit naming their ROADMAP items: visualization (viz is on unless
`--no_viz`; `--viz_cov`, `--do_viz_extra`, `--show_viz`), the throughput
modes `--batched` and `--pipeline_scenes`, and `--int8_online_ok`, which
only qualifies the latter.
"""

from __future__ import annotations

import os
import time

import numpy as np

YCBV_CLASSES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
    17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick",
}
TLESS_CLASSES = {i + 1: str(i + 1) for i in range(30)}


def refuse_unported(no_viz=True, viz_cov=False, do_viz_extra=False, show_viz=False,
                    batched=False, pipeline_scenes=0, int8_online_ok=False,
                    debug_saved_only=False):
    """SystemExit for a flag whose path is not ported yet, naming its
    ROADMAP item."""
    viz = [f for f, on in (("--viz_cov", viz_cov), ("--do_viz_extra", do_viz_extra),
                           ("--show_viz", show_viz)) if on]
    if not no_viz and not debug_saved_only:
        viz.insert(0, "viz (on unless --no_viz)")
    if viz:
        raise SystemExit(f"{', '.join(viz)}: visualization is not ported yet: ROADMAP A11 "
                         "(pass --no_viz)")
    if batched or int(pipeline_scenes) > 1:
        flag = "--batched" if batched else "--pipeline_scenes"
        raise SystemExit(f"{flag}: the throughput evaluation modes are not ported yet: "
                         "ROADMAP A13")
    if int8_online_ok:
        raise SystemExit("--int8_online_ok qualifies --pipeline_scenes, which is not "
                         "ported yet: ROADMAP A13")


class Evaluator:
    """The sequential evaluation sweep. Library callers may pass a prebuilt
    `net` (a `models.pkpnet.PkpNet` with its weights, in the dtype it should
    run in) instead of a checkpoint, and a `hyp_sampler` factory for the
    engine's random draws (`slam.engine.ObjectSlam`)."""

    def __init__(self, dataset, data_root, chkpt_path, nviews=1,
                 no_network_cov=False, detection_type="saved", debug_gt_kp=False,
                 gt_cam_pose=False, no_prior_det=False, no_viz=True,
                 debug_saved_only=False, give_all_prior=False,
                 kp_config_root=None, bf16=True, norm="batch", int8=False,
                 int8_scales=None, ref_manual_info=False, viz_cov=False,
                 do_viz_extra=False, show_viz=False, batched=False, pipeline_scenes=0,
                 int8_online_ok=False, device="cuda", net=None, hyp_sampler=None):
        from ._device import resolve_device
        from .data.bop import BopDataset
        from .data.mesh import load_mesh_db
        from .slam.engine import ObjectSlam, SlamConfig

        refuse_unported(no_viz, viz_cov, do_viz_extra, show_viz, batched,
                        pipeline_scenes, int8_online_ok, debug_saved_only)
        self.device = resolve_device(device)
        self.model_path = os.path.dirname(chkpt_path) if chkpt_path else "results"
        # per-dataset settings
        kp_var_thresh, bbox_thresh = 0.2, 0.9
        opt_init_with_outliers = False
        if dataset == "ycbv":
            models, split, self.do_add = "models_bop-compat_eval", "test", True
            manual_kp_std = 0.01
        else:
            models, split, self.do_add = "models_eval", "test_primesense", False
            kp_var_thresh, bbox_thresh = 0.5, 1.0
            manual_kp_std = 0.1
            opt_init_with_outliers = True

        self.dataset = BopDataset(
            data_root, split, bop_dset=dataset, ignore_symmetry=True,
            kp_config_root=kp_config_root, seed=666,
        )
        models_dir = os.path.join(data_root, models)
        if not os.path.isdir(models_dir):  # the eval-model dir is optional
            models_dir = self.dataset.models_dir
        self.mesh_db = load_mesh_db(models_dir)

        self.debug_saved_only = debug_saved_only
        self.model_epoch = -1
        self.object_slam = None
        if not debug_saved_only:
            if net is None and not debug_gt_kp:
                from .eval.loading import load_eval_network

                net, self.model_epoch = load_eval_network(
                    chkpt_path, bf16=bf16, norm=norm, no_network_cov=no_network_cov,
                )
            scales_path = self._int8_scales_path(int8, net, norm, chkpt_path, int8_scales)
            cfg = SlamConfig(
                sfm_mode=nviews > 1,
                single_view_mode=nviews == 1,
                no_network_cov=no_network_cov or debug_gt_kp,
                no_prior_det=no_prior_det,
                give_all_prior=give_all_prior,
                debug_gt_kp=debug_gt_kp,
                kp_var_thresh=kp_var_thresh,
                bbox_thresh=bbox_thresh,
                manual_kp_std=manual_kp_std,
                opt_init_with_outliers=opt_init_with_outliers,
                ref_manual_info=ref_manual_info,
                int8_inference=int8,
                int8_scales_path=scales_path,
            )
            self.object_slam = ObjectSlam(
                cfg, mesh_db=self.mesh_db, net=None if debug_gt_kp else net,
                hyp_sampler=hyp_sampler, device=self.device,
            )
        self.nviews = nviews
        self.detection_type = detection_type
        self.debug_gt_kp = debug_gt_kp
        self.gt_cam_pose = gt_cam_pose
        self.give_all_prior = give_all_prior
        self.no_network_cov = no_network_cov
        self.no_prior_det = no_prior_det
        self.rng = np.random.default_rng(666)

        self.saved_detections = None
        if detection_type == "saved":
            from .eval.detections import (
                build_detection_map,
                load_pix2pose_results,
                load_posecnn_results,
            )

            bop_root = os.path.realpath(os.path.join(data_root, ".."))
            if dataset == "ycbv":
                self.saved_detections = load_posecnn_results(bop_root)
            else:
                self.saved_detections = load_pix2pose_results(bop_root)
            self.saved_detections_map = build_detection_map(
                self.saved_detections, self.dataset.targets
            )

    @staticmethod
    def _int8_scales_path(int8, net, norm, chkpt_path, int8_scales):
        """The scales sidecar an int8 run serves with: `int8_scales`, else
        the checkpoint's own (`default_scales_path`), else None (online
        calibration, announced). SystemExit without a norm='batch' network
        or when an explicit `int8_scales` is missing."""
        if not int8:
            return None
        if net is None or norm != "batch":
            raise SystemExit(
                "--int8 requires a norm='batch' network (the int8 executor folds "
                "BatchNorm into its convolution epilogues); got "
                + ("no network (--debug_gt_kp)" if net is None else f"norm={norm!r}"))
        from .eval.loading import default_scales_path

        cand = int8_scales or default_scales_path(chkpt_path)
        if os.path.isfile(cand):
            print(f"[evaluate] int8 scales sidecar: {cand}")
            return cand
        if int8_scales:
            raise SystemExit(f"--int8_scales not found: {int8_scales}")
        print("[evaluate] no int8 scales sidecar (run python -m "
              "suo_slam_tpu_torch.calibrate_int8 to persist one) — falling back "
              "to online first-frames calibration")
        return None

    # ------------------------------------------------------------------ run --
    def run(self):
        t0 = time.time()
        try:
            summary = self._run()
        except Exception:
            import traceback

            traceback.print_exc()
            summary = None
        print(f"Eval took {time.time() - t0:.3f} sec")
        return summary

    def method_name(self):
        method = (
            f"pkpnet-epoch={self.model_epoch}-nviews={self.nviews}"
            f"-det={self.detection_type}"
        )
        if self.debug_gt_kp:
            method += "-GT-KP"
        if self.gt_cam_pose:
            method += "-GT-CAM-POSE"
        if self.give_all_prior:
            method += "-ALL-PRIOR"
        if self.no_network_cov:
            method += "-NO-COV"
        if self.no_prior_det:
            method += "-NO-PRIOR-DET"
        return method + f"_{self.dataset.bop_dset}-{self.dataset.split}"

    def _run(self):
        from .eval.meter import EvalMeter

        if self.saved_detections is not None:
            self.saved_det_meter = EvalMeter(self.mesh_db, device=self.device)
        num_cam_poses_found = 0
        num = 0
        csv_lines = []
        outdir = None
        if not self.debug_saved_only:
            self.meter = EvalMeter(self.mesh_db, device=self.device)
            outdir = os.path.join(self.model_path, self.method_name())
            os.makedirs(outdir, exist_ok=True)
            print(f"Writing eval results to {outdir}")

        scene_ids = self.dataset.scene_ids()
        for i, scene_id in enumerate(scene_ids):
            view_ids = self.dataset.view_ids(scene_id)
            if not self.debug_saved_only and self.nviews < 0:
                self.object_slam.reset()
            scene_results = []
            for j, view_id in enumerate(view_ids):
                print(
                    f"Running scene [{i + 1}/{len(scene_ids)}] "
                    f"view [{j + 1}/{len(view_ids)}]",
                    flush=True,
                )
                gt_obj_ids = self.dataset.obj_ids(scene_id, view_id)
                if not self.debug_saved_only:
                    views_to_proc = [view_id]
                    if self.nviews > 1:
                        views_to_proc += self._sample_sfm_views(view_ids, j)
                    results = self._run_slam(scene_id, views_to_proc)
                    if len(results) == 0:
                        continue
                    pred_poses = (
                        results[view_id]["poses"] if self.nviews > 0 else None
                    )
                    scene_results.append((view_id, pred_poses, gt_obj_ids))

                if self.do_add and self.saved_detections is not None:
                    self._update_saved_det_meter(scene_id, view_id, gt_obj_ids)

            if self.debug_saved_only:
                continue
            # score the whole scene with the final optimized state
            final_results = (
                self.object_slam.collect_results(final=True)
                if self.nviews < 0 else None
            )
            n, nc = self._score_scene(
                scene_id, scene_results, final_results, csv_lines
            )
            num += n
            num_cam_poses_found += nc

        gt_obj_map = YCBV_CLASSES if self.dataset.bop_dset == "ycbv" else TLESS_CLASSES
        gt_obj_map = {
            o: n for o, n in gt_obj_map.items() if o <= self.dataset.num_obj()
        }
        summary = {}
        if self.do_add and self.saved_detections is not None:
            print("\nSaved detections result:")
            self.saved_det_meter.pprint_objs_str(gt_obj_map)
            summary["saved_det"] = {
                k: v[0] for k, v in self.saved_det_meter.result().items()
            }
        if not self.debug_saved_only:
            if self.do_add:
                print(f"\n{self.method_name()} result:")
                print(self.meter.pprint_objs_str(gt_obj_map))
                summary["ours"] = {k: v[0] for k, v in self.meter.result().items()}
            with open(os.path.join(outdir, "summary.txt"), "w") as f:
                if self.do_add:
                    f.write(self.meter.pprint_objs_str(gt_obj_map))
                if num > 0:
                    hz = self.object_slam.tracking_hz()
                    lines = [
                        f"NOTE: {100 * num_cam_poses_found / num:.1f}% of camera poses found!",
                        f"TIMING: Tracking {hz:.2f} Hz",
                        f"Average keypoint stdev: {self.object_slam.avg_kp_std():.5f}",
                    ]
                    for s in lines:
                        print(s)
                        f.write("\n" + s + "\n")
                    summary["cam_pose_pct"] = 100 * num_cam_poses_found / num
                    summary["tracking_hz"] = hz
            csv_path = os.path.join(outdir, self.method_name() + ".csv")
            with open(csv_path, "w") as f:
                f.writelines(csv_lines)
            print(f"CSV (BOP format) results written to {csv_path}")
            if self.dataset.bop_dset == "tless":
                from .eval.vsd import run_vsd_eval

                summary["vsd"] = run_vsd_eval(csv_path, self.dataset, self.mesh_db, outdir)
        return summary

    def _score_scene(self, scene_id, scene_results, final_results, csv_lines):
        """Score one finished scene (meter updates + BOP CSV lines); returns
        (n_views_scored, n_cam_poses_found)."""
        num = num_cam = 0
        for view_id, pred_poses, gt_obj_ids in scene_results:
            num += 1
            if self.nviews < 0:
                if view_id not in final_results:
                    if self.do_add:
                        for obj_id in gt_obj_ids:
                            self.meter.update_no_det([obj_id])
                    continue
                num_cam += 1
                pred_poses = final_results[view_id]["poses"]
            for obj_id in gt_obj_ids:
                r = pred_poses.get(obj_id)
                if r is not None and r["T_OtoC"] is not None:
                    gt_pose = self.dataset.get_obj_pose(scene_id, view_id, obj_id)
                    if self.do_add:
                        self.meter.update([obj_id], [r["T_OtoC"]], [gt_pose])
                    R, t = r["T_OtoC"][:3, :3], r["T_OtoC"][:3, 3]
                    arr2str = lambda x: " ".join(
                        str(e) for e in np.asarray(x).reshape(-1).tolist()
                    )
                    if self.dataset.is_target(scene_id, view_id, obj_id):
                        csv_lines.append(
                            f"{scene_id},{view_id},{obj_id},{r['score']},"
                            f"{arr2str(R)},{arr2str(t)},-1\n"
                        )
                else:
                    self.meter.update_no_det([obj_id])
        return num, num_cam

    def _sample_sfm_views(self, view_ids, j):
        """Extra views for keyframe j's SfM re-solve."""
        others = view_ids[:j] + view_ids[j + 1 :]
        return list(self.rng.choice(
            others, size=min(self.nviews - 1, len(others)), replace=False
        ))

    def _update_saved_det_meter(self, scene_id, view_id, gt_obj_ids):
        for gt_obj_id in gt_obj_ids:
            sd = self.saved_detections_map.get(scene_id, {}).get(view_id, {})
            if gt_obj_id in sd:
                idx = sd[gt_obj_id]
                self.saved_det_meter.update(
                    [gt_obj_id],
                    [self.saved_detections["poses"][idx]],
                    [self.dataset.get_obj_pose(scene_id, view_id, gt_obj_id)],
                )
            else:
                self.saved_det_meter.update_no_det([gt_obj_id])

    def _view_inputs(self, scene_id, view_id):
        """Per-view detections + sample: (obj_ids [N], bboxes [N, 4],
        sample) or None when saved detections have nothing usable."""
        obj_ids_gt = self.dataset.obj_ids(scene_id, view_id)
        if "gt" in self.detection_type:
            obj_ids = obj_ids_gt
        else:
            sd = self.saved_detections_map.get(scene_id, {}).get(view_id, {})
            obj_ids = [o for o in sd if o in obj_ids_gt]
            if not obj_ids:
                return None
        sample = self.dataset.get_raw(scene_id, view_id, obj_ids, p_give_prior=0.0)
        if "gt" in self.detection_type:
            bboxes = sample["bboxes"]
        else:
            sd = self.saved_detections_map[scene_id][view_id]
            bboxes = np.stack(
                [self.saved_detections["bboxes"][sd[o]] for o in obj_ids]
            )
        return np.asarray(obj_ids, np.int64), np.asarray(bboxes), sample

    def _feed_view(self, engine, scene_id, view_id_k, first_for_gt_cam=-1):
        """Load one view's detections and feed `engine.process_view`;
        False when the view has no usable detections."""
        inputs = self._view_inputs(scene_id, view_id_k)
        if inputs is None:
            print(f"WARNING no detections for scene {scene_id} view {view_id_k}")
            return False
        obj_ids, bboxes, sample = inputs
        cam_pose = None
        if self.gt_cam_pose:
            from .data.bop import _to44_cam

            cam_pose = _to44_cam(
                self.dataset.get_cam_pose(scene_id, view_id_k)
            ) @ np.linalg.inv(
                _to44_cam(self.dataset.get_cam_pose(scene_id, first_for_gt_cam))
            )
        engine.process_view(
            view_id_k, sample["img"], sample["K"],
            np.asarray(obj_ids, np.int64), np.asarray(bboxes, np.float32),
            sample["model_kps"], sample["kp_model_masks"], sample["kp_masks"],
            uv_gt=sample["kp_uvs"] if self.debug_gt_kp else None,
            cam_pose=cam_pose,
        )
        return True

    def _run_slam(self, scene_id, views_to_proc):
        if self.nviews > 0:
            self.object_slam.reset()
        else:
            assert len(views_to_proc) == 1
        for view_id_k in views_to_proc:
            first = -1 if self.nviews < 0 else int(views_to_proc[0])
            self._feed_view(self.object_slam, scene_id, int(view_id_k),
                            first_for_gt_cam=first)
        return self.object_slam.collect_results(last_only=self.nviews < 0)


def main(argv=None):
    from .args import get_args

    args = get_args(argv)
    if args.debug_gt_kp:
        args.detection_type = "gt"
    print("======= Eval Args ================")
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")
    print("==================================")
    np.random.seed(666)
    Evaluator(
        args.dataset, args.data_root, args.checkpoint_path, nviews=args.nviews,
        no_network_cov=args.no_network_cov, detection_type=args.detection_type,
        debug_gt_kp=args.debug_gt_kp, gt_cam_pose=args.gt_cam_pose,
        no_prior_det=args.no_prior_det, no_viz=args.no_viz,
        debug_saved_only=args.debug_saved_only, give_all_prior=args.give_all_prior,
        kp_config_root=args.kp_config_root, bf16=args.bf16, norm=args.norm,
        int8=args.int8, int8_scales=args.int8_scales,
        ref_manual_info=args.ref_manual_info,
        viz_cov=args.viz_cov, do_viz_extra=args.do_viz_extra,
        show_viz=args.show_viz, batched=args.batched,
        pipeline_scenes=args.pipeline_scenes, int8_online_ok=args.int8_online_ok,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
