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
calibration over the first frames.

Two throughput modes give the same results as the sequential sweep:
`--nviews 1 --batched` computes the network for a window of `--eval_window`
views (16 x 8 crops) in one call (`eval/batched.py`); `--pipeline_scenes K`
runs K scenes (`--nviews -1`) or K SfM keyframe re-solves (`--nviews N>1`)
on K worker threads, each with its own engine, and serves their frames'
network calls as one call per round (`eval/pipeline.py`). `--int8
--pipeline_scenes` needs a scales sidecar (online calibration would see
other crops than the sequential sweep) unless `--int8_online_ok` accepts
the difference.

Visualization is on unless `--no_viz`, as in the JAX CLI: the sequential
sweep writes a 3-panel PNG per frame (detections and keypoints | model
points at the estimated poses | the prior blend, when a detection has a
prior) into `<outdir>/viz_images/scene_<id>_<j:06d>.png`; `--viz_cov` adds
the covariance ellipses, `--do_viz_extra` the per-object panels of the
paper's figures into a folder per frame, and `--show_viz` a live window
(standard-library Tk; off, with a line saying so, without a display
server). The drawing is `eval/viz.py`, OpenCV's pixels without OpenCV.
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


class Evaluator:
    """The evaluation sweep: sequential, or one of the throughput modes
    (`batched`, `pipeline_scenes`). Library callers may pass a prebuilt
    `net` (a `models.pkpnet.PkpNet` with its weights, in the dtype it should
    run in) instead of a checkpoint, and a `hyp_sampler` factory for the
    engine's random draws (`slam.engine.ObjectSlam`; the pipelined sweep
    hands it to every engine it builds)."""

    def __init__(self, dataset, data_root, chkpt_path, nviews=1,
                 no_network_cov=False, detection_type="saved", debug_gt_kp=False,
                 gt_cam_pose=False, no_prior_det=False, no_viz=True,
                 debug_saved_only=False, give_all_prior=False,
                 kp_config_root=None, bf16=True, norm="batch", int8=False,
                 int8_scales=None, ref_manual_info=False, viz_cov=False,
                 do_viz_extra=False, show_viz=False, batched=False, eval_window=16,
                 pipeline_scenes=0, int8_online_ok=False, device="cuda", net=None,
                 hyp_sampler=None):
        from ._device import resolve_device
        from .data.bop import BopDataset
        from .data.mesh import load_mesh_db
        from .slam.engine import ObjectSlam, SlamConfig

        self.pipeline_scenes = 0 if debug_saved_only else int(pipeline_scenes)
        if self.pipeline_scenes > 1 and nviews == 1:
            # single-view mode has its own throughput path; ignoring (instead
            # of refusing) keeps one flag set valid for a sweep that mixes
            # --nviews 1 and -1 legs
            print("[evaluate] --pipeline_scenes has no effect with --nviews 1 (use "
                  "--batched for the single-view throughput mode); ignoring")
            self.pipeline_scenes = 0
        if self.pipeline_scenes > 1:
            if batched:
                raise SystemExit("--pipeline_scenes is exclusive with --batched")
            if not no_viz:
                raise SystemExit("--pipeline_scenes is a throughput mode; viz needs the "
                                 "sequential path (drop --pipeline_scenes or keep --no_viz)")
        self.device = resolve_device(device)
        self._hyp_sampler = hyp_sampler
        self.batched_runner = None
        self._pipe = None
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
            scales_path = self._int8_scales_path(int8, net, chkpt_path, int8_scales)
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
            if self.pipeline_scenes > 1:
                if int8 and not scales_path:
                    # online calibration sees other crops in the pipelined
                    # sweep (one frame of K scenes) than in the sequential
                    # one (one scene's first frames), so the two would give
                    # different CSVs; a persisted sidecar makes them equal
                    if not int8_online_ok:
                        raise SystemExit(
                            "--int8 --pipeline_scenes without a scales sidecar: online "
                            "calibration is mode-dependent (pipelined calibrates on a "
                            "multi-scene batch, sequential on one scene's first frames), so "
                            "results would differ from the sequential sweep. Persist a "
                            "sidecar first:\n  python -m suo_slam_tpu_torch.calibrate_int8 "
                            f"--checkpoint_path {chkpt_path} --dataset {dataset}\n"
                            "or pass --int8_online_ok to accept mode-dependent output.")
                    print("[evaluate] --int8_online_ok: pipelined online calibration "
                          "accepted — outputs may differ from the sequential sweep")
                # the engines are built per work item in _run_pipelined
                self._pipe = {"cfg": cfg, "net": None if debug_gt_kp else net, "int8": int8,
                              "scales_path": scales_path}
            elif batched:
                if nviews != 1 or debug_gt_kp or net is None:
                    raise SystemExit("--batched requires --nviews 1 with a real network "
                                     "(no --debug_gt_kp)")
                from .eval.batched import BatchedSingleViewRunner
                from .slam import kernels as slam_kernels

                batch_scales = None
                if scales_path:
                    from .models.int8_forward import load_scales

                    batch_scales = load_scales(scales_path)
                batch_fn = slam_kernels.make_batch_inference(
                    net, cfg.input_hw, device=self.device, int8=int8,
                    int8_scales=batch_scales)
                self.batched_runner = BatchedSingleViewRunner(
                    batch_fn, self._view_inputs, window=eval_window,
                    obj_slots=cfg.obj_capacity, bbox_inflate=cfg.bbox_inflate)
                self.object_slam = ObjectSlam(
                    cfg, mesh_db=self.mesh_db, infer_fn=self.batched_runner.infer_fn,
                    hyp_sampler=hyp_sampler, device=self.device)
            else:
                self.object_slam = ObjectSlam(
                    cfg, mesh_db=self.mesh_db, net=None if debug_gt_kp else net,
                    hyp_sampler=hyp_sampler, device=self.device,
                )
        self.nviews = nviews
        self.detection_type = detection_type
        self.debug_gt_kp = debug_gt_kp
        self.gt_cam_pose = gt_cam_pose
        self.no_viz = no_viz
        self.viz_cov = viz_cov
        self.do_viz_extra = do_viz_extra
        self.show_viz = show_viz
        if self.show_viz and self.no_viz:
            # the live window is part of the viz block, so --no_viz wins
            print("[evaluate] --show_viz has no effect with --no_viz "
                  "(viz composition is disabled); drop --no_viz for the "
                  "live window")
        self._window = None  # the --show_viz Tk window, opened at the first frame
        # host ms of _write_viz: drawing, PNG encoding and writing; frames
        self.viz_ms = {"draw": 0.0, "png": 0.0, "frames": 0}
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
    def _int8_scales_path(int8, net, chkpt_path, int8_scales):
        """The scales sidecar an int8 run serves with: `int8_scales`, else
        the checkpoint's own (`default_scales_path`), else None (online
        calibration, announced). SystemExit without a norm='batch' network
        (the net's own norm: a checkpoint's wins over the flag) or when an
        explicit `int8_scales` is missing."""
        if not int8:
            return None
        if net is None or net.norm != "batch":
            raise SystemExit(
                "--int8 requires a norm='batch' network (the int8 executor folds "
                "BatchNorm into its convolution epilogues); got "
                + ("no network (--debug_gt_kp)" if net is None else f"norm={net.norm!r}"))
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
        if self._pipe is not None:
            num, num_cam_poses_found = self._run_pipelined(scene_ids, csv_lines)
            scene_ids = []  # the sequential loop below is subsumed
        for i, scene_id in enumerate(scene_ids):
            view_ids = self.dataset.view_ids(scene_id)
            if self.batched_runner is not None:
                self.batched_runner.set_plan(scene_id, view_ids)
            if not self.debug_saved_only and self.nviews < 0:
                self.object_slam.reset()
            scene_results = []
            saved_views = []  # views whose saved detections are scored
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
                    if not self.no_viz:
                        self._write_viz(outdir, scene_id, j, view_id, results)

                if self.do_add and self.saved_detections is not None:
                    saved_views.append((view_id, gt_obj_ids))

            if saved_views:
                self._update_saved_det_meter(scene_id, saved_views)
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
                    hz = self._tracking_hz()
                    lines = [
                        f"NOTE: {100 * num_cam_poses_found / num:.1f}% of camera poses found!",
                        f"TIMING: Tracking {hz:.2f} Hz",
                        f"Average keypoint stdev: {self._avg_kp_std():.5f}",
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
        """Score one finished scene (one meter update over all its views'
        objects + BOP CSV lines); returns (n_views_scored, n_cam_poses_found)."""
        num = num_cam = 0
        entries = []  # (obj_id, predicted pose, gt pose) in order; None: no detection
        for view_id, pred_poses, gt_obj_ids in scene_results:
            num += 1
            if self.nviews < 0:
                if view_id not in final_results:
                    if self.do_add:
                        for obj_id in gt_obj_ids:
                            entries.append((obj_id, None, None))
                    continue
                num_cam += 1
                pred_poses = final_results[view_id]["poses"]
            for obj_id in gt_obj_ids:
                r = pred_poses.get(obj_id)
                if r is not None and r["T_OtoC"] is not None:
                    gt_pose = self.dataset.get_obj_pose(scene_id, view_id, obj_id)
                    if self.do_add:
                        entries.append((obj_id, r["T_OtoC"], gt_pose))
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
                    entries.append((obj_id, None, None))
        if entries:
            self.meter.update(*zip(*entries))
        return num, num_cam

    def _sample_sfm_views(self, view_ids, j):
        """Extra views for keyframe j's SfM re-solve. The one source of the
        `self.rng` draws: the sequential loop and the pipelined sweep's work
        items call it in the same order, so both draw the same view sets."""
        others = view_ids[:j] + view_ids[j + 1 :]
        return list(self.rng.choice(
            others, size=min(self.nviews - 1, len(others)), replace=False
        ))

    def _update_saved_det_meter(self, scene_id, views):
        """Score the saved detections of a scene's views [(view_id,
        gt_obj_ids)] with one meter update."""
        entries = []  # (obj_id, saved pose, gt pose); None: no saved detection
        sd_scene = self.saved_detections_map.get(scene_id, {})
        for view_id, gt_obj_ids in views:
            sd = sd_scene.get(view_id, {})
            for gt_obj_id in gt_obj_ids:
                if gt_obj_id in sd:
                    entries.append((gt_obj_id, self.saved_detections["poses"][sd[gt_obj_id]],
                                    self.dataset.get_obj_pose(scene_id, view_id, gt_obj_id)))
                else:
                    entries.append((gt_obj_id, None, None))
        if entries:
            self.saved_det_meter.update(*zip(*entries))

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

    _MISSING = object()

    def _feed_view(self, engine, scene_id, view_id_k, first_for_gt_cam=-1, inputs=_MISSING,
                   store_last=True):
        """Load one view's detections (or take `inputs`, the batched runner's
        entry) and feed `engine.process_view`; False when the view has no
        usable detections. The sequential sweep and the pipelined workers
        share it; the workers pass `store_last=False` (the `_last_*` viz
        state belongs to the sequential sweep)."""
        if inputs is self._MISSING:
            inputs = self._view_inputs(scene_id, view_id_k)
        if inputs is None:
            print(f"WARNING no detections for scene {scene_id} view {view_id_k}")
            return False
        obj_ids, bboxes, sample = inputs
        if store_last:
            self._last_img, self._last_K = sample["img"], sample["K"]
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
            view_id_k = int(view_id_k)
            inputs = self._MISSING
            if self.batched_runner is not None:
                # the windowed path: get() runs the network for the next
                # window on a miss and arms infer_fn for this view
                ent = self.batched_runner.get(scene_id, view_id_k)
                inputs = None if ent is None else (ent["obj_ids"], ent["bboxes"], ent["sample"])
            first = -1 if self.nviews < 0 else int(views_to_proc[0])
            self._feed_view(self.object_slam, scene_id, view_id_k, first_for_gt_cam=first,
                            inputs=inputs)
        return self.object_slam.collect_results(last_only=self.nviews < 0)

    def _write_viz(self, outdir, scene_id, j, view_id, results):
        """The 3-panel PNG of a frame (`evaluate.py:202-229` in the
        reference), the `--show_viz` window, and under `--do_viz_extra` the
        per-object panels (`lib/object_slam.py:277-308`). Host work on the
        engine's numpy mirrors, after `collect_results`."""
        from .data import png
        from .eval.viz import _bbox_ndc_to_px, make_extra_viz, make_frame_viz, render_prior_px

        t0 = time.perf_counter()
        viz_dir = os.path.join(outdir, "viz_images")
        os.makedirs(viz_dir, exist_ok=True)
        eng = self.object_slam
        view_for_viz = eng.view_ids[-1] if eng.view_ids else view_id
        dets = eng.get_view_viz_data(view_for_viz)
        if not self.viz_cov:
            # ellipses on the kp panel are opt-in (`object_slam.py:268`)
            dets = {o: {**d, "cov": None} for o, d in dets.items()}
        poses = {
            o: r["T_OtoC"]
            for o, r in results.get(view_for_viz, {}).get("poses", {}).items()
        }
        img = self._last_img
        # the full-image prior blend panel (`object_slam.py:263-266`): every
        # detection's prior keypoints rasterized into one map (each channel
        # keeps the maximum, so this equals the maximum of per-detection
        # maps that the JAX CLI forms, without a map per detection)
        centers, channels = [], []
        for d in dets.values():
            if d.get("prior_uv") is None:
                continue
            pm = d.get("model_mask")
            if pm is None:
                pm = np.ones(d["prior_uv"].shape[0], bool)
            centers.append(_bbox_ndc_to_px(d["prior_uv"][pm], d["bbox"]))
            channels.append(np.where(pm)[0])
        priors = None
        if centers:
            priors = render_prior_px(img.shape[:2], np.concatenate(centers),
                                     np.concatenate(channels))
        viz = make_frame_viz(img, dets, poses, self._last_K, mesh_db=self.mesh_db,
                             priors=priors)
        extra = None
        if self.do_viz_extra:
            extra = make_extra_viz(img, dets, poses, self._last_K, mesh_db=self.mesh_db,
                                   viz_cov=self.viz_cov)
        t1 = time.perf_counter()
        # the file holds viz's channels as they are, as cv2.imwrite(path,
        # viz[..., ::-1]) writes them
        data = png.encode(viz)
        with open(os.path.join(viz_dir, f"scene_{scene_id}_{j:06d}.png"), "wb") as f:
            f.write(data)
        if extra is not None:
            extra_dir = os.path.join(viz_dir, f"scene_{scene_id}_{j:06d}")
            os.makedirs(extra_dir, exist_ok=True)
            for name, im in extra.items():
                png.imwrite(os.path.join(extra_dir, f"{name}.png"), im[..., ::-1])
        t2 = time.perf_counter()
        self.viz_ms["draw"] += 1e3 * (t1 - t0)
        self.viz_ms["png"] += 1e3 * (t2 - t1)
        self.viz_ms["frames"] += 1
        if self.show_viz:
            self._show(data)

    def _show(self, png_bytes):
        """The live window of `--show_viz` (the reference's `cv2.imshow` +
        `waitKey(1)`): a Tk window showing the frame's PNG, updated each
        frame. Without a display server, or when Tk cannot show the frame,
        it is turned off with the JAX CLI's lines."""
        from .eval import window

        if self._window is None and not window.display_server():
            self.show_viz = False
            print("[evaluate] --show_viz: no display server; disabled")
            return
        try:
            if self._window is None:
                self._window = window.Window("ObjectSLAM")
            self._window.show(png_bytes)
            return
        except window.WindowError:
            pass
        self.show_viz = False
        self._window = None
        print("[evaluate] --show_viz: imshow failed; disabled")

    def _run_pipelined(self, scene_ids, csv_lines):
        """The pipelined sweep (`--pipeline_scenes K`): K worker threads each
        drive a fresh engine over an independent problem — a whole scene
        (`--nviews -1`) or one keyframe's N-view re-solve (SfM) — and a
        `BatchingInferServer` turns their concurrent network calls into one
        multi-frame call (`eval/pipeline.py`). A fresh engine seeds its
        sampler as the sequential sweep's engine after its reset, so both
        draw the same. Scoring runs here, on the calling thread, in scene
        and view order. Returns (views scored, camera poses found)."""
        import threading

        from .eval.pipeline import BatchingInferServer, ScenePool
        from .slam import kernels as slam_kernels
        from .slam.engine import ObjectSlam

        # work items; SfM's extra-view draws come from self.rng here, on the
        # calling thread, in the sequential sweep's order
        if self.nviews < 0:
            items = [("scene", scene_id, None) for scene_id in scene_ids]
        else:
            items = []
            for scene_id in scene_ids:
                view_ids = self.dataset.view_ids(scene_id)
                for j, view_id in enumerate(view_ids):
                    views = [int(view_id)] + [int(v) for v in self._sample_sfm_views(view_ids, j)]
                    items.append(("kf", scene_id, (int(view_id), views)))

        pipe = self._pipe
        K = min(self.pipeline_scenes, len(items))
        server = None
        if pipe["net"] is not None:
            scales = None
            if pipe["scales_path"]:
                from .models.int8_forward import load_scales

                scales = load_scales(pipe["scales_path"])
            multi_fn = slam_kernels.make_multi_frame_inference(
                pipe["net"], pipe["cfg"].input_hw, device=self.device, int8=pipe["int8"],
                int8_scales=scales)
            server = BatchingInferServer(multi_fn, K)
        kind = "scenes" if self.nviews < 0 else "SfM keyframes"
        print(f"Pipelining {len(items)} {kind} over {K} workers"
              + (" (batched network calls)" if server else ""))
        warmed = threading.Event()

        def run_item(cid, item):
            _, scene_id, payload = item
            eng = ObjectSlam(pipe["cfg"], mesh_db=self.mesh_db,
                             infer_fn=None if server is None else server.client(cid),
                             hyp_sampler=self._hyp_sampler, device=self.device)
            # the sequential sweep's timing warm-up leaves out the run's first
            # 6 views (one long-lived engine); a fresh engine per item would
            # leave out 6 views of every item, so every engine after the
            # first starts warm
            if warmed.is_set():
                eng.all_time_num_views = 6
            else:
                warmed.set()
            stats = lambda: {"track_times": list(eng.track_times), "std_sum": eng.avg_std_sum,
                             "std_n": eng.avg_std_n}
            if self.nviews < 0:
                scene_results = []
                for view_id in self.dataset.view_ids(scene_id):
                    view_id = int(view_id)
                    gt_obj_ids = self.dataset.obj_ids(scene_id, view_id)
                    self._feed_view(eng, scene_id, view_id, store_last=False)
                    if len(eng.collect_results(last_only=True)) == 0:
                        continue
                    scene_results.append((view_id, None, gt_obj_ids))
                return {"scene_results": scene_results,
                        "final": eng.collect_results(final=True), **stats()}
            # an SfM keyframe: a fresh engine is the sequential sweep's reset
            view_id, views = payload
            for v in views:
                self._feed_view(eng, scene_id, v, first_for_gt_cam=views[0], store_last=False)
            results = eng.collect_results(last_only=False)
            if len(results) == 0:
                return {"kf": None, **stats()}
            return {"kf": (view_id, results[view_id]["poses"],
                           self.dataset.obj_ids(scene_id, view_id)), **stats()}

        # results are keyed by (kind, scene, keyframe): the SfM payload holds
        # a list, which cannot key a dict
        keyed = [(it[0], it[1], it[2] if it[0] == "scene" else it[2][0]) for it in items]
        by_key = dict(zip(keyed, items))
        results = ScenePool(server, K).run(keyed, lambda cid, key: run_item(cid, by_key[key]))

        num = num_cam = 0
        self._pipe_stats = {"track_times": [], "std_sum": 0.0, "std_n": 0}

        def absorb(r):
            self._pipe_stats["track_times"].extend(r["track_times"])
            self._pipe_stats["std_sum"] += r["std_sum"]
            self._pipe_stats["std_n"] += r["std_n"]

        do_saved = self.do_add and self.saved_detections is not None
        for scene_id in scene_ids:
            if self.nviews < 0:
                r = results.get(("scene", scene_id, None))
                if r is None:
                    continue
                absorb(r)
                scene_results, final = r["scene_results"], r["final"]
            else:
                scene_results, final = [], None
                for view_id in self.dataset.view_ids(scene_id):
                    r = results.get(("kf", scene_id, int(view_id)))
                    if r is None:
                        continue
                    absorb(r)
                    if r["kf"] is not None:
                        scene_results.append(r["kf"])
            if do_saved:
                # the sequential loop reaches the saved-detection update only
                # for views whose results were not empty: these
                self._update_saved_det_meter(
                    scene_id, [(view_id, gt_obj_ids) for view_id, _, gt_obj_ids in scene_results])
            n, nc = self._score_scene(scene_id, scene_results, final, csv_lines)
            num += n
            num_cam += nc
        return num, num_cam

    def _tracking_hz(self):
        if self.object_slam is not None:
            return self.object_slam.tracking_hz()
        # the pipelined frames' times include the waits at the server's
        # barrier; "Eval took" is the sweep's throughput
        tt = self._pipe_stats["track_times"]
        return 0.0 if not tt else 1.0 / (sum(tt) / len(tt))

    def _avg_kp_std(self):
        if self.object_slam is not None:
            return self.object_slam.avg_kp_std()
        s, n = self._pipe_stats["std_sum"], self._pipe_stats["std_n"]
        return 0.0 if n == 0 else s / n


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
        show_viz=args.show_viz, batched=args.batched, eval_window=args.eval_window,
        pipeline_scenes=args.pipeline_scenes, int8_online_ok=args.int8_online_ok,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
