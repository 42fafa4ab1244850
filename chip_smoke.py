"""Chip smoke test of the PyTorch/CUDA port: the single-view frame, SLAM
mode, the evaluation entry point, int8 serving, training, the quantized
and GroupNorm networks, the throughput evaluation modes, data-parallel
training and the compat shims of SUO-SLAM on one NVIDIA GPU, through the
entry points a user calls.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: nvidia-smi name and power limit, torch / CUDA versions, the f32
     precision flags;
  2. build: every `suo_slam_tpu_torch/csrc/*.cu` with nvcc (one process per
     source, in parallel) and the seconds it took; the count of IGMMA (s8
     `wgmma`) instructions in K11's SASS, where the toolkit has cuobjdump;
  3. kernels: K1-K10, K14 and K15 against their plain PyTorch versions on the
     same CUDA inputs at the main paths' shapes, with the stated tolerances
     (K14, the whole LM schedule of `ba.optimize` in one launch, in both
     designs — the cluster design, the main path's: the global BA on a
     thread-block cluster, the tracking BA on one CTA; and the earlier
     one-block design: one iteration against one eager iteration with K4 +
     K7, which stay off the main path, then `compare_ba` on the tracking
     (V = 1), single-view (V = 16) and global V = 32 / O = 8, V = 64 / O = 8
     and V = 128 / O = 16 problems, each design's device time per call and
     per iteration and SM cycles by phase, the cluster design repeating bit
     for bit, one kernel node per `optimize` and a captured call replaying
     equal; K15, the whole of `pnp_ransac_batch` in one launch: its
     outcome at the front end's shapes and the backup pose's, its draws mode
     (the main path's: it ranks the sampler's `torch.rand` itself) bit-equal
     to K15 on K22's indices of the same draws at both shapes, both modes'
     device times, and its time against the K3 + eager-tail schedule it
     replaced, K3 now off the main path too; K6's three modes exact against
     their plain versions: the bare counts, the fused camera RANSAC (six
     cases: pose bits, count, ok, best slot) and the fused re-init vote,
     each beside the chain of the earlier front end it replaced); kernel,
     plain and library times (median of CUDA-event timings; the library
     yardsticks' device time from torch.profiler beside them) and each
     kernel's bound on an H100 (bytes at 3.35 TB/s or f32 operations at
     67 TFLOP/s, counted from this run's inputs); K8 and K9's launches per
     forward of the full-width net; K1's device time on each of its paths
     (generic, the earlier kernel, and strip: bit-equal), its call in turns with
     `grid_sample`'s and its wrapper's host time step by step (`[host] K1
     wrapper`, beside the bare ctypes call); K15's SM cycles by phase for
     the current and the serial design at the front end's and the backup
     pose's shapes (and the draws mode's, with its rank phase), both
     designs' device times; ptxas's registers and stack
     frame of K1's, K3's and K15's kernels; K22 (the PnP sampler's top-4)
     equal to its plain version on the same CUDA draws at the front end's
     [8, 64, 41] (a row with 2 valid points) and the backup pose's
     [1, 128, 328], beside `torch.topk` on the masked draws and the index
     sampler's whole call (`torch.rand` + K22; K22 is off the main path);
     K8's wrapper call at a
     SLAM-frame shape (`[host] K8 wrapper`); K2 on both paths (dense: a
     thread-block cluster per crop, the main path's; strided: the earlier
     design) on the net's f32 logits in both transpose_heatmaps orders and
     on 128 crops of bf16 logits, with device times, kernels per call and
     batch invariance (a crop's outputs in a 128-crop call equal its
     single-crop call's bits); K10 on both designs (one launch over the
     resident point table; the earlier two kernels) at B = 1, 8 and 96 (one
     scored scene of phase 7), per-point equal to its plain version and a
     pose's results equal across B; each beside the earlier
     designs' times (`EARLIER_US`); K5 at the SLAM path's symmetric group
     ([4, 64, 64, 41]) in f32 (equal to its plain version) and bf16 (equal
     to the plain f32 map rounded once), device us beside the bytes bound,
     and one with-prior frame call of the bf16 net that renders its prior in
     bf16 (one K5 launch, the bits of an f32 render the net casts, no copy
     or cast that reads the prior map or its mask, its kernels and copy
     kernels by torch.profiler); then the full-width net in bf16 against
     the same net in f32 on the card (uv within the bf16 error the CPU shows
     for the same crops), both nets' ms per call on the host clock (with K8 /
     K9 and with their plain versions) and their device ms per call;
  4. the single-view path: full-width PkpNet (2 stacks x 2 modules x 256
     features, 256x256 crops, seeded random weights, non-trivial BatchNorm
     statistics) in `ObjectSlam(single_view_mode=True)` over synthetic
     480x640 views with 8 objects each, `reset()` before every view as
     `evaluate.py --nviews 1` does: per-view latency and per-stage times;
     the launch counters of K1, K2, K14 and K15 must rise (K15 exactly once
     per view: one per `pnp_ransac_batch` call, which ranks the sampler's
     draws, and no plain sampler on the card), K3's, K4's, K7's and K22's
     stay 0; the stage times split the front end into its sampler (one
     `torch.rand`), `pnp_ransac_batch` and the rest, and time the SLAM
     front end's camera RANSAC and the tail's re-init vote (one K6 launch
     each) alone;
     the prior-free network path is
     held against the same net on the CPU for two crops; one more view runs
     under torch.profiler;
  5. solver check: the same engine with an injected ground-truth inference
     (projected keypoints + N(0, 0.005) NDC noise, cov sigma^2 I, validity
     1): ADD < 0.1 diameter for >= 90% of the objects;
  6. the SLAM path: `ObjectSlam(SlamConfig())` in SLAM mode over 22 frames
     of a smooth camera trajectory around the same 8 objects fixed in the
     world, 3 of them symmetric (prior feedback). The full-width net runs on
     every call through `make_frame_inference` — so the symmetric group
     renders its map priors with K5 — and a wrapper then replaces the net's
     uv / cov / validity with the group's projected ground truth plus
     N(0, 0.005) NDC noise: random weights would leave every object
     uninitialised, while these keypoints make PnP, camera RANSAC, late
     init, the priors, re-init and both BAs do real work, as trained
     weights would. The view capacity grows 16 -> 32, global BA runs at
     frames 10 and 20 and in `collect_results(final=True)`. Every counter
     K1, K2, K5, K6, K14 and K15 must rise and K3's, K4's, K7's and K22's
     stay 0 (K14: one launch per tracking BA and per global BA; K15: one per
     `pnp_ransac_batch` call, two front ends a frame and the backup camera
     poses; K6: one per camera RANSAC and per re-init vote); every frame's
     two dispatch chains (`frontend_step`, `tracking_tail`) run under
     `torch.cuda.set_sync_debug_mode("error")`; the camera trajectory error
     and ADD < 0.1 d for >= 90% of the (frame, object) poses; the
     with-prior program against the CPU for two crops (1e-3); the global
     (V = 32) and tracking BA problems through both designs of K14, the
     eager schedule with K4 + K7 and with the plain versions, and f64 on the
     CPU (`compare_ba`).
     Prints per-frame latency, tracking (K14 and the eager K4 + K7
     schedule) and global BA ms, launches per frame, and a torch.profiler
     summary of one frame with its launches (K14 1, K15 one per
     `pnp_ransac_batch` call, K6 one per camera RANSAC and re-init vote,
     K3, K4, K7 and K22 0, no cholesky), its kernel
     count and device ms beside those before K15, K1's and K15's device time
     per launch beside the earlier designs', and the sum of its K8 / K9
     calls' bounds;
  7. the evaluation entry point: a BOP tree written here (one scene of 12
     480x640 views with the YCB-V intrinsics, 8 objects with keypoint
     configs and 6000-point PLY models, PNGs from this script's own writer)
     read by the port's loader and scored by its meter (K10):
     `Evaluator(nviews=-1, debug_gt_kp=True)` must reach AUC of ADD(-S) > 80
     and 100% of camera poses; `Evaluator(nviews=1)` with the full-width
     bf16 net (seeded random weights, passed as `net=`) must run to its end
     and write summary.txt and the BOP CSV. Per-view latency and the K8-K10
     counts of the phase; each leg launches K10 once (one meter call per
     scored scene). Then the visualization leg: `Evaluator(nviews=-1)` with
     the full-width bf16 net (its calls guided to the ground truth by
     `GtGuided`, so objects initialise and priors appear), viz on with
     `viz_cov`, `do_viz_extra` and `show_viz`: one PNG per view, (480, 1920,
     3) where the view has a prior and (480, 1280, 3) otherwise, each
     object's input / output (/ overlay where posed) panels, the last view's
     frame equal to `eval.viz.make_frame_viz` redrawn from the engine's
     `get_view_viz_data`, the no-display line printed once; the same leg
     with `no_viz=True` in turns (median view ms of each) and `_write_viz`'s
     host ms per frame, drawing apart from PNG encoding and writing;
  8. int8 serving: the full-width net's s8-resident program
     (`models/int8_forward.py`) calibrated on the card; K11 (every distinct
     convolution shape of the forward, with its real codes and its route —
     wgmma for every stride-1 convolution —, plus the concat stem's 7x7
     stride-2 prior convolution on the mma.sync route), K12 (each mode:
     input dtype or prologue — its pool mode, the max-pool fused with the
     nrq after it, and its junction mode, the second operand read at half
     resolution, included —, outputs, padded rows) and K13 (each level, off
     the path since K12's two modes took its work: each mode's call
     bit-equal to the K13 -> K12 chain it replaced, both calls' device us
     in turns and bytes bounds) bit-equal to their plain versions on the
     same CUDA inputs, with
     kernel, device, plain, `torch._int_mm` (cuBLASLt s8 GEMM; an im2col of
     the 3x3 input; wrapper and device) times and bounds (int8 operations at
     1,979 TOP/s or bytes at 3.35 TB/s); K2 on the bf16 logits against its
     plain version; launches per forward (K13 none); the whole int8 net
     against its
     plain-version run on the card (equal logits) and against the f32 net
     (uv gap within 1.5x the CPU's on the same two crops); the int8 and
     bf16 nets' host and device ms per call and crops/s; the same at 128
     crops (the JAX bench's batch: launches per prior-free forward, K11 and
     K12 bit-equal and timed at every distinct call, device ms per call,
     crops/s and kernels of the int8 and bf16 nets; `--int8-only` runs the
     128-crop int8 forward alone, to compare two checkouts in turns); a
     scales sidecar written by
     `calibrate_int8` over the phase-7 BOP tree, then `Evaluator(nviews=1,
     int8=True)` to its end; a 6-frame SLAM run with
     `SlamConfig(int8_inference=True, int8_calib_frames=2)` under phase 6's
     ground-truth wrapper (the with-prior int8 program and K5);
  9. training: a `train_real` split (40 480x640 PNG views of 5-8 of the
     eight objects, YCB-V's every-5th cut keeps 8) beside phase 7's test
     split; K16-K19 against their plain versions at the train step's
     full-width shapes (32 rows, 8 padded; f32 and bf16; K19 on both paths,
     dense — a cluster per crop, the main path's — and strided, the earlier
     design, L2-cold in turns, both orders, batch-invariant, one kernel a
     call, a captured call replaying equal) with kernel,
     device, plain and library times (F.batch_norm + relu forward and
     backward; avg_pool2d; autograd of softmax + einsum), L2-cold device
     times (`cuda_ms_cold`) and bytes bounds; K18 on both routes (vector,
     scalar), the calls counted, L2-cold at the four junctions beside their
     bounds; K16 / K17 in both designs
     (fused, the main path: one cooperative launch a call; split, the
     first design): equal to their plain versions, the fused K16's affine
     and running averages and K17's scale gradient bit-equal to the eager
     ops they replace, repeated calls bit-equal, kernels a call by a
     captured graph's nodes, L2-cold times in turns at [32, 256, 64, 64],
     SM cycles by phase (`bn_clocks`), and both designs at every norm
     shape of the step (`bn_step_shapes`); one full-width train step (2
     frames x 16 slots) with the kernels
     against the same step on the plain versions, f32 and bf16 (loss and
     terms, every gradient, the new statistics; gated by the step's own
     sensitivity to 1e-6 input noise); the bf16 step's host and device ms,
     kernels, K16 / K17's, K18's (and K18's under its other loads, beside
     the sum of its bounds) and K19's device ms (K19's route: dense), busy
     share, peak memory and launches per step (K16 / K17 / K8 180, K9 / K18
     8, K1 / K2 / K5 / K19 1;
     `--step-only` runs this alone, to compare two checkouts in turns); 30
     steps overfitting one batch
     (the loss falls); `python -m suo_slam_tpu_torch.train` in process, full
     width and bf16, 2 epochs x 4 steps + 2 validation batches, its exact
     launches (each epoch's two prediction dumps add a crop and a
     prior-free forward: K1, K8, K9, K2), no plain version on a CUDA tensor,
     its checkpoints, and a second run that auto-resumes at epoch 2; the
     dumps `viz_{train,test}_epoch_{0,1,2}/sample.png` (480 x 1280) and
     `viz_best` (one epoch's test dump); the trained checkpoint through
     `Evaluator(nviews=1)` and `python -m suo_slam_tpu_torch.plot_cov` (both
     files, K1 and K2 launched); the YCB-V paper sweep
     (`suo_slam_tpu_torch/scripts/eval_all_ycbv.sh`, a subprocess, its 5
     runs with viz on) on phase 7's tree with the trained `model_best`:
     table.txt's 5 blocks and its seconds; the -u step (no covariance head: L2 + the
     readout's spread) with the kernels against its plain run under
     `STEP_GATES` in f32 and bf16, and the bf16 -u step beside the
     covariance step (host / device ms, kernels, K2 and K19 once a step, no
     softmax kernel: no probability map); the training loader alone over
     the split, augmented: host ms a batch in line, with 4 threads and with
     4 processes (the modes' first batches bit-equal), the CPU count; the
     CLI with augmentations on, run 1 `-u --loader process --workers 4` (1
     epoch x 4 steps + 2 validation batches; its checkpoint through
     `Evaluator(nviews=1, no_network_cov=True)`), run 2 `--use_cache`
     (thread mode, 1 epoch x 4 steps), each with its epoch s and sec/it,
     exact launches and no plain version on a CUDA tensor (the kernels line
     gives run 1's K2 / K19 launches as `launches_u_run`); then the JPEG
     splits (`phase_train_jpeg`): `train_synt` (16 480x640 PNG views, depth 0
     off the objects) and `train_pbr` (the same frames as JPEG q95 4:2:0 from
     `data/jpeg.py`'s encoder) and a VOC directory of 8 JPEGs (500x375 and
     375x500, one gray, one with a restart interval); the host ms (one
     thread, median of 20) of the decoder on a pbr frame, `png.imread` on a
     `train_real` frame and `resize_linear` 500x375 -> 480x640; the decoder's
     SHA-256 digests on `jpeg.check_images()` equal to the CPU tests' pins
     (`cv2.imread`'s bits); the loader over `train_synt` (composited) and
     `train_pbr` in line, with 4 threads and 4 processes (first batches
     bit-equal); the CLI on `--data_split real+synt` with the VOC directory
     and on `--data_split pbr --use_cache`, each 1 epoch x 4 steps + 2
     validation batches with its epoch s, sec/it, exact launches and no
     plain version on a CUDA tensor;
 10. the quantized and the GroupNorm nets at full width (2 x 2 x 256, 256x256
     crops, seeded weights): `PkpNet(quant="int8")` in f32 and bf16 from the
     float net's weights, calibrated by `quant.calibrate` on 4 batches of 8
     crops; launches per prior-free forward (one K11 and one K12 per
     QuantConv, cuDNN only for the 2 f32 heads, K8 180, K9 8); K11's f32
     epilogue and K12's f32 mode bit-equal to their plain versions at every
     distinct call of both forwards, timed beside `torch._int_mm`; the int8
     net equal to its plain-version run on the card and its logits' relative
     RMS and max uv gap to the f32 `quant="off"` net beside the CPU's on the
     same crops; host and device ms per call of the int8 and float nets at 8
     crops (turns), device ms at 128 crops. Then K20 / K21 in both designs
     (cluster, the main path: one launch a call; split, the first design)
     against their plain versions and against F.group_norm + relu and its
     autograd (the library yardstick) at 8 x 256 x 64 x 64, 16 x 128 x 128 x
     128 and 32 x 256 x 64 x 64, f32 and bf16, the cluster design bit-equal
     across repeated calls and one kernel a call (a captured graph's nodes),
     L2-cold times in turns, device times and bytes bounds; both designs at
     every norm shape of the group train step with SM cycles by phase at
     three (`gn_step_shapes`, `gn_clocks`); `Evaluator(nviews=1)` with
     a full-width bf16 `norm="group"` net on phase 7's tree; 3 SLAM frames
     under phase 6's ground-truth wrapper; one full-width group train step
     with K20 / K21 against its plain run under `STEP_GATES`; the bf16 group
     step's host and device ms, kernels, K20 / K21's device ms, launches
     per step and the layout of the dy K21 receives (`--step-only --norm
     group` runs this alone); `python -m
     suo_slam_tpu_torch.train --norm group` in process, 1 epoch x 4 steps + 2
     validation batches at phase 9's defaults, its exact launches (the two
     prediction dumps' forwards included) and no plain
     version on a CUDA tensor; its checkpoint through `Evaluator(nviews=1)`;
 11. throughput evaluation: a BOP tree of 4 scenes x 16 views x 8 objects
     (480x640, the full-width net), every network call wrapped by
     `GtGuided` (ground-truth keypoints + 0.02 x the net's uv: the net runs
     and moves the poses, PnP succeeds); the 128-crop batched call (16 views
     x 8 objects) against the per-frame call on each view's crops (int8: equal
     uv on every crop; bf16 within the bf16 net's gap to f32 on the same
     crops), its ms and crops/s in bf16, int8 and f32; then `Evaluator`
     legs, each with its launches, ms per view and multi-frame call shapes,
     every sampler's draws ranked in K15 (no K22) and one K10 launch per
     scene: `--nviews
     1` sequential and `--batched`
     (4 calls of 128 crops) in bf16 (AUC within 1 point, the same CSV rows)
     and int8 on phase 8's sidecar (CSV equal byte for byte); `--nviews -1`
     sequential and `--pipeline_scenes 4` (rounds of 4 x 8 crops, with
     priors and K5) in int8 (CSV equal) and bf16 (AUC of ADD(-S) > 80 and
     100% camera poses, all four SLAM legs); SfM `--nviews 2` sequential and
     `--pipeline_scenes 3` in int8 (CSV equal);
 12. data parallelism: K16 / K17's cross-rank modes (K16 partial sums and
     finalize, K17 sums and dx; `check_k16_k17_cross`) through a gloo group
     of one rank at phase 9's five norm shapes, f32 and bf16: the partial
     and backward sums against their plain versions (1e-12 relative), the
     finalize exact, dx within 1e-5 (f32) / 2^-8 (bf16) of its max, one
     rank's result bit-equal to the fused kernels, one kernel a call, warm
     and L2-cold device us at [32, 256, 64, 64] beside the plain versions
     and bytes bounds; an all-reduce of one norm's [513] f64 sums over gloo
     and NCCL (host and device ms); then `make_sharded_train_step` in two
     processes spawned on this one card (gloo: NCCL refuses one card twice),
     the full-width net (2 x 2 x 256, 256x256 crops) in f32 and bf16 on a
     global batch of 4 frames x 8 object slots from phase 9's split, one SGD
     step (lr 1e-2) held against one process on the joined batch, cuDNN
     pinned on both sides (`DP_GATES`: f32 loss rtol 5e-4, parameters atol
     3e-4 — JAX's own — and the running averages 1e-6 relative; bf16 loss
     2e-3, parameters 3e-3, running averages 1e-2 and an update cosine of
     0.9, about twice the worst of three seeds), where the runs part (every
     convolution and norm traced by row digests: the calls whose output
     differs on equal inputs), the ranks equal to each other, each rank's
     launches (180 of each cross-rank mode, no fused K16 / K17) and
     all-reduces (363), the step's host ms on each rank with its
     collectives' host ms beside the one-process step's; sharded inference
     of the f32 net (2 ranks x 4 crops) against the local forward (1e-3);
     `python -m torch.distributed.run --nproc_per_node 1 -m
     suo_slam_tpu_torch.train` (NCCL) beside the plain start, one step
     each: the running averages within 1e-6 relative;
 13. the compat shims on the card: `compat.g2o` on a 2-camera x 2-object
     graph (`ba.lm_run`: K4 + K7 each iteration, no K14) and
     `compat.lambdatwist.pnp` (one K15 launch) against their CPU runs
     (1e-4);
 14. the labeling and symmetry-choice tools (host numpy, no device work, as
     in the JAX package) on phase 7's BOP tree written anew with 2 views,
     object 1 made a generated closed mesh of 32,768 triangles (T-LESS CAD
     scale) with 16 symmetry candidates: `render_shaded` at 240x320 and
     480x640; a scripted session of `manual_keypoints.LabelSession` over
     `tools.labeling.KeypointLabeler` (8 views at 240x320; clicks on every
     view, an inspection refused while a keypoint is short of samples, one
     accepted after a view-pose adjustment, a save into the tree's kp_info);
     `manual_keypoints --viz` over the tree; `view_sym_choice` of object 1
     (480x640, 16 candidates); their host ms and wall times beside the
     nvidia-smi line; the whole pass twice, every output (the saved JSON and
     the PNGs, by sha256) and the printed choice equal in both.
     `--tools-only` runs this phase alone;
 15. the kernels JSON line (K1-K3's, K5-K6's, K14's, K15's and K22's launches
     from the SLAM path, K22's 0 there, K4 and K7's from phase 13's compat
     path, K8-K10's from the evaluation phase, K11-K13's (K13's 0)
     and K12's pool and junction modes' from the int8 phase's evaluation and
     SLAM runs, K16-K19's from the training CLI, K16 / K17's cross-rank
     modes' from rank 0 of phase 12's bf16 sharded step, K11 /
     K12's f32 modes from phase 10's 8-crop f32 forward, K20 / K21's from its
     training CLI), the nvidia-smi line, and the last line {"ok": true,
     "device": {...}}. `--parallel-only` builds, writes phase 7's and 9's
     trees and runs phases 12 and 13 alone.

The script imports nothing of JAX or of the JAX package; its scenes are made
with numpy from --seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core operations (data sheet)
H_IMG, W_IMG = 480, 640
YCBV_K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109], [0.0, 0.0, 1.0]])
N_OBJ = 8
NK = 41
# the previous designs of K1, K15, K2 and K10 on an H100 80GB HBM3 at 700 W
# (chip_smoke's run before their redesign; K1's earlier kernel is the generic
# path, K15's the serial design, K2's the strided path, K10's the two-pass
# design, all still measured here): K1's call and its device time per launch
# in the profiled SLAM frame; K15's device time at phase 3's shape and per
# launch in the frame; K2's device time at 8 x 64 x 64 x 41 (f32 logits of
# the net, bf16 of the int8 net); K10's per call at P = 4096; the targets
# beside them
EARLIER_US = {"K1 call": 30.70, "K1 frame": 6.464, "K15 phase 3": 54.167, "K15 frame": 67.402,
              "K2 f32": 18.512, "K2 bf16": 16.970, "K10 B=1": 22.103, "K10 B=8": 59.225}
TARGET_US = {"K1 device": 5.18, "K15 phase 3": 35.0, "K15 frame": 40.0,
             "K2 f32": 6.0, "K2 bf16": 4.0, "K10 B=1": 8.0, "K10 B=8": 35.0,
             "K6 camera": 6.0, "K6 reinit": 6.0, "K15 draws over idx": 3.5}
SINGLE_VIEW_KERNELS = ("roi_crop", "heatmap_readout", "pnp_ransac", "ba_lm")
# K3, K4, K7, K22: checked in phase 3, off the main path (K15 and K14 replaced
# them; K15 ranks the sampler's draws itself)
OFF_PATH_KERNELS = ("pnp_hypotheses", "ba_edges", "ba_schur", "pnp_sample",
                    "int8_pool_junction")  # and K13: K12's pool and junction modes took it
EVAL_KERNELS = ("norm_relu", "upsample_add", "add_dists")  # launches from the evaluation phase
# from the int8 phase: K11, K12 and (of K12's launches) its pool and junction modes
INT8_KERNELS = ("int8_conv", "int8_quant", "int8_quant_pool", "int8_quant_junction")
# an int8 forward's kernels by name (K13's too, for a parent checkout's runs)
INT8_KERNEL_NAMES = ("int8_conv", "int8_quant", "int8_pool_junction")
TRAIN_KERNELS = ("bn_stats", "norm_relu_bwd", "upsample_add_bwd",  # from the training phase
                 "heatmap_readout_bwd")
QUANT_KERNELS = ("int8_conv_f32", "int8_quant_f32")  # K11 / K12's f32 modes (phase 10)
GROUP_KERNELS = ("group_norm_relu", "group_norm_relu_bwd")  # K20 / K21 (phase 10's CLI)
# counters whose launches run kernels not named <counter>_kernel (K6's fused modes)
KERNEL_KEYS = {"chi2_counts": ("chi2_counts_kernel", "camera_ransac_kernel",
                               "reinit_votes_kernel")}


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


_L2_FLUSH = {}
SPIN_CYCLES = 600_000  # ~0.3 ms of `torch.cuda._sleep` at the H100's SM clock


def cuda_ms_cold(fn, n=15, warmup=2):
    """Device milliseconds of one call of `fn` that finds its inputs in
    device memory, not in the 50 MB L2 (as a train step's backward finds the
    activations its forward saved): before each call a read of 128 MB
    leaves the L2 holding only clean lines of its own, then a spin kernel
    (`torch.cuda._sleep`) keeps the device busy while the host enqueues the
    call, so the CUDA events around it time the device alone; the median
    of n."""
    import torch

    buf = _L2_FLUSH.get("buf")
    if buf is None:
        buf = _L2_FLUSH["buf"] = torch.zeros(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        buf.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def launch_us(n=200):
    """The device microseconds one more launch costs on a stream: a CUDA
    graph of n empty kernels (`torch.cuda._sleep(0)`) replayed between CUDA
    events, per kernel — the host's enqueue out of the loop."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(n):
            torch.cuda._sleep(0)
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    e.synchronize()
    g.reset()
    return 1e3 * s.elapsed_time(e) / n


def bound(nbytes: float, flops: float, ops_per_s: float = F32_FLOP_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / ops_per_s * 1e3
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
    points in a 100 mm cube; objects 1, 4 and 7 are symmetric (the SLAM
    path's prior feedback; single-view mode ignores symmetry)."""

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
        self.is_symmetric[[0, 3, 6]] = True


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


def full_width_net(seed, dtype=None, norm="batch", quant="off"):
    """PkpNet at full width with seeded random weights and non-trivial
    BatchNorm running statistics (GroupNorm: scales and biases), in f32
    (default) or `dtype`; `quant` its convolutions' kind."""
    import torch

    from suo_slam_tpu_torch.models.hourglass import GroupNormRelu, MaskedBatchNorm
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    torch.manual_seed(seed)
    net = PkpNet(n_stack=2, n_modules=2, features=256, prior_mode="post_stem",
                 dtype=dtype or torch.float32, norm=norm, quant=quant)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.mean.numel()
                m.mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.var.copy_(torch.rand(c, generator=g) + 0.5)
            if isinstance(m, (MaskedBatchNorm, GroupNormRelu)):
                c = m.scale.numel()
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
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {stem}: {line.strip()}")
    # K11's s8 wgmma in the SASS (IGMMA), where the toolkit has cuobjdump
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    lib = _build.BUILD_DIR / "libint8_conv.so"
    if os.path.isfile(tool):
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
        n = sum("IGMMA" in line for line in r.stdout.splitlines())
        log(f"[build] {lib.name}: {n} IGMMA instructions in its SASS (cuobjdump -sass)")
    else:
        log(f"[build] {lib.name}: cuobjdump is missing; its SASS was not read")
    return secs


def ptxas_kernels(stem, names):
    """`-Xptxas -v`'s lines for each kernel of csrc/<stem>.cu among `names`
    (registers, stack frame, spills), from the build's log."""
    from suo_slam_tpu_torch.kernels import _build

    out, cur = {}, None
    for line in _build.build_log.get(stem, "").splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = next((n for n in sorted(names, key=len, reverse=True) if n in line), None)
        elif cur and ("stack frame" in line or "registers" in line):
            out.setdefault(cur, []).append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in out.items()}


def _report(name, err, tol, ms, plain_ms, lib_ms, b, lib_fn=None):
    """One kernel line; with `lib_fn`, the library yardstick's device time
    too (`lib_device_us`: its wrapper-free time beside `lib_ms`)."""
    tol = tol if isinstance(tol, str) else f"{tol:.1e}"
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    if lib_fn is not None:
        us, src = lib_device_us(lib_fn)
        lib += f" (device {us:.3f} us by {src})"
    log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms"
        f" | plain {plain_ms:.4f} ms | library {lib} | bound {b[0]:.5f} ms ({b[1]})")


def host_ns(fns, n=1000, reps=5):
    """Host nanoseconds per call of each function in the dict `fns`, on the
    host clock (`perf_counter_ns`), no sync inside a loop: n calls of each
    in `reps` runs of n / reps back-to-back calls, the functions in turns
    (so a drift of the shared host's load spreads over all of them), the
    median run of each."""
    import torch

    for f in fns.values():
        f()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    for _ in range(reps):
        for k, f in fns.items():
            t0 = time.perf_counter_ns()
            for _ in range(n // reps):
                f()
            runs[k].append((time.perf_counter_ns() - t0) / (n // reps))
            torch.cuda.synchronize()
    return {k: round(statistics.median(v)) for k, v in runs.items()}


def k1_wrapper_breakdown(imgs, boxes, mask, out_hw=(256, 256)):
    """K1's wrapper step by step: host ns per call of each step over 1,000
    calls (`host_ns`). The steps of the earlier wrapper (a uint8 copy of the
    mask, `torch.empty`, `c_void_p` objects, a `current_stream()` object per
    call) beside the current one's, the whole current wrapper, and the bare
    ctypes call with its pointers, sizes and stream prepared once: the
    floor a Python wrapper over ctypes cannot go below. Returns the dict."""
    import ctypes

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.kernels import _build
    from suo_slam_tpu_torch.ops import roi

    dev = imgs.device
    B, H, W, C = imgs.shape
    O = boxes.shape[1]
    oh, ow = out_hw
    f32 = torch.float32
    out = torch.empty((B, O, oh, ow, C), dtype=f32, device=dev)
    fn = _build.entry("roi_crop", roi._ARGTYPES)
    plan = roi.plan_crop(B * O, oh, ow, C)
    args = (imgs.data_ptr(), boxes.data_ptr(), mask.data_ptr(), out.data_ptr(), B, O, H, W, C,
            oh, ow, plan.path, _build.stream(imgs.get_device()))
    earlier = {
        "checks (device objects)": lambda: (
            imgs.dtype != f32 or imgs.dim() != 4,
            boxes.shape != (B, boxes.shape[1], 4) or mask.shape != boxes.shape[:2],
            boxes.device != dev or mask.device != dev),
        "images.contiguous()": lambda: imgs.contiguous(),
        "boxes.to(f32).contiguous()": lambda: boxes.to(f32).contiguous(),
        "mask.to(uint8): a copy launch": lambda: mask.to(torch.uint8).contiguous(),
        "torch.empty(dtype, device)": lambda: torch.empty((B, O, oh, ow, C), dtype=f32, device=dev),
        "4 x c_void_p(data_ptr())": lambda: [ctypes.c_void_p(t.data_ptr())
                                             for t in (imgs, boxes, mask, out)],
        "c_void_p(current_stream().cuda_stream)": lambda: ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream),
    }
    current = {
        "checks (get_device)": lambda: (
            imgs.dtype != f32 or imgs.dim() != 4, boxes.shape != (B, O, 4),
            mask.shape != (B, O), imgs.get_device() != boxes.get_device()),
        "is_contiguous / dtype tests": lambda: (
            imgs.is_contiguous(), boxes.dtype == f32 and boxes.is_contiguous(),
            mask.dtype == torch.bool and mask.is_contiguous()),
        "new_empty": lambda: imgs.new_empty((B, O, oh, ow, C)),
        "4 x data_ptr()": lambda: [t.data_ptr() for t in (imgs, boxes, mask, out)],
        "raw stream (_build.stream)": lambda: _build.stream(imgs.get_device()),
        "plan_crop (cached)": lambda: roi.plan_crop(B * O, oh, ow, C, True, None),
        "entry": lambda: _build.entry("roi_crop", roi._ARGTYPES),
        "check + count": lambda: (_build.check(0, "K1"), kernels.count("roi_crop")),
    }
    cdll = getattr(ctypes.CDLL(str(_build.BUILD_DIR / "libroi_crop.so")), "suo_roi_crop")
    cdll.restype, cdll.argtypes = ctypes.c_int, roi._ARGTYPES
    vp = [ctypes.c_void_p(a) for a in args]
    earlier["CDLL call (c_void_p objects)"] = lambda: cdll(*vp[:4], *args[4:12], vp[12])
    ends = {"bare ctypes call (floor)": lambda: fn(*args),
            "whole wrapper": lambda: roi._roi_crop_cuda(imgs, boxes, mask, out_hw)}
    ns = host_ns({**earlier, **current, **ends})
    res = {"earlier": {k: ns[k] for k in earlier}, "current": {k: ns[k] for k in current},
           **{k: ns[k] for k in ends}}
    log("[host] K1 wrapper, host ns per call over 1,000 calls: " + json.dumps(res))
    return res


def check_k1(dev, rng, objs):
    """K1 at the frame's shape (8 boxes of a 480x640x3 f32 frame into
    8x256x256x3): the plan's path against the plain version; every path
    bit-equal to the generic one, with its device time; the call time in
    turns with `grid_sample`'s (K1, library, library, K1); the wrapper's
    host breakdown; ptxas's lines for its kernels."""
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
    plan = roi.plan_crop(N_OBJ, 256, 256, 3)
    dev_us = {}
    for name, path in (("generic", roi.GENERIC), ("strip", roi.STRIP)):
        f = lambda: roi._roi_crop_cuda(imgs, boxes, mask, (256, 256), path=path)
        if not torch.equal(f(), out_k):
            raise AssertionError(f"K1's {name} path differs from the {plan.path} path")
        us, src = device_us(f, "roi_crop", n=20)
        dev_us[name] = round(us, 3)
    log(f"[kernel] K1 device us per launch by path (bit-equal outputs; {src}): "
        f"{json.dumps(dev_us)}; the plan takes path {plan.path} {plan.grid} x {plan.block}; "
        f"target <= {TARGET_US['K1 device']} us; the earlier kernel (the generic path) in the "
        f"SLAM frame on an H100 80GB HBM3, 700 W: {EARLIER_US['K1 frame']} us")
    log(f"[build] K1 ptxas: {json.dumps(ptxas_kernels('roi_crop', ['roi_crop_kernel', 'roi_crop_kernel_strip']))}")
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
    def lib():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    kern = lambda: roi._roi_crop_cuda(imgs, boxes, mask, (256, 256))
    turns = [cuda_ms(kern), cuda_ms(lib), cuda_ms(lib), cuda_ms(kern)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    host = k1_wrapper_breakdown(imgs, boxes, mask)
    floor_ms = host["bare ctypes call (floor)"] / 1e6
    log(f"[host] K1 call {ms:.4f} ms against grid_sample's {lib_ms:.4f} ms (turns K1, library, "
        f"library, K1: {[round(t, 4) for t in turns]}); the bare ctypes call {floor_ms:.4f} ms; "
        f"target: <= the library's, or within 0.002 ms of the bare call where that is above "
        f"the library's; the earlier wrapper on an H100 80GB HBM3, 700 W: "
        f"{EARLIER_US['K1 call'] / 1e3:.4f} ms")
    x1 = bboxes[:, 0].clip(0, W_IMG)
    x2 = bboxes[:, 2].clip(0, W_IMG)
    y1 = bboxes[:, 1].clip(0, H_IMG)
    y2 = bboxes[:, 3].clip(0, H_IMG)
    read = min(float(np.sum((x2 - x1 + 2) * (y2 - y1 + 2))), H_IMG * W_IMG) * 3 * 4
    n_out = N_OBJ * 256 * 256
    b = bound(n_out * 3 * 4 + read + bboxes.nbytes + N_OBJ, n_out * 54)
    _report(f"K1 roi_crop (strip path, device {dev_us['strip']:.3f} us)", err, tol, ms, plain_ms,
            lib_ms, b, lib)
    return dict(name="roi_crop", route="cuda", source="suo_slam_tpu_torch/csrc/roi_crop.cu",
                replaces="suo_slam_tpu/ops/roi.py:84", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def launches_per_call(fn, n=3):
    """CUDA kernels per call of fn: the kernel nodes of a CUDA graph that
    captures n calls (memory copies and fills left out), counted by
    `cuGraphGetNodes` and `cuGraphNodeGetType` of libcuda. Unlike a profiler
    trace, the capture holds every launch. fn runs once on the capture's
    stream first, so one-time work (a build, a scratch allocation) is done."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    for name in ("cuGraphGetNodes", "cuGraphNodeGetType"):
        getattr(cu, name).restype = ctypes.c_int

    def ok(res, what):
        if res != 0:
            raise RuntimeError(f"{what} failed with CUresult {res}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=side):
        for _ in range(n):
            fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    kernels = 0
    for i in range(count.value):
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    g.reset()
    return kernels / n


def k2_paths(label, x, n_bytes):
    """K2 on logits x through both paths — dense (a cluster per crop, the
    main path's) and strided (the earlier design) — against the plain
    version within 1e-5 (f32 moments summed in another order): errors,
    wrapper ms, device us per call and kernels per call of each. Returns
    {path name: (err, ms, us)}."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    tol = 1e-5
    p = hm.heatmap_readout_plain(x, 1e-6)
    out = {}
    for path, name, key in ((hm.DENSE, "dense", "heatmap_readout_kernel_dense"),
                            (hm.STRIDED, "strided (earlier)", "heatmap_readout_kernel<")):
        f = lambda: hm._heatmap_readout_cuda(x, 1e-6, path=path)
        k = f()
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(k, p))
        if not err <= tol:
            raise AssertionError(f"K2 {label} ({name} path) disagrees with its plain version: "
                                 f"{err}")
        ms = cuda_ms(f)
        us, src = device_us(f, key)
        per = launches_per_call(f)
        if per != 1:
            raise AssertionError(f"K2 {label}: the {name} path made {per} launches per call")
        out[name] = (err, ms, us)
        log(f"[kernel] K2 {label} {name} path: max_abs_err {err:.3e} (tol {tol:.0e}) | call "
            f"{ms:.4f} ms | device {us:.3f} us by {src} | {per} kernels per call | "
            f"{n_bytes / (us * 1e-6) / 1e12:.3f} TB/s of the logits")
    return out


def k2_batch_invariance(x, label, crops=(0, 1, 57, 127)):
    """The dense path's outputs for crops of a batch equal the single-crop
    call's bit for bit."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    big = hm._heatmap_readout_cuda(x, 1e-6)
    bad = [i for i in crops if not all(
        torch.equal(a[i:i + 1], b) for a, b in zip(big, hm._heatmap_readout_cuda(x[i:i + 1], 1e-6)))]
    log(f"[kernel] K2 {label}: crops {list(crops)} of {x.shape[0]} equal to single-crop calls "
        f"bit for bit: {not bad}")
    if bad:
        raise AssertionError(f"K2 {label}: crops {bad} differ from their single-crop calls")


def check_k2(dev, rng, net):
    """K2 on the full-width net's f32 logits (8 crops, the head's channels_last
    layout, both transpose_heatmaps orders) and on 128 crops of bf16 logits
    in the same layout (the batched path's shape), on both paths, beside the
    earlier design's time (`EARLIER_US`); batch invariance at 128 crops."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    # the head's layout on the main path: an NHWC view of a channels_last
    # NCHW tensor of logits of the full-width net on 8 random crops
    crops = torch.from_numpy(rng.uniform(0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        raw = net.backbone_logits(crops)[-1]
    assert raw.shape == (N_OBJ, 64, 64, NK)
    plan = hm.plan_readout(raw.shape, raw.stride(), 4, raw.data_ptr())
    log(f"[kernel] K2 plan of the head's logits: {plan}")
    if plan.path != hm.DENSE:
        raise AssertionError(f"K2 does not take the head's logits on its dense path: {plan}")
    tol = 1e-5  # f32 moments over 4096 pixels, summed in another order
    n = raw.numel()
    paths = k2_paths(f"f32 {list(raw.shape)}", raw, n_bytes=n * 4)
    k2_paths(f"f32 {list(raw.shape)} transposed", raw.transpose(1, 2), n_bytes=n * 4)
    err, ms, us = paths["dense"]
    err = max(err, paths["strided (earlier)"][0])
    plain_ms = cuda_ms(lambda: hm.heatmap_readout_plain(raw, 1e-6))
    u, v = hm.ndc_grid(64, 64, torch.float32, dev)
    feats = torch.stack([u, v, u * u, v * v, u * v], -1).reshape(4096, 5)
    flat = raw.reshape(N_OBJ, 4096, NK)

    def lib():  # softmax + einsum: two PyTorch calls
        return torch.einsum("npk,pf->nkf", torch.softmax(flat, dim=1), feats)

    lib_ms = cuda_ms(lib)
    b = bound(n * 4 + N_OBJ * NK * (2 + 4 + 1) * 4, n * 24)
    _report(f"K2 heatmap_readout (f32 {list(raw.shape)}, dense path, device {us:.3f} us; "
            f"target <= {TARGET_US['K2 f32']}, the earlier design {EARLIER_US['K2 f32']} us)",
            err, tol, ms, plain_ms, lib_ms, b, lib)
    # the batched path's shape: 128 crops of bf16 logits in the head's layout
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    x = (torch.randn(128, NK, 64, 64, device=dev, generator=g) * 4).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    big = k2_paths(f"bf16 {list(x.shape)}", x, n_bytes=x.numel() * 2)
    bb = bound(x.numel() * 2 + 128 * NK * 7 * 4, x.numel() * 24)
    log(f"[kernel] K2 bf16 {list(x.shape)}: bound {bb[0]:.5f} ms ({bb[1]}); dense "
        f"{big['dense'][2]:.3f} us, strided (earlier) {big['strided (earlier)'][2]:.3f} us")
    k2_batch_invariance(x, f"bf16 {list(x.shape)}")
    k2_batch_invariance(raw, f"f32 {list(raw.shape)}", crops=range(N_OBJ))
    del x
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


def _ba_problem(dev, rng, objs, V=16, obj_noise=5.0, cam_noise=0.0):
    """The engine's single-view BA problem: capacity V x 8 x 41, one active
    view, objects at poses perturbed by N(0, obj_noise) mm (the camera by
    N(0, cam_noise) mm), NDC measurements with info 1e4 I."""
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
    obj_T[:, :3, 3] += rng.normal(scale=obj_noise, size=(N_OBJ, 3))
    cam_T = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    cam_T[0, :3, 3] += rng.normal(scale=cam_noise, size=3)
    cam_active = np.zeros((V,), bool)
    cam_active[0] = True
    t = lambda a: torch.as_tensor(a).to(dev)
    return ba.BAProblem(
        cam_T=t(cam_T), obj_T=t(obj_T.astype(np.float32)), uv=t(uv), info=t(info),
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
    lib = lambda: torch.bmm(JW, J)
    lib_ms = cuda_ms(lib)
    e = V * O * K
    in_bytes = V * 64 + O * 64 + e * (8 + 16 + 1) + O * K * 12 + V * O * 16
    out_bytes = V * O * (144 + 12) * 4 + e * 8
    # ~200 f32 ops per edge (projection, residual, chi2, Huber, 2x12 J,
    # weighting) + 156 outputs x 2K products x 2 per (v, o)
    b = bound(in_bytes + out_bytes, e * 200 + V * O * 156 * 2 * K * 2)
    b_chi2 = bound(in_bytes - e + e * 8, e * 45)
    _report("K4 ba_edges (H/g mode, H)", err, tol, ms, plain_ms, lib_ms, b, lib)
    log(f"[kernel] K4 ba_edges (chi2 mode): kernel {ms_chi2:.4f} ms | plain "
        f"{plain_chi2:.4f} ms | bound {b_chi2[0]:.5f} ms ({b_chi2[1]})")
    return dict(name="ba_edges", route="cuda", source="suo_slam_tpu_torch/csrc/ba_edges.cu",
                replaces="suo_slam_tpu/solvers/ba.py:130", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def _k5_inputs(dev, rng):
    """The SLAM path's symmetric group: 3 objects in a bucket of 4 crops,
    post_stem priors at 64x64, about 40% of the channels valid, the padded
    slot masked."""
    import torch

    ob = 4
    uv = torch.from_numpy(rng.uniform(-1.1, 1.1, (ob, NK, 2)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(size=(ob, NK)) < 0.4).to(dev)
    mask[3] = False
    return uv, mask


def k5_device_us(uv, mask):
    """K5's device us at [4, 64, 64, 41] by dtype (torch.profiler), with the
    bytes bound and the device us of `zero_` on a map of that size (the
    card's own floor for writing those bytes)."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    hw, sigma = (64, 64), hm.prior_sigma_for((64, 64))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        us, src = device_us(lambda: hm._render_prior_cuda(uv, mask, hw, sigma, dt),
                            "prior_render_kernel")
        n_bytes = uv.shape[0] * 64 * 64 * NK * dt.itemsize + uv.shape[0] * NK * 9
        z = torch.empty((uv.shape[0], 64, 64, NK), dtype=dt, device=uv.device)
        out[name] = {"device_us": us, "by": src, "bound_us": 1e6 * n_bytes / HBM_BYTES_PER_S,
                     "zero_us": lib_device_us(z.zero_, n=20)[0]}
    return out


def prior_copies(call, mask) -> list:
    """Run `call` and list the copies and casts in it (aten `to`,
    `_to_copy`, `clone` or `contiguous` that return new memory, and `copy_`)
    that read the prior map that `render_prior_heatmaps` returns there, or
    the keypoint `mask` the call is given: each would be a launch of its own
    beside K5's."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from suo_slam_tpu_torch.ops import heatmap as hm

    watched = {mask.untyped_storage().data_ptr(): "mask"}
    keep, hits = [], []  # maps kept alive, so that no later tensor reuses their memory

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("to", "_to_copy", "clone", "contiguous", "copy_", "_copy_from"):
                src = args[1] if name == "copy_" else args[0]
                ptr = lambda t: t.untyped_storage().data_ptr()
                what = watched.get(ptr(src)) if isinstance(src, torch.Tensor) else None
                if what and (name == "copy_" or ptr(out) != ptr(src)):
                    hits.append(f"{func} of the {what} {list(src.shape)} {src.dtype}")
            return out

    def render(*a, **k):
        out = real(*a, **k)
        keep.append(out)
        watched[out.untyped_storage().data_ptr()] = "prior map"
        return out

    real, hm.render_prior_heatmaps = hm.render_prior_heatmaps, render
    try:
        with Watch():
            call()
    finally:
        hm.render_prior_heatmaps = real
    if not keep:
        raise AssertionError("prior_copies: the call rendered no prior")
    return hits


def k5_bf16_frame(dev, net16, uv, mask, seed=5):
    """One with-prior call of the bf16 net's `make_frame_inference` on a
    seeded 480x640 frame (4 boxes, the last invalid; the priors `uv`,
    `mask` at post_stem's 64x64): the same
    bits as an f32 render that the net casts itself (the route before K5
    wrote bf16); one K5 launch by counter and no copy or cast of the prior
    map or its mask (`prior_copies`); by torch.profiler its kernels, K5's
    among them, and its copy kernels."""
    import torch
    from torch.autograd import DeviceType

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.ops import roi
    from suo_slam_tpu_torch.slam import kernels as sk

    fn = sk.make_frame_inference(net16, device=dev)
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)).to(dev)
    boxes = torch.tensor([[40.0, 30.0, 200.0, 190.0], [300.0, 100.0, 420.0, 260.0],
                          [100.0, 250.0, 330.0, 460.0], [0.0, 0.0, 10.0, 10.0]], device=dev)
    valid = torch.tensor([True, True, True, False], device=dev)
    call = lambda: fn(img, boxes, valid, uv, mask)
    phw = net16.prior_hw((256, 256))
    with torch.inference_mode():
        out = call()
        crops = roi.roi_crop_batch(img[None], boxes[None], valid[None], (256, 256))[0]
        ref = net16(crops, hm.render_prior_heatmaps(uv, mask, phw, hm.prior_sigma_for(phw)))
        ref = (ref.uv, ref.cov, ref.kp_mask)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            gaps = [(a.float() - b.float()).abs().max().item() for a, b in zip(out, ref)]
            raise AssertionError(f"bf16 with-prior frame call: not the bits of the f32 render "
                                 f"the net casts (uv, cov, kp_mask gaps {gaps})")
        kernels.reset_counts()
        call()
        torch.cuda.synchronize()
        k5 = kernels.counts()["prior_render"]
        casts = prior_copies(call, mask)
        cuda = lambda a: [e for e in a if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)]
        avg = traced(call, lambda a: len(cuda(a)) > 0, "bf16 with-prior frame call")
    r = {"k5_launches": k5, "prior_casts": casts, "kernels": "not measured",
         "copies": "not measured", "k5_kernels": "not measured"}
    if avg is not None:
        ks = cuda(avg)
        r.update(kernels=sum(e.count for e in ks),
                 copies=sum(e.count for e in ks if "copy" in e.key.lower()),
                 k5_kernels=[e.key[:72] for e in ks if "prior_render" in e.key])
    log("[kernel] K5 in a bf16 with-prior frame call (4 boxes): same bits as the f32 render "
        "the net casts; " + json.dumps(r))
    if k5 != 1 or casts:
        raise AssertionError(f"bf16 with-prior frame call: {k5} K5 launches (expected 1), "
                             f"copies or casts of the prior: {casts}")
    return r


def check_k5(dev, rng, net16=None):
    """K5 at the SLAM path's symmetric group ([4, 64, 64, 41], `_k5_inputs`)
    in f32 and bf16: the f32 map equal to the plain version, the bf16 map
    equal to the plain f32 map rounded once; kernel, device and plain times
    beside the bytes bound. With `net16`, a bf16 with-prior frame call
    (`k5_bf16_frame`)."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    uv, mask = _k5_inputs(dev, rng)
    hw = (64, 64)
    sigma = hm.prior_sigma_for(hw)
    out_p = hm.render_prior_heatmaps_plain(uv, mask, hw, sigma)
    err, rows, dev_us = 0.0, {}, k5_device_us(uv, mask)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fn = lambda: hm._render_prior_cuda(uv, mask, hw, sigma, dt)
        out_k = fn()
        torch.cuda.synchronize()
        e = (out_k.float() - out_p.to(dt).float()).abs().max().item()
        if not (torch.equal(out_k, out_p.to(dt)) and out_k.is_contiguous()):
            raise AssertionError(f"K5 ({name}) is not its plain version's map rounded once: {e}")
        err = max(err, e)
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(lambda: hm.render_prior_heatmaps_plain(uv, mask, hw, sigma, dt))
        n_out = out_k.numel()
        # ~20 f32 operations per output (2 sub, 2 div, 3 mul, 1 add, the exp)
        b = bound(n_out * dt.itemsize + uv.shape[0] * NK * 9, n_out * 20)
        d = dev_us[name]
        _report(f"K5 prior_render ({name}, [4, 64, 64, 41], device {d['device_us']:.3f} us by "
                f"{d['by']}; zero_ of the map {d['zero_us']:.3f} us)", e, "0", ms, plain_ms,
                None, b)
        rows[name] = (ms, plain_ms, b)
    log(f"[kernel] K5 device us at [4, 64, 64, 41]: f32 {dev_us['f32']['device_us']:.3f} "
        f"(target <= 2.5; the first design 4.800), bf16 {dev_us['bf16']['device_us']:.3f} "
        f"(target below f32)")
    if net16 is not None:
        k5_bf16_frame(dev, net16, uv, mask)
    ms, plain_ms, b = rows["f32"]
    return dict(name="prior_render", route="cuda",
                source="suo_slam_tpu_torch/csrc/prior_render.cu",
                replaces="suo_slam_tpu/ops/heatmap.py:167", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def _k6_inputs(dev, rng, objs, S, M):
    """S pose sets of the 8 objects near their true camera-frame poses and M
    rows of noisy detections, info (1/0.005^2) I."""
    import torch

    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.slam.engine import _fix_K_np

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    rows = [make_view(rng, objs) for _ in range(M)]
    k4 = np.zeros((M, N_OBJ, 4), np.float32)
    for m, (_, _, bb, _) in enumerate(rows):
        for o in range(N_OBJ):
            K = _fix_K_np(YCBV_K, bb[o])
            k4[m, o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    T = np.stack([rows[s % M][1] for s in range(S)])
    # pose sets 0.2-1.5 mm and ~1 mrad off: counts from most to few edges
    scale = np.array([0.001] * 3 + [0.2] * 3) * (1 + np.arange(S) % 8)[:, None, None]
    jitter = lie.se3_exp(t(rng.normal(size=(S, N_OBJ, 6)) * scale))
    T_sets = (jitter @ t(T)).contiguous()
    uv = np.stack([r[3] for r in rows]) + rng.normal(scale=0.005, size=(M, N_OBJ, NK, 2))
    info = np.broadcast_to(np.eye(2) / 0.005 ** 2, (M, N_OBJ, NK, 2, 2))
    mask = np.broadcast_to(objs.masks, (M, N_OBJ, NK)) & (rng.uniform(size=(M, N_OBJ, NK)) < 0.9)
    return (T_sets, t(objs.model_kps), t(uv), t(info),
            torch.from_numpy(np.ascontiguousarray(mask)).to(dev), t(k4))


# camera-RANSAC cases of K6's fused mode (`camera_ransac_inputs`); "map 64"
# and "map 128" take 4 rounds of 16 and 128 rounds of 1 hypothesis
# (`camera_ransac_hyps`)
CAM_CASES = ("seeded", "padded", "tie", "no inlier", "no candidate", "unmet", "map 64",
             "map 128")


def _frame_rows(rng, objs, T_OtoC, sigma=0.005):
    """One view's detections of the 8 objects under T_OtoC [8, 4, 4] (mm):
    each object's box-fixed intrinsics k4 (from the projected keypoints'
    box, `_fix_K_np`) and its NDC keypoints under them + N(0, sigma)."""
    from suo_slam_tpu_torch.slam.engine import _fix_K_np

    k4 = np.zeros((N_OBJ, 4), np.float32)
    uv = np.zeros((N_OBJ, NK, 2))
    for o in range(N_OBJ):
        p = objs.model_kps[o] @ T_OtoC[o, :3, :3].T + T_OtoC[o, :3, 3]
        px = p @ YCBV_K.T
        px = px[:, :2] / px[:, 2:]
        m = objs.masks[o]
        bb = np.concatenate([px[m].min(0) - 10, px[m].max(0) + 10])
        K = _fix_K_np(YCBV_K, bb)
        k4[o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        uv[o] = k4[o, :2] * p[:, :2] / p[:, 2:] + k4[o, 2:]
    return uv + rng.normal(scale=sigma, size=uv.shape), k4


def _jitter(rng, T, rot, trans):
    """T [..., 4, 4] moved by a random rotation of ~rot rad and translation
    of ~trans mm on the left."""
    from scipy.spatial.transform import Rotation

    out = np.array(T, np.float64)
    for i in np.ndindex(out.shape[:-2]):
        J = np.eye(4)
        J[:3, :3] = Rotation.from_rotvec(rng.normal(scale=rot, size=3)).as_matrix()
        J[:3, 3] = rng.normal(scale=trans, size=3)
        out[i] = J @ out[i]
    return out


def camera_ransac_inputs(dev, rng, objs, case="seeded"):
    """K6's camera-RANSAC inputs at the SLAM path's shapes (ob = 8 group
    rows, O = 8 map slots, K = 41): the map T_OtoG of a view seen from a
    camera T_GtoC, each map pose and each row's PnP pose off by a little
    (hypotheses from ~all inliers to few), the rows in a shuffled slot
    order, info (1/0.005^2) I, 90% of the model's keypoints kept, one
    failed PnP and one inactive object. `case` (CAM_CASES): "padded" 6 rows
    + 2 pads (slot O); "tie" two slots with equal hypotheses, the best, the
    higher slot's row first; "no inlier" a row that keeps no keypoint;
    "no candidate" every PnP failed; "unmet" min_num_inliers above any
    count; "map <O>" the seeded rows and map copied O / 8 times into O
    slots and as many rows in a shuffled order, each copy's map poses
    jittered further (a hypothesis a slot, each scored on every copy).
    Returns (the arguments of `camera_ransac` up to model_kp_full,
    min_num_inliers)."""
    import torch

    _, T_OtoC, _, _ = make_view(rng, objs)
    C = _jitter(rng, np.eye(4), 0.05, 50.0)                 # T_GtoC
    T_map = np.linalg.inv(C) @ T_OtoC                        # T_OtoG, true
    T_pnp = _jitter(rng, T_OtoC, 1e-5, 0.02)
    # the map's error grows with a random rank: hypotheses from best to worst
    s = 1.0 + rng.permutation(N_OBJ)
    if case == "tie":  # slots 1 and 2 exact, the others well off
        s = np.where(np.isin(np.arange(N_OBJ), [1, 2]), 0.0, 10.0 + s)
        T_pnp[[1, 2]] = T_OtoC[[1, 2]]
    T_map = np.stack([_jitter(rng, T_map[j], 2e-5 * s[j], 0.05 * s[j]) for j in range(N_OBJ)])
    uv, k4 = _frame_rows(rng, objs, T_OtoC)
    keep = objs.masks & (rng.uniform(size=(N_OBJ, NK)) < 0.9)
    pnp_ok = np.ones(N_OBJ, bool)
    pnp_ok[5] = False
    active = np.ones(N_OBJ, bool)
    active[6] = False
    slots = rng.permutation(N_OBJ)                          # row i -> slot slots[i]
    min_inl = 4
    if case == "tie":  # slots 1 and 2 share one pose: equal hypotheses
        T_map[2] = T_map[1]
        T_pnp[2] = T_pnp[1]
        slots = np.array([2, 1] + [s for s in slots if s not in (1, 2)])
    elif case == "padded":
        slots[6:] = N_OBJ
    elif case == "no inlier":
        keep[0] = False
    elif case == "no candidate":
        pnp_ok[:] = False
    elif case == "unmet":
        min_inl = 10_000
    # row i carries slot slots[i]'s object (a pad row: slot 0's, dropped)
    src = np.where(slots < N_OBJ, slots, 0)
    rows = [a[src] for a in (T_pnp, pnp_ok, uv, keep, k4)]
    model_kp = objs.model_kps
    if case.startswith("map "):
        R = int(case[4:]) // N_OBJ
        T_map = np.concatenate([T_map] + [np.stack([_jitter(rng, T, 1e-4 * c, 0.5 * c)
                                                    for T in T_map]) for c in range(1, R)])
        active, model_kp = np.tile(active, R), np.tile(model_kp, (R, 1, 1))
        perm = rng.permutation(R * N_OBJ)
        slots = np.concatenate([slots + N_OBJ * c for c in range(R)])[perm]
        rows = [np.concatenate([a] * R)[perm] for a in rows]
    T_rows, ok_rows, uv_rows, keep_rows, k4_rows = rows
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    info = np.broadcast_to(np.eye(2) / 0.005 ** 2, keep_rows.shape + (2, 2))
    args = (t(T_rows), t(ok_rows, torch.bool), t(uv_rows), t(info), t(keep_rows, torch.bool),
            t(k4_rows), t(slots, torch.int64), t(T_map), t(active, torch.bool), t(model_kp))
    return args, min_inl


def reinit_inputs(dev, rng, objs, n=16, V=32):
    """K6's re-init inputs at the SLAM path's window (n = 16 view slots of
    V = 32 mirror rows, the 15-view window padded, `engine._fused_tail`):
    the map's true T_OtoG, this frame's PnP poses (3 objects off by 20 mm)
    and the estimates (3 others off by 20 mm), n cameras around the first,
    their rows of the mirrors holding the detections, 85% of the keypoints
    valid; the last view and one more invalid."""
    import torch

    _, T_OtoC, _, _ = make_view(rng, objs)
    cams = _jitter(rng, np.tile(np.eye(4), (n, 1, 1)), 0.02, 20.0)
    cs = rng.choice(V, n, replace=False)
    uv_m = np.zeros((V, N_OBJ, NK, 2))
    k4_m = np.zeros((V, N_OBJ, 4), np.float32)
    for m in range(n):
        uv_m[cs[m]], k4_m[cs[m]] = _frame_rows(rng, objs, cams[m] @ T_OtoC)
    valid_m = objs.masks[None] & (rng.uniform(size=(V, N_OBJ, NK)) < 0.85)
    info_m = np.broadcast_to(np.eye(2) / 0.005 ** 2, (V, N_OBJ, NK, 2, 2))
    T_pnp, T_est = T_OtoC.copy(), T_OtoC.copy()
    T_pnp[[0, 2, 4], :3, 3] += 20.0
    T_est[[1, 3, 5], :3, 3] += 20.0
    cam_valid = np.ones(n, bool)
    cam_valid[[n - 1, n // 2]] = False
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    return (t(T_pnp), t(T_est), t(cams), t(cam_valid, torch.bool), t(objs.model_kps), t(uv_m),
            t(info_m), t(valid_m, torch.bool), t(k4_m), t(cs, torch.int64))


def k6_camera_bound(args):
    """K6's camera-RANSAC bound from this run's inputs: each input read once
    and the outputs written once, against the f32 operations the data needs:
    the O inverses and hypotheses (~130 each), the O x O compositions (84
    each) and ~45 per edge each candidate hypothesis scores (the kept
    keypoints of every candidate object)."""
    T_pnp, pnp_ok, uv, info, keep, k4, slots, obj_T, active, model_kp = [a.cpu() for a in args]
    ob, K = keep.shape
    O = obj_T.shape[0]
    row = {int(s): i for i, s in enumerate(slots.tolist()) if s < O}
    cand = [j for j in range(O) if j in row and bool(pnp_ok[row[j]]) and bool(active[j])]
    edges = len(cand) * sum(int(keep[row[o]].sum()) for o in cand)
    nbytes = ob * (64 + 1 + K * (8 + 16 + 1) + 16 + 8) + O * (64 + 1 + K * 12) + 64 + 4 + 1 + 8
    return bound(nbytes, O * 130 + O * O * 84 + edges * 45)


def k6_reinit_bound(args):
    """K6's re-init bound: the n views' slots, cameras and rows of the
    mirrors read once, the [2, O] counts written once; the 2 x n x O pose
    compositions and ~45 operations per edge of a valid view, for both
    pose sets."""
    T_pnp, _, cam_T, cam_valid, _, _, _, valid_m, _, cs = [a.cpu() for a in args]
    n, (V, O, K) = cs.shape[0], valid_m.shape
    edges = int(valid_m[cs][cam_valid].sum())
    nbytes = n * (8 + 64 + 1) + 2 * O * 64 + O * K * 12 + n * O * (K * (8 + 16 + 1) + 16) + 8 * O
    return bound(nbytes, 2 * O * n * 84 + 2 * edges * 45)


def k6_clocks(label, fn, phases, rows=1):
    """A fused K6 mode's SM clock cycles by phase (thread 0; `fn(cycles)`
    launches it) on one call after a warm one: with several blocks, the
    slowest block's row and the mean over the blocks."""
    import torch

    cyc = torch.zeros((rows, len(phases)), dtype=torch.int64, device="cuda")
    fn(cyc if rows > 1 else cyc[0])
    cyc.zero_()
    fn(cyc if rows > 1 else cyc[0])
    r = cyc.cpu()
    slow = r[int(r.sum(1).argmax())].tolist()
    log(f"[kernel] {label}: SM cycles by phase, slowest block "
        + json.dumps(dict(zip(phases, slow))) + f" ({sum(slow)} in all)"
        + ("" if rows == 1 else ", mean over " + str(rows) + " blocks " + json.dumps(
            {k: round(v) for k, v in zip(phases, r.double().mean(0).tolist())})))


def check_k6(dev, rng, objs):
    """K6's three modes against their plain versions on the card, exactly:
    the first design's bare counts (camera RANSAC's H = 8 sets, re-init's
    2 x 15 views); the fused camera RANSAC over `CAM_CASES` (the pose's
    bits, the count, ok and the best slot; the tie to the lower slot); the
    fused re-init vote at the SLAM window. Each timed (call, plain version,
    device us) beside the chain it replaced (the [O] scatters, the
    compositions and the bare K6, the earlier schedule), with its bound."""
    import torch

    from suo_slam_tpu_torch.slam import kernels as sk

    cases = {"ransac": (_k6_inputs(dev, rng, objs, N_OBJ, 1), False),
             "reinit": (_k6_inputs(dev, rng, objs, 30, 15), True)}
    for name, (args, per_obj) in cases.items():
        ck = sk._chi2_counts_cuda(*args, 5.991, per_obj)
        cp = sk.chi2_counts_plain(*args, 5.991, per_obj)
        torch.cuda.synchronize()
        diff = int((ck != cp).sum())
        log(f"[kernel] K6 {name}: counts {ck.flatten().tolist()[:16]} ... "
            f"({diff} of {ck.numel()} differ)")
        if diff:
            raise AssertionError(f"K6 {name} counts differ from the plain version: "
                                 f"{ck.tolist()} vs {cp.tolist()}")
        S, O, K, M = args[0].shape[0], N_OBJ, NK, args[2].shape[0]
        ms = cuda_ms(lambda: sk._chi2_counts_cuda(*args, 5.991, per_obj))
        plain_ms = cuda_ms(lambda: sk.chi2_counts_plain(*args, 5.991, per_obj))
        # ~45 f32 operations per edge: the pose (18), the projection (8),
        # the residual and chi2 (11), the tests and the sum
        b = bound(S * O * 64 + O * K * 12 + M * O * K * (8 + 16 + 1) + M * O * 16
                  + (S // M if per_obj else S) * (O if per_obj else 1) * 4, S * O * K * 45)
        us, src = device_us(lambda: sk._chi2_counts_cuda(*args, 5.991, per_obj),
                            "chi2_counts_kernel")
        _report(f"K6 chi2_counts (first design, {name}; device {us:.3f} us by {src})", 0.0,
                "exact", ms, plain_ms, None, b)

    bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
    res = {}
    for case in CAM_CASES:
        args, mi = camera_ransac_inputs(dev, rng, objs, case)
        k = sk._camera_ransac_cuda(*args, mi)
        p = sk.camera_ransac_plain(*args, mi)
        torch.cuda.synchronize()
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(k, p))
        T, count, ok, best = (a.cpu() for a in k)
        want = {"tie": bool(ok) and int(best) == 1, "no candidate": not ok and int(count) == -1,
                "unmet": not ok}.get(case, bool(ok))
        O, ob, K = args[7].shape[0], args[4].shape[0], NK
        log(f"[kernel] K6 camera RANSAC ({case}; O={O}, ob={ob}, "
            f"{sk.camera_ransac_hyps(O, ob, K)} hypotheses a round): count {int(count)}, best "
            f"slot {int(best)}, ok {bool(ok)}; {'equal to' if same else 'DIFFERS from'} its "
            f"plain twin (T bits, count, ok, best)")
        if not (same and want and (bool(ok) or torch.equal(T, torch.eye(4)))):
            raise AssertionError(f"K6 camera RANSAC ({case}): kernel {k}, twin {p}")
        if case == "seeded":
            res["camera"] = args, mi
    args, mi = res["camera"]
    T_pnp, pnp_ok, uv, info, keep, k4, slots, obj_T, active, model_kp = args

    def earlier():  # the earlier chain: [O] scatters, compositions, bare K6, the selection
        rows = lambda src, fill: sk._scatter_rows(torch.full((N_OBJ,) + src.shape[1:], fill,
                                                             dtype=src.dtype, device=dev),
                                                  slots, src)
        T_row = sk._scatter_rows(torch.eye(4, device=dev).repeat(N_OBJ, 1, 1), slots, T_pnp)
        cand = rows(pnp_ok, False) & active
        inl = rows(keep, False)
        T_hyp = sk.compose_plain(T_row, sk.invert_se3_plain(obj_T))
        counts = sk._chi2_counts_cuda(sk.compose_plain(T_hyp[:, None], obj_T[None]), model_kp,
                                      rows(uv, 0.0)[None], rows(info, 0.0)[None],
                                      (inl & (inl.any(-1) & cand)[:, None])[None],
                                      rows(k4, 0.0)[None], sk.CHI2_THRESH_2DOF, False)
        return sk._select(counts, cand, T_hyp, mi)[:3]

    e = earlier()
    k = sk._camera_ransac_cuda(*args, mi)
    if not all(torch.equal(a, b) for a, b in zip(e, k[:3])):
        raise AssertionError(f"K6 camera RANSAC: the earlier chain {e} against {k}")
    ms = cuda_ms(lambda: sk._camera_ransac_cuda(*args, mi))
    plain_ms = cuda_ms(lambda: sk.camera_ransac_plain(*args, mi))
    e_ms = cuda_ms(earlier)
    us, src = device_us(lambda: sk._camera_ransac_cuda(*args, mi), "camera_ransac_kernel")
    k6_clocks("K6 camera RANSAC", lambda c: sk._camera_ransac_cuda(*args, mi, cycles=c),
              sk.K6_CAM_PHASES)
    b_cam = k6_camera_bound(args)
    _report(f"K6 camera_ransac (fused, ob={slots.shape[0]}, O={N_OBJ}, K={NK}; device "
            f"{us:.3f} us by {src}, target <= {TARGET_US['K6 camera']}; the earlier chain of "
            f"scatters + compositions + bare K6 {e_ms:.4f} ms)", 0.0, "exact", ms, plain_ms,
            None, b_cam)
    cam_ms, cam_plain_ms = ms, plain_ms

    args = reinit_inputs(dev, rng, objs)
    k = sk._reinit_votes_cuda(*args)
    p = sk.reinit_votes_plain(*args)
    T_pnp, T_est, cam_T, cam_valid, model_kp, uv_m, info_m, valid_m, k4_m, cs = args

    def earlier_reinit():  # the earlier chain: gathers, two bmm, a cat, the mask, bare K6
        T = torch.cat([cam_T[:, None] @ T_pnp[None], cam_T[:, None] @ T_est[None]])
        return sk._chi2_counts_cuda(T, model_kp, uv_m[cs], info_m[cs],
                                    valid_m[cs] & cam_valid[:, None, None], k4_m[cs], 5.991,
                                    True)

    e = earlier_reinit()
    torch.cuda.synchronize()
    log(f"[kernel] K6 re-init (fused, n={cs.shape[0]} of V={valid_m.shape[0]} views): counts "
        f"pnp {k[0].tolist()}, est {k[1].tolist()}; twin pnp {p[0].tolist()}, est "
        f"{p[1].tolist()}; the earlier chain {e.tolist()}")
    if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
        raise AssertionError("K6 re-init counts differ from the plain twin")
    ms = cuda_ms(lambda: sk._reinit_votes_cuda(*args))
    plain_ms = cuda_ms(lambda: sk.reinit_votes_plain(*args))
    e_ms = cuda_ms(earlier_reinit)
    us, src = device_us(lambda: sk._reinit_votes_cuda(*args), "reinit_votes_kernel")
    k6_clocks("K6 re-init", lambda c: sk._reinit_votes_cuda(*args, cycles=c),
              sk.K6_REINIT_PHASES, rows=2 * N_OBJ)
    _report(f"K6 reinit_votes (fused; device {us:.3f} us by {src}, target <= "
            f"{TARGET_US['K6 reinit']}; the earlier chain of gathers + bmm + bare K6 "
            f"{e_ms:.4f} ms)", 0.0, "exact", ms, plain_ms, None, k6_reinit_bound(args))
    return dict(name="chi2_counts", route="cuda", source="suo_slam_tpu_torch/csrc/chi2_counts.cu",
                replaces="suo_slam_tpu/slam/kernels.py:138", max_abs_err=0.0, ms=cam_ms,
                plain_ms=cam_plain_ms, bound_ms=b_cam[0], bound_by=b_cam[1], library_ms=None)


def k7_scaled_errors(k, p):
    """The largest errors of K7's (d_cam, d_obj) against the plain ones, each
    entry over the largest |entry| of the plain version's 6-vector block
    (one camera's or one object's step); in a block that is exactly 0 every
    entry must be 0."""
    import torch

    def worst(a, b):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            return math.inf
        e = (a.double() - b.double()).abs()
        s = b.double().abs().amax(-1, keepdim=True)
        r = torch.where(s > 0, e / s.clamp(min=1e-300), torch.where(e > 0, math.inf, 0.0))
        return r.max().item() if r.numel() else 0.0

    return worst(k[0], p[0]), worst(k[1], p[1])


def _normal_equations(dev, scene, V):
    """The global BA's normal-equation blocks at the SLAM path's shapes:
    V view slots (the first n active), 8 objects, 41 keypoints, noisy
    measurements and perturbed poses, through the plain K4."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    rng = np.random.default_rng(5)
    n = min(V, len(scene.cams))
    uv = np.zeros((V, N_OBJ, NK, 2), np.float32)
    k4 = np.zeros((V, N_OBJ, 4), np.float32)
    valid = np.zeros((V, N_OBJ, NK), bool)
    for v in range(n):
        _, bb, uvs = scene.frame(v)
        uv[v] = uvs + rng.normal(scale=0.005, size=uvs.shape)
        k4[v] = scene.k4(bb)
        valid[v] = scene.objs.masks
    cam_T = np.tile(np.eye(4), (V, 1, 1))
    cam_T[:n] = scene.cams[:n]
    cam_T[1:n, :3, 3] += rng.normal(scale=2.0, size=(n - 1, 3))
    obj_T = scene.T_obj.copy()
    obj_T[:, :3, 3] += rng.normal(scale=2.0, size=(N_OBJ, 3))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    info = t(np.broadcast_to(np.eye(2) / 0.005 ** 2, (V, N_OBJ, NK, 2, 2)))
    inl = torch.from_numpy(valid).to(dev)
    H, g, _, _ = ba._edge_planes_Hg_plain(t(cam_T), t(obj_T), t(uv), info, t(scene.objs.model_kps),
                                          t(k4), inl, True, ba.HUBER_DELTA)
    blocks = (H[..., :6, :6].sum(1), H[..., 6:, 6:].sum(0), H[..., :6, 6:].contiguous(),
              g[..., :6].sum(1), g[..., 6:].sum(0))
    cam_free = torch.zeros(V, dtype=torch.bool, device=dev)
    cam_free[1:n] = True
    return blocks, cam_free, torch.ones(N_OBJ, dtype=torch.bool, device=dev)


def check_k7(dev, scene):
    """K7 on the SLAM path's normal equations (global V = 32 and tracking
    V = 1). Gate 1: each entry within 1e-4 of its plain 6-block's largest
    |entry|, ok flags equal, at LM damping 1e-2: there a 1e-7 relative
    perturbation of the f32 inputs moves the solution by ~3e-5 of that
    scale (measured on the CPU), so 1e-4 measures the kernel. At the
    engine's first damping 1e-5 the global system is ill-conditioned: the
    same perturbation moves it by ~1e-2, for any f32 solve. Gate 2, at
    1e-5: K7's error against the plain solve in f64 at most twice the plain
    f32 solve's (or 1e-4)."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    cases = {}
    blocks, cam_free, obj_free = _normal_equations(dev, scene, 32)
    cases["global"] = (blocks, cam_free, obj_free, False)
    tb, tcf, _ = _normal_equations(dev, scene, 1)
    tcf[0] = True
    cases["tracking"] = (tb, tcf, torch.zeros(N_OBJ, dtype=torch.bool, device=dev), True)
    res = {}
    for name, (bl, cf, of, frozen) in cases.items():
        lam = torch.tensor(1e-2, device=dev)
        k = ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam, frozen)
        p = ba._solve_normal_eq_schur_plain(*bl, cf, of, lam)
        lam5 = torch.tensor(1e-5, device=dev)
        k5 = ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam5, frozen)
        p5 = ba._solve_normal_eq_schur_plain(*bl, cf, of, lam5)
        r64 = ba._solve_normal_eq_schur_plain(*[b.double() for b in bl], cf, of,
                                              lam5.double())
        r64 = (r64[0].float(), r64[1].float())
        torch.cuda.synchronize()
        sc, so = k7_scaled_errors(k, p)
        err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
        ek, ep = max(k7_scaled_errors(k5, r64)), max(k7_scaled_errors(p5, r64))
        log(f"[kernel] K7 {name}: ok {bool(k[2])}/{bool(p[2])}, scaled errors d_cam {sc:.3e} "
            f"d_obj {so:.3e} (tol 1e-4, damping 1e-2), max abs {err:.3e}, max |d_cam| "
            f"{p[0].abs().max().item():.3e}; at damping 1e-5 against the f64 solve: "
            f"K7 {ek:.3e}, plain {ep:.3e}")
        if not (bool(k[2]) == bool(p[2]) and bool(p[2]) and max(sc, so) <= 1e-4
                and bool(k5[2]) == bool(p5[2]) and ek <= max(2 * ep, 1e-4)):
            raise AssertionError(f"K7 {name} disagrees with its plain version: {sc}, {so}, "
                                 f"{ek} vs {ep}")
        # the same blocks with one camera block not positive definite:
        # a NaN factor -> zero steps and ok False, no raise
        bad = bl[0].clone()
        bad[0] = -torch.eye(6, device=dev)
        cf_bad = cf.clone()
        cf_bad[0] = True
        kb = ba._solve_normal_eq_schur_cuda(bad, *bl[1:], cf_bad, of, lam, frozen)
        pb = ba._solve_normal_eq_schur_plain(bad, *bl[1:], cf_bad, of, lam)
        if bool(kb[2]) or bool(pb[2]) or kb[0].any() or kb[1].any():
            raise AssertionError(f"K7 {name}: a non-PD camera block must give ok False")
        ms = cuda_ms(lambda: ba._solve_normal_eq_schur_cuda(*bl, cf, of, lam, frozen))
        plain_ms = cuda_ms(lambda: ba._solve_normal_eq_schur_plain(*bl, cf, of, lam))
        V, O = bl[2].shape[:2]
        Hcc = bl[0]

        def lib():  # the camera blocks' factor and the two triangular solves
            L, _ = torch.linalg.cholesky_ex(Hcc)
            rhs = torch.cat([bl[2].permute(0, 2, 1, 3).reshape(V, 6, 6 * O), bl[3][..., None]], -1)
            half = torch.linalg.solve_triangular(L, rhs, upper=False)
            return torch.linalg.solve_triangular(L.transpose(-1, -2), half, upper=True)

        lib_ms = cuda_ms(lib)
        n_o = 0 if frozen else 6 * O
        flops = V * (300 + (n_o + 1) * 80) + (n_o * n_o + n_o) * V * 12 + n_o ** 3 // 3 \
            + 2 * n_o * n_o + V * (12 * n_o + 80)
        b = bound(V * 144 + O * 144 + V * O * 144 + V * 24 + O * 24 + V + O + 4
                  + V * 24 + O * 24 + 1, flops)
        res[name] = (max(sc, so), ms, plain_ms, lib_ms, b)
        _report(f"K7 ba_schur ({name}, V={V})", max(sc, so), "1e-4 of each 6-block's max",
                ms, plain_ms, lib_ms, b, lib)
    err, ms, plain_ms, lib_ms, b = res["global"]
    return dict(name="ba_schur", route="cuda", source="suo_slam_tpu_torch/csrc/ba_schur.cu",
                replaces="suo_slam_tpu/solvers/ba.py:267", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def lm_arrays(V, O, n_views, n_objs, seed, K=41):
    """A pose graph at the engine's shapes, numpy only: n_views cameras on a
    ~0.2 rad arc 600 mm from n_objs objects (16 of K keypoints each, in a
    100 mm cube), NDC measurements with N(0, 0.003) noise and 5% outliers,
    info 1e4 I, cameras after the first and the objects 1-2 mm off; the
    rest of the V x O capacity inactive."""
    rng = np.random.default_rng(seed)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        i, j = [(1, 2), (2, 0), (0, 1)][axis]
        R = np.eye(3)
        R[i, i] = R[j, j] = c
        R[i, j], R[j, i] = -s, s
        return R

    obj_T = np.tile(np.eye(4), (O, 1, 1))
    model_kp = np.zeros((O, K, 3))
    valid_kp = np.zeros((O, K), bool)
    for o in range(n_objs):
        obj_T[o, :3, :3] = rot(0, rng.uniform(-3, 3)) @ rot(1, rng.uniform(-3, 3))
        obj_T[o, :3, 3] = rng.uniform(-120, 120, 3) * [1, 1, 0.3] + [0, 0, 600]
        ch = rng.choice(K, 16, replace=False)
        valid_kp[o, ch] = True
        model_kp[o, ch] = rng.uniform(-50, 50, (16, 3))
    cam_T = np.tile(np.eye(4), (V, 1, 1))
    for v in range(n_views):
        a = 0.2 * v / max(n_views - 1, 1)
        c = np.array([0, 0, 600.0])
        cam_T[v, :3, :3] = rot(1, a)
        cam_T[v, :3, 3] = c - rot(1, a) @ c + rng.normal(size=3)
    uv = np.zeros((V, O, K, 2))
    valid = np.zeros((V, O, K), bool)
    for v in range(n_views):
        for o in range(n_objs):
            p = (cam_T[v] @ obj_T[o])[:3, :3] @ model_kp[o].T + (cam_T[v] @ obj_T[o])[:3, 3:]
            uv[v, o] = 2.0 * (p[:2] / p[2]).T + rng.normal(scale=0.003, size=(K, 2))
            valid[v, o] = valid_kp[o]
    out = rng.uniform(size=(V, O, K)) < 0.05
    uv[out] += rng.uniform(-0.3, 0.3, size=(int(out.sum()), 2))
    cam_T[1:n_views, :3, 3] += rng.normal(scale=1.0, size=(n_views - 1, 3))
    obj_T[:n_objs, :3, 3] += rng.normal(scale=2.0, size=(n_objs, 3))
    cam_active = np.zeros(V, bool)
    cam_active[:n_views] = True
    obj_active = np.zeros(O, bool)
    obj_active[:n_objs] = True
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    cam_k = np.zeros((V, O, 4))
    cam_k[..., :2] = 2.0
    return dict(cam_T=f32(cam_T), obj_T=f32(obj_T), uv=f32(uv),
                info=f32(np.broadcast_to(np.eye(2) * 1e4, (V, O, K, 2, 2))),
                model_kp=f32(model_kp), cam_k=f32(cam_k), valid=valid, inliers=valid.copy(),
                cam_active=cam_active, obj_active=obj_active)


def _steps(r, p):
    """The f64 left steps log(T_out T_in^-1) of a BA result's cameras and
    objects against its problem's poses."""
    from suo_slam_tpu_torch.core import lie

    d = lambda a, b: lie.se3_log(a.double() @ lie.invert_SE3(b.double()))
    return d(r.cam_T, p.cam_T), d(r.obj_T, p.obj_T)


def lm_bound(p, iters, tracking):
    """K14's bound for one call on problem p that ran `iters` LM iterations
    per round: each input read once and each output written once, against
    the f32 operations of this run's iterations, rounds and classifications.
    Per edge and iteration: ~130 for the projection, chi2, Huber weight,
    Jacobian and weighted rows, 4 per H / g sum (27 tracking, 90 global),
    ~45 for the trial chi2; the Schur solve as K7 counts it (its 6x6
    factors, column solves, reduction to S, S's factor and back-substitution);
    ~45 per edge for each classification."""
    V, O, K = p.valid.shape
    E, R = V * O * K, len(iters)
    n_it, n_rnd = sum(iters), sum(1 for i in iters if i > 0)
    n_o = 0 if tracking else 6 * O
    solve = V * (300 + (n_o + 1) * 80) + (n_o * n_o + n_o) * V * 12 + n_o ** 3 // 3 \
        + 2 * n_o * n_o + V * (12 * n_o + 80) + (V + O) * 150
    per_it = E * (130 + 4 * (27 if tracking else 90) + 45) + solve
    flops = n_it * per_it + (n_rnd + 2) * E * 45 + n_rnd * (V + O) * 100
    in_bytes = V * 64 + O * 64 + E * (8 + 16 + 1) + O * K * 12 + V * O * 16 + 2 * (V + O)
    out_bytes = V * 64 + O * 64 + E + 8 * (1 + R) + 4
    return bound(in_bytes + out_bytes, flops)


def k14_first_step(p, design="cluster"):
    """One iteration of one round of K14 (`design`) on problem p (objects
    free, every valid edge an inlier to start with, the first camera the
    gauge) against one eager iteration with K4 + K7 from the same damping
    1e-5, each step (the f64 log of T_out T_in^-1) measured against the f64
    step of the plain schedule on the CPU in units of its 6-block's largest
    |entry|. Raises unless K14's error is at most twice K4 + K7's (or 1e-4:
    K7's gate at this damping, where the f32 step of a single-view problem
    moves by ~3e-4 of its scale under another summation order), the inlier
    masks are equal and each ran one iteration. Returns K14's error."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    one = dict(iters_per_round=(1,), tracking_only=False, fix_first_cam=True,
               init_with_outliers=True)
    rk, itk = ba._ba_lm_cuda(p, design=design, **one)
    re, ite = ba._optimize_eager(p, use_kernels=True, **one)
    torch.cuda.synchronize()
    p64 = ba.BAProblem(*[None if a is None else a.cpu().double() if a.is_floating_point()
                         else a.cpu() for a in p])
    s64 = _steps(ba._optimize_eager(p64, **one)[0], p64)
    sk, se = _steps(rk, p), _steps(re, p)
    s64 = tuple(a.to(sk[0].device) for a in s64)
    ek, ee = max(k7_scaled_errors(sk, s64)), max(k7_scaled_errors(se, s64))
    same = torch.equal(rk.inliers, re.inliers)
    log(f"[kernel] K14 ({design} design) one iteration (V={p.uv.shape[0]}): scaled step errors "
        f"against the f64 step K14 {ek:.3e}, eager K4 + K7 {ee:.3e} (gate: K14 <= max(2 x K4 + "
        f"K7, 1e-4)); K14 against K4 + K7 {max(k7_scaled_errors(sk, se)):.3e}; max |d_obj| "
        f"{s64[1].abs().max().item():.3e}; inliers equal {same}; iterations {itk.tolist()} / "
        f"{ite}")
    if not (ek <= max(2 * ee, 1e-4) and same and itk.tolist() == [1] and ite == [1]
            and s64[1].abs().max().item() > 0):
        raise AssertionError(f"K14 ({design})'s first iteration disagrees with K4 + K7: {ek} vs "
                             f"{ee}, {same}")
    return ek


def lm_kernel_name(design, tracking):
    """The profiler's name of the K14 kernel a design launches."""
    if design == "block":
        return "ba_lm_kernel"
    return "ba_lm_track_kernel" if tracking else "ba_lm_cluster_kernel"


def _arrays_of(p):
    return {k: v.cpu().numpy() for k, v in p._asdict().items() if v is not None}


def k14_capture_check(p, kw):
    """K14 (the cluster design) through `ba.optimize` on problem p: one
    kernel node per call in a CUDA graph, and a captured call replayed
    equal bit for bit to the eager call (it allocates nothing and reads
    no host value)."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    per_call = launches_per_call(lambda: ba.optimize(p, **kw))
    eager = ba.optimize(p, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ba.optimize(p, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        cap = ba.optimize(p, **kw)
    g.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(eager, cap))
    g.reset()
    return per_call, same


def check_k14(dev, rng, objs):
    """K14, the whole LM schedule in one launch, both designs: the cluster
    design (the main path) and the earlier one-block design. Gates:
    `k14_first_step` of each on the engine's single-view problem (V = 16,
    objects 5 mm off), then `compare_ba` on five problems — tracking (V = 1,
    every object fixed, the camera 0.3 mm off, rounds (10, 10, 10, 10)),
    single view (V = 16, one active view, the engine's single-view rounds),
    and the global pose graphs V = 32 / O = 8, V = 64 / O = 8 and V = 128 /
    O = 16 (`lm_arrays`) — each design against the eager schedules and f64,
    the cluster design repeating bit for bit; one kernel node per
    `optimize` in a CUDA graph and a captured call equal to the eager one.
    Prints each design's device time per call and per iteration and its
    SM cycles by phase. Timed for the kernels line on the tracking problem:
    K14, the eager schedule with its plain versions (plain ms) and with K4
    + K7 (the schedule K14 replaced)."""
    from suo_slam_tpu_torch.solvers import ba

    p1 = _ba_problem(dev, rng, objs)
    errs = {d: k14_first_step(p1, design=d) for d in ba.LM_DESIGNS}
    err = errs["cluster"]
    pt = _ba_problem(dev, rng, objs, V=1, obj_noise=0.0, cam_noise=0.3)
    # the single-view BA as the engine runs it: objects from PnP, inside the
    # chi2 inlier basin (0.2 mm off), the engine's single-view rounds
    ps = _ba_problem(dev, rng, objs, obj_noise=0.2)
    single = dict(iters_per_round=(10, 10, 10, 10))
    problems = [("tracking V=1 O=8", _arrays_of(pt), TRACKING),
                ("single view V=16 O=8", _arrays_of(ps), single)]
    for V, O, nv, no in ((32, 8, 22, 8), (64, 8, 44, 8), (128, 16, 70, 12)):
        problems.append((f"global V={V} O={O}", lm_arrays(V, O, nv, no, seed=V + O), {}))
    summary = {}
    for label, arrays, kw in problems:
        summary[label] = compare_ba(label, arrays, dev,
                                    (arrays["cam_active"], arrays["obj_active"]), **kw)
    for label, res in summary.items():
        c, b = res["cluster"], res["block"]
        log(f"[kernel] K14 {label}: cluster design {c['us']:.3f} us per call, "
            f"{c['us_it']:.3f} per iteration ({sum(c['iters'])} iterations); block design "
            f"{b['us']:.3f} us, {b['us_it']:.3f} per iteration ({sum(b['iters'])}); per "
            f"iteration {b['us_it'] / c['us_it']:.2f}x")
    for label, p, kw in (("tracking V=1", pt, TRACKING), ("single view V=16", ps, single)):
        per_call, same = k14_capture_check(p, kw)
        log(f"[kernel] K14 {label}: {per_call:g} kernel nodes per optimize in a CUDA graph; "
            f"a captured call replays equal to the eager call: {same}")
        if per_call != 1 or not same:
            raise AssertionError(f"K14 {label}: {per_call} kernels per call, replay equal {same}")
    trk = TRACKING
    it_t = summary["tracking V=1 O=8"]["cluster"]["iters"]
    us = summary["tracking V=1 O=8"]["cluster"]["us"]
    ms = cuda_ms(lambda: ba._ba_lm_cuda(pt, **trk))
    plain_ms = cuda_ms(lambda: ba._optimize_eager(pt, **trk), n=3, inner=2, warmup=1)
    eager_ms = cuda_ms(lambda: ba._optimize_eager(pt, use_kernels=True, **trk), n=3, inner=2,
                       warmup=1)
    b = lm_bound(pt, it_t, True)
    _report(f"K14 ba_lm (tracking V=1, iterations {it_t}, device {us:.3f} us, "
            f"{us / max(1, sum(it_t)):.3f} us per iteration; the eager K4 + K7 schedule "
            f"{eager_ms:.4f} ms; first-step errors by design {json.dumps(errs)})", err,
            "2x K4 + K7's scaled step error (one iteration)", ms, plain_ms, None, b)
    return dict(name="ba_lm", route="cuda", source="suo_slam_tpu_torch/csrc/ba_lm.cu",
                replaces="suo_slam_tpu/solvers/ba.py:456", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def pnp_inputs(dev, rng, O=N_OBJ, N=NK, n_hyp=64, draws=False):
    """A PnP batch at the front end's shapes: O objects of N model points in
    a 100 mm cube 700-900 mm away, their normalized image points with
    N(0, 3e-4) noise (~0.3 px, the NDC noise of the SLAM phase), 80% valid,
    5 gross outliers each (0.02-0.1 off; N // 2 below 10 points); object O-2
    has 3 valid points (none below 13 points) and
    object O-1 every point at one place (every hypothesis fails).
    Returns x, y, mask and the sampler's idx on dev (with `draws`, the
    `pnp.Draws` those indices rank: the same generator and draw)."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    x = rng.uniform(-50, 50, (O, N, 3))
    y = np.zeros((O, N, 2))
    for o in range(O):
        p = x[o] @ random_rotation(rng).T + [rng.uniform(-200, 200), rng.uniform(-150, 150),
                                             rng.uniform(700, 900)]
        y[o] = p[:, :2] / p[:, 2:] + rng.normal(scale=3e-4, size=(N, 2))
    k = min(5, N // 2)
    y[:, :k] += rng.uniform(0.02, 0.1, (O, k, 2)) * rng.choice([-1, 1], (O, k, 2))
    mask = rng.uniform(size=(O, N)) < 0.8
    mask[O - 2] = False
    mask[O - 2, 10:13] = True
    x[O - 1] = x[O - 1, :1]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    mk = t(mask, torch.bool)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    sample = pnp.sample_draws if draws else pnp.sample_hypothesis_indices
    return t(x), t(y), mk, sample(mk, n_hyp, gen)


def backup_inputs(dev, rng, draws=False):
    """The backup camera pose's PnP (`engine._backup_estimate_camera_pose`):
    one set of 8 mapped object centres (+-300 mm, the camera 1 m away), their
    bbox centroids with N(0, 3e-4) noise, one 0.05 off, 128 hypotheses (as
    indices, or with `draws` the `pnp.Draws` they rank)."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    x = np.concatenate([rng.uniform(-300, 300, (8, 2)), rng.uniform(-100, 100, (8, 1))], -1)
    p = x @ random_rotation(rng).T + [30.0, -40.0, 1000.0]
    y = p[:, :2] / p[:, 2:] + rng.normal(scale=3e-4, size=(8, 2))
    y[6] += 0.05
    t = lambda a: torch.from_numpy(a[None].astype(np.float32)).to(dev)
    mask = torch.ones((1, 8), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    sample = pnp.sample_draws if draws else pnp.sample_hypothesis_indices
    return t(x), t(y), mask, sample(mask, pnp.DEFAULT_HYPOTHESES, gen)


def k15_gate(label, x, y, mask, idx, refine=True):
    """K15 against `pnp_ransac_batch_plain` on the same CUDA inputs. The
    outcome, not the bits (their sums run in other orders, so the accept
    test, the reselection and the keep gate can flip at their edges):
    success equal; poses within 1e-4 (rotation absolute, translation
    relative to its norm, at least 1); inlier masks equal except points
    whose squared error under the plain pose lies within 1e-3 relative of
    the threshold, each printed with its margin; each count that of its own
    mask. Returns (the pose error, the flipped points)."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    rk = pnp._pnp_ransac_cuda(x, y, mask, idx, refine=refine)
    rp = pnp.pnp_ransac_batch_plain(x, y, mask, idx, refine=refine)
    torch.cuda.synchronize()
    thr = pnp.DEFAULT_THRESHOLD ** 2
    err_p, _ = pnp._reproj_sq_err(rp.T, x, y)
    margin = ((err_p - thr).abs() / thr).cpu()
    flips = (rk.inliers != rp.inliers).nonzero().tolist()
    margins = [float(margin[tuple(f)]) for f in flips]
    Tk, Tp = rk.T.double().cpu(), rp.T.double().cpu()
    rot = (Tk[:, :3, :3] - Tp[:, :3, :3]).abs().max().item()
    tn = Tp[:, :3, 3].norm(dim=-1).clamp(min=1.0)
    rel = ((Tk[:, :3, 3] - Tp[:, :3, 3]).abs().amax(-1) / tn).max().item()
    own = torch.equal(rk.num_inliers, rk.inliers.sum(-1)) and rk.num_inliers.dtype == torch.int64
    log(f"[kernel] {label}: success {rk.success.int().tolist()} (plain "
        f"{rp.success.int().tolist()}), inliers {rk.num_inliers.tolist()} (plain "
        f"{rp.num_inliers.tolist()}); pose error rotation {rot:.3e}, translation {rel:.3e} "
        f"relative (tol 1e-4); {len(flips)} flipped inlier points (o, n) {flips[:8]} with "
        f"margins {[round(m, 6) for m in margins[:8]]} (allowed <= 1e-3)")
    if not (torch.equal(rk.success, rp.success) and max(rot, rel) <= 1e-4 and own
            and all(m <= 1e-3 for m in margins)):
        raise AssertionError(f"{label}: K15 disagrees with its plain version")
    return max(rot, rel), flips


def k15_clocks(label, x, y, mask, idx, **kw):
    """K15's SM clock cycles per phase (`pnp.PNP_PHASES`, thread 0 of each
    block) on one call after a warm one: the slowest block's row and the
    mean over the blocks. Returns the slowest row."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    cyc = torch.zeros((mask.shape[0], len(pnp.PNP_PHASES)), dtype=torch.int64, device=x.device)
    for _ in range(2):
        pnp._pnp_ransac_cuda(x, y, mask, idx, cycles=cyc, **kw)
    rows = cyc.cpu()
    slow = rows[int(rows.sum(1).argmax())].tolist()
    mean = rows.double().mean(0).tolist()
    log(f"[kernel] {label}: SM cycles by phase, slowest block "
        + json.dumps(dict(zip(pnp.PNP_PHASES, slow))) + f" ({sum(slow)} in all), mean over "
        f"{rows.shape[0]} blocks " + json.dumps({k: round(v) for k, v in zip(pnp.PNP_PHASES, mean)}))
    return slow


def k15_bound(O, N, H, n_refined, draws=False):
    """K15's bound for one call: each input read once (x, y, mask, the int64
    indices or, with `draws`, the f32 draws, ranked at ~4 comparisons a
    value), each output written once, against the f32 operations this
    run's data needs: every hypothesis as K3 counts it (~2,800 for P3P /
    P4P, ~18 per point of counting), the preconditioning (~12 per point),
    and for each of the n_refined objects that refine 2 rounds of a
    reselection (~25 per point) and 8 Gauss-Newton iterations (~194 per
    point: projection, Jacobian, 27 weighted H / g sums, the cost and the
    trial cost; ~400 for the 6x6 solve and the exponential), the keep
    gate's count, then the final pass (~25 per point)."""
    flops = (O * H * (2800 + 18 * N + (4 * N if draws else 0)) + O * N * (12 + 25)
             + n_refined * (2 * (25 * N + 8 * (194 * N + 400)) + 25 * N))
    nbytes = O * N * (12 + 8 + 1) + O * H * (N * 4 if draws else 4 * 8) + O * (64 + N + 8 + 1)
    return bound(nbytes, flops)


def k15_draws_equal(label, x, y, mask, d):
    """K15's draws mode against K15 on K22's indices of the same draws:
    pose bits, inliers, counts and success equal, with and without
    refinement (the same hypotheses, so the same arithmetic)."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    idx = pnp._hypothesis_indices_cuda(d.u, mask)
    for refine in (True, False):
        rd = pnp._pnp_ransac_cuda(x, y, mask, d, refine=refine)
        ri = pnp._pnp_ransac_cuda(x, y, mask, idx, refine=refine)
        torch.cuda.synchronize()
        same = [torch.equal(rd.T.view(torch.int32), ri.T.view(torch.int32)),
                torch.equal(rd.inliers, ri.inliers), torch.equal(rd.num_inliers, ri.num_inliers),
                torch.equal(rd.success, ri.success)]
        log(f"[kernel] K15 draws mode ({label}, refine {refine}): pose bits, inliers, counts, "
            f"success equal to K15 on K22's indices: {same}; success {rd.success.int().tolist()}")
        if not all(same):
            raise AssertionError(f"K15 draws mode ({label}) differs from K15 on K22's indices")
    return idx


def check_k15(dev, rng):
    """K15, the whole of `pnp_ransac_batch` in one launch, under `k15_gate`
    at the front end's shapes (with and without refinement) and the backup
    pose's; its draws mode (the main path's: the sampler's `torch.rand`
    ranked in the kernel) bit-equal to K15 on K22's indices of the same
    draws at both shapes; timed against the schedule it replaced (K3 + the
    eager tail) and the plain version on the card, with its device time per
    call in both modes; the earlier serial design beside it (device time,
    SM cycles by phase at both shapes, the draws mode's with its rank
    phase); ptxas's lines for both kernels."""
    from suo_slam_tpu_torch.solvers import pnp

    x, y, mask, d = pnp_inputs(dev, rng, draws=True)
    idx = k15_draws_equal("front end", x, y, mask, d)
    O, N = mask.shape
    H = idx.shape[1]
    bx, by, bmask, bd = backup_inputs(dev, rng, draws=True)
    backup = (bx, by, bmask, k15_draws_equal("backup pose", bx, by, bmask, bd))
    errs = [k15_gate(f"K15 (O={O}, N={N}, n_hyp={H})", x, y, mask, idx)[0],
            k15_gate("K15 without refinement", x, y, mask, idx, refine=False)[0],
            k15_gate("K15 backup pose (O=1, N=8, n_hyp=128)", *backup)[0]]
    for serial in (False, True):
        design = "serial design" if serial else "current design"
        k15_clocks(f"K15 {design} (O={O}, N={N}, n_hyp={H})", x, y, mask, idx, serial=serial)
        k15_clocks(f"K15 {design}, backup pose", *backup, serial=serial)
    k15_clocks(f"K15 draws mode (O={O}, N={N}, n_hyp={H})", x, y, mask, d)
    k15_clocks("K15 draws mode, backup pose", bx, by, bmask, bd)
    log(f"[build] K15 ptxas: {json.dumps(ptxas_kernels('pnp_ransac', ['pnp_ransac_kernelILb0', 'pnp_ransac_kernelILb1', 'pnp_ransac_serial_kernel']))}")
    log(f"[build] K3 ptxas: {json.dumps(ptxas_kernels('pnp_hypotheses', ['pnp_hypotheses_kernel']))}")
    n_ref = int(pnp._pnp_ransac_cuda(x, y, mask, idx).success.sum())
    ms = cuda_ms(lambda: pnp._pnp_ransac_cuda(x, y, mask, idx))
    eager = lambda: pnp.pnp_ransac_batch_plain(x, y, mask, idx, use_kernels=True)
    eager_ms = cuda_ms(eager, n=3, inner=2, warmup=1)
    plain_ms = cuda_ms(lambda: pnp.pnp_ransac_batch_plain(x, y, mask, idx), n=3, inner=2,
                       warmup=1)
    us, src = device_us(lambda: pnp._pnp_ransac_cuda(x, y, mask, idx), "pnp_ransac_kernel")
    dus, dsrc = device_us(lambda: pnp._pnp_ransac_cuda(x, y, mask, d), "pnp_ransac_kernel")
    d_ms = cuda_ms(lambda: pnp._pnp_ransac_cuda(x, y, mask, d))
    bius, _ = device_us(lambda: pnp._pnp_ransac_cuda(*backup), "pnp_ransac_kernel")
    bdus, _ = device_us(lambda: pnp._pnp_ransac_cuda(bx, by, bmask, bd), "pnp_ransac_kernel")
    log(f"[kernel] K15 draws mode device us per call: front end {dus:.3f} by {dsrc} against "
        f"{us:.3f} on indices (+{dus - us:.3f}; target <= +{TARGET_US['K15 draws over idx']}), "
        f"call {d_ms:.4f} ms; backup pose {bdus:.3f} against {bius:.3f} (+{bdus - bius:.3f}); "
        f"what it replaced: K22 + K15 on indices")
    sus, ssrc = device_us(lambda: pnp._pnp_ransac_cuda(x, y, mask, idx, serial=True),
                          "pnp_ransac_serial_kernel")
    eus, esrc = lib_device_us(eager, n=2)
    log(f"[kernel] K15 device us per call (O={O}, N={N}, n_hyp={H}): current design {us:.3f} by "
        f"{src}, serial design {sus:.3f} by {ssrc}; target <= {TARGET_US['K15 phase 3']}; the "
        f"earlier kernel on an H100 80GB HBM3, 700 W: {EARLIER_US['K15 phase 3']}")
    b = k15_bound(O, N, H, n_ref)
    _report(f"K15 pnp_ransac (O={O}, N={N}, n_hyp={H}, {n_ref} refined; device {us:.3f} us by "
            f"{src}; the K3 + eager-tail schedule {eager_ms:.4f} ms, device {eus:.3f} us by "
            f"{esrc})", max(errs), "1e-4 (pose; inliers equal but at the threshold's edge)",
            ms, plain_ms, None, b)
    # the main path's call: the draws mode, against the plain version that ranks them too
    d_plain_ms = cuda_ms(lambda: pnp.pnp_ransac_batch_plain(x, y, mask, d), n=3, inner=2,
                         warmup=1)
    bd_ = k15_bound(O, N, H, n_ref, draws=True)
    _report(f"K15 pnp_ransac, draws mode (O={O}, N={N}, n_hyp={H}; device {dus:.3f} us by "
            f"{dsrc})", max(errs), "bit-equal to K15 on K22's indices; 1e-4 against the plain "
            f"version", d_ms, d_plain_ms, None, bd_)
    return dict(name="pnp_ransac", route="cuda", source="suo_slam_tpu_torch/csrc/pnp_ransac.cu",
                replaces="suo_slam_tpu/solvers/pnp.py:200", max_abs_err=max(errs), ms=d_ms,
                plain_ms=d_plain_ms, bound_ms=bd_[0], bound_by=bd_[1], library_ms=None)


def k22_inputs(dev, rng, O, H, N, p_valid=0.8):
    """K22's inputs at a main-path shape: the sampler's uniform draws
    u [O, H, N] (`torch.rand` on the card) and a mask of p_valid valid
    points; with O > 1, object 1 has 2 valid points (its rows end in
    exhausted picks)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    u = torch.rand((O, H, N), generator=gen, device=dev)
    mask = torch.from_numpy(rng.uniform(size=(O, N)) < p_valid).to(dev)
    if O > 1:
        mask[1] = False
        mask[1, [5, 17]] = True
    return u, mask


def check_k22(dev, rng):
    """K22, the PnP sampler's top-4 (B14; off the main path since K15 ranks
    the draws itself), against its plain version on the same CUDA draws and
    mask, for exact equality, at the front end's shape [8, 64, 41] (80%
    valid, a row with 2 valid points) and the backup pose's [1, 128, 328];
    its call, device time, the plain version, the index sampler's whole
    call (`torch.rand` + K22), the engine's sampler (`torch.rand` alone) and
    `torch.topk` on the masked draws (the library yardstick: the same picks
    up to ties, timed only)."""
    import torch

    from suo_slam_tpu_torch.slam.engine import TorchGumbelSampler
    from suo_slam_tpu_torch.solvers import pnp

    res = {}
    for label, (O, H, N) in (("front end", (N_OBJ, 64, NK)), ("backup pose", (1, 128, 8 * NK))):
        u, mask = k22_inputs(dev, rng, O, H, N)
        k = pnp._hypothesis_indices_cuda(u, mask)
        p = pnp.hypothesis_indices_plain(u, mask)
        torch.cuda.synchronize()
        diff = int((k != p).sum())
        log(f"[kernel] K22 {label} [{O}, {H}, {N}]: {diff} of {k.numel()} indices differ from "
            f"the plain version (exact); exhausted picks {int((k == 0).sum())}")
        if diff or k.dtype != torch.int64:
            raise AssertionError(f"K22 {label}: {diff} indices differ from the plain version")
        ms = cuda_ms(lambda: pnp._hypothesis_indices_cuda(u, mask))
        plain_ms = cuda_ms(lambda: pnp.hypothesis_indices_plain(u, mask))
        lib = lambda: torch.topk(u.masked_fill(~mask[:, None, :], -torch.inf), 4, dim=-1)
        lib_ms = cuda_ms(lib)
        us, src = device_us(lambda: pnp._hypothesis_indices_cuda(u, mask), "pnp_sample_kernel")
        sampler = TorchGumbelSampler(0, dev)
        call_ms = cuda_ms(lambda: pnp.sample_hypothesis_indices(mask, H, sampler.gen))
        draws_ms = cuda_ms(lambda: sampler(mask, H))
        # each input read once (u f32, the mask), the int64 indices written
        # once; a few comparisons per value and round
        b = bound(O * H * N * 4 + O * N + O * H * 4 * 8, O * H * N * 4 * 2)
        _report(f"K22 pnp_sample ({label} [{O}, {H}, {N}]; device {us:.3f} us by {src}; the "
                f"index sampler's call, torch.rand + K22, {call_ms:.4f} ms; the engine's "
                f"sampler, torch.rand alone (its draws go to K15), {draws_ms:.4f} ms)", 0.0,
                "exact", ms, plain_ms, lib_ms, b, lib_fn=lib)
        res[label] = (ms, plain_ms, lib_ms, b)
    ms, plain_ms, lib_ms, b = res["front end"]
    return dict(name="pnp_sample", route="cuda", source="suo_slam_tpu_torch/csrc/pnp_sample.cu",
                replaces="suo_slam_tpu/solvers/pnp.py:171", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


class PlainSamplerCalls:
    """Counts the calls of the sampler's plain ranking
    (`pnp.hypothesis_indices_plain`) on CUDA tensors while installed: on the
    card the main path's draws are ranked inside K15 (and an index sampler's
    by K22), never by the plain version."""

    def __init__(self):
        from suo_slam_tpu_torch.solvers import pnp

        self.pnp, self.fn, self.n = pnp, pnp.hypothesis_indices_plain, 0

    def __enter__(self):
        def spy(u, mask):
            self.n += int(u.device.type == "cuda")
            return self.fn(u, mask)

        self.pnp.hypothesis_indices_plain = spy
        return self

    def __exit__(self, *exc):
        self.pnp.hypothesis_indices_plain = self.fn


class K6Calls:
    """Counts the calls of `slam.kernels.camera_ransac` (the front end's
    camera RANSAC) and `reinit_votes` (the tail's re-init vote) while
    installed: on the card each is one K6 launch."""

    NAMES = ("camera_ransac", "reinit_votes")

    def __init__(self):
        from suo_slam_tpu_torch.slam import kernels as sk

        self.sk, self.fns, self.n = sk, {k: getattr(sk, k) for k in self.NAMES}, {}

    def __enter__(self):
        for k, f in self.fns.items():
            self.n[k] = 0

            def spy(*a, _k=k, _f=f, **kw):
                self.n[_k] += 1
                return _f(*a, **kw)

            setattr(self.sk, k, spy)
        return self

    def __exit__(self, *exc):
        for k, f in self.fns.items():
            setattr(self.sk, k, f)


class SyncChecked:
    """While installed, the frame's two dispatch chains —
    `slam.kernels.frontend_step` (each group's front end, camera RANSAC
    included) and `tracking_tail` — run under
    `torch.cuda.set_sync_debug_mode("error")`: a host sync inside either
    raises. The engine's two read-backs follow the chains' returns, outside.
    Counts the chains it checked."""

    NAMES = ("frontend_step", "tracking_tail")

    def __init__(self):
        from suo_slam_tpu_torch.slam import kernels as sk

        self.sk, self.fns, self.n = sk, {k: getattr(sk, k) for k in self.NAMES}, 0

    def __enter__(self):
        import torch

        for k, f in self.fns.items():
            def checked(*a, _f=f, **kw):
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return _f(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                    self.n += 1

            setattr(self.sk, k, checked)
        return self

    def __exit__(self, *exc):
        for k, f in self.fns.items():
            setattr(self.sk, k, f)


class PnpCalls:
    """Counts the calls of `pnp.pnp_ransac_batch` (the front ends' and,
    through `pnp_ransac`, the backup pose's) while installed."""

    def __init__(self):
        from suo_slam_tpu_torch.solvers import pnp

        self.pnp, self.fn, self.n = pnp, pnp.pnp_ransac_batch, 0

    def __enter__(self):
        def spy(*a, **kw):
            self.n += 1
            return self.fn(*a, **kw)

        self.pnp.pnp_ransac_batch = spy
        return self

    def __exit__(self, *exc):
        self.pnp.pnp_ransac_batch = self.fn


def k15_frame_probe(run_frame, first, net, dev, n_frames=4, reps=5):
    """K15 in the SLAM frame against K15 alone, to find what the frame adds
    to the draws mode. (1) `run_frame(first + i)` for n_frames more frames
    with K15's SM clock cycles by phase (`pnp.PNP_PHASES`, the slowest
    block) on every launch, into buffers made before the frames; the last
    frame's inputs kept. (2) Each kept call replayed in the draws mode and
    on K22's indices of the same draws, under four conditions: "warm" (just
    after the same call), "after the net" (the frame's network forward
    first, as in the frame; K22 then runs after it, as in the parent's
    frame), "code warm" (the forward, then one call on the call's first
    object: the same kernel, plan and mode, one block) and "data warm" (the
    forward, then a read of every input). Each: the median over `reps` of
    the slowest block's cycles by phase, and device us per launch where K15
    is the condition's only launch. (3) The host time of dispatching the
    sampler and the PnP call in both modes (K22 + K15 on indices against
    K15 on the draws), without a sync. Logs; returns nothing."""
    import torch

    from suo_slam_tpu_torch.solvers import pnp

    P = len(pnp.PNP_PHASES)
    pool = torch.zeros((8 * n_frames, 64, P), dtype=torch.int64, device=dev)
    real, seen = pnp._pnp_ransac_cuda, []

    def spy(x, y, mask, hyp, *a, **kw):
        cyc = pool[len(seen), :mask.shape[0]]
        seen.append(((x, y, mask, hyp), cyc))
        return real(x, y, mask, hyp, *a, cycles=cyc, **kw)

    pnp._pnp_ransac_cuda = spy
    try:
        per_frame = []
        for i in range(n_frames):
            n0 = len(seen)
            run_frame(first + i)
            per_frame.append(len(seen) - n0)
    finally:
        pnp._pnp_ransac_cuda = real
    torch.cuda.synchronize()
    slowest = lambda c: c[int(c.sum(1).argmax())].tolist()
    med = lambda rows: [int(statistics.median(r[k] for r in rows)) for k in range(P)]
    names = lambda row: json.dumps(dict(zip(pnp.PNP_PHASES, row))) + f" ({sum(row)} in all)"
    by_shape = {}
    for (_, _, _, hyp), cyc in seen:
        shape = tuple((hyp.u if isinstance(hyp, pnp.Draws) else hyp).shape)
        by_shape.setdefault(shape, []).append(slowest(cyc.cpu()))
    for shape, rows in by_shape.items():
        log(f"[k15-frame] in the frame, K15 {list(shape)} ({len(rows)} launches over "
            f"{n_frames} frames, {per_frame} a frame): SM cycles by phase, the slowest block, "
            f"median " + names(med(rows)))
    crops = torch.rand((N_OBJ, 256, 256, 3), device=dev)
    kept = [args for args, _ in seen[len(seen) - per_frame[-1]:]]

    def forward():
        with torch.inference_mode():
            net(crops, None)

    for x, y, mask, d in kept:
        if not isinstance(d, pnp.Draws):
            raise AssertionError("the SLAM frame's K15 ran on indices, not the sampler's draws")
        idx = pnp._hypothesis_indices_cuda(d.u, mask)
        ins = (x, y, mask, d.u)
        O, H, N = d.u.shape
        cyc = torch.zeros((O, P), dtype=torch.int64, device=dev)
        cyc1 = torch.zeros((1, P), dtype=torch.int64, device=dev)
        for mode in ("draws", "indices"):
            hyp = d if mode == "draws" else idx
            one = pnp.Draws(d.u[:1]) if mode == "draws" else idx[:1]

            def k22(mode=mode):  # the parent's frame ran K22 between the net and K15
                if mode == "indices":
                    pnp._hypothesis_indices_cuda(d.u, mask)

            preludes = {
                "warm": lambda: real(x, y, mask, hyp),
                "after the net": lambda: (forward(), k22()),
                "code warm": lambda: (forward(), k22(),
                                      real(x[:1], y[:1], mask[:1], one, cycles=cyc1)),
                "data warm": lambda: (forward(), k22(), [a.sum() for a in ins]),
            }
            for cond, pre in preludes.items():
                rows = []
                for _ in range(reps):
                    cyc.zero_()
                    pre()
                    real(x, y, mask, hyp, cycles=cyc)
                    torch.cuda.synchronize()
                    rows.append(slowest(cyc.cpu()))
                us = ""
                if cond == "warm":  # back to back: every launch is a measured one
                    us = device_us(lambda: real(x, y, mask, hyp), "pnp_ransac_kernel", n=reps)
                elif cond != "code warm":  # the only K15 launch of the condition
                    us = device_us(lambda: (pre(), real(x, y, mask, hyp)), "pnp_ransac_kernel",
                                   n=reps)
                us = f"device {us[0]:.3f} us by {us[1]}; " if us else ""
                log(f"[k15-frame] replayed {mode} [{O}, {H}, {N}], {cond}: {us}SM cycles by "
                    f"phase " + names(med(rows)))
        gen = torch.Generator(device=dev).manual_seed(0)
        ns = host_ns({"draws": lambda: pnp.pnp_ransac_batch(x, y, mask,
                                                            pnp.sample_draws(mask, H, gen)),
                      "indices": lambda: pnp.pnp_ransac_batch(
                          x, y, mask, pnp.sample_hypothesis_indices(mask, H, gen))}, n=200)
        log(f"[k15-frame] host ns a sampler + PnP dispatch [{O}, {H}, {N}]: {json.dumps(ns)} "
            f"(the draws save {ns['indices'] - ns['draws']} ns a call)")


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
    from suo_slam_tpu_torch.solvers import pnp

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
    # the front end (`frontend_step`, read back) and, alone, its sampler (the
    # draws: one `torch.rand`) and its PnP (`pnp_ransac_batch`: K15, which
    # ranks them) on the same inputs; "frontend_rest" is the rest: the
    # keypoint filter, information and the read-back
    keep = sk.filter_keypoints(o.uv, o.cov, o.kp_mask, mm, c.bbox_thresh, c.kp_var_thresh,
                               c.mask_thresh)
    hyp = timed("sampler", lambda: engine._sampler(keep, c.pnp_hypotheses))
    y = (o.uv - k4[:, None, 2:]) / k4[:, None, :2]
    timed("pnp_ransac_batch", lambda: pnp.pnp_ransac_batch(mk, y, keep, hyp))
    fs_args = (o.uv, o.cov, o.kp_mask, mk, mm, k4, diam, engine._sampler, c.manual_kp_std,
               c.bbox_thresh, c.kp_var_thresh, c.mask_thresh, c.pnp_hypotheses)
    timed("frontend_step", lambda: {k: v.cpu() for k, v in sk.frontend_step(*fs_args).items()})
    out["frontend_rest"] = out["frontend_step"] - out["sampler"] - out["pnp_ransac_batch"]
    # the SLAM front end's slots branch (`camera_ransac`, one K6 launch) on
    # this view's rows against a map of their own PnP poses (the camera at
    # the identity), and the tail's re-init vote (`reinit_votes`, one K6
    # launch) at the SLAM window
    f = sk.frontend_step(*fs_args)
    ones = torch.ones((N_OBJ,), dtype=torch.bool, device=dev)
    timed("camera_ransac", lambda: sk.camera_ransac(
        f["T_pnp"], f["pnp_ok"], f["uv"], f["info"], f["keep"], k4,
        torch.arange(N_OBJ, device=dev), f["T_pnp"], ones, mk))
    rargs = reinit_inputs(dev, np.random.default_rng(0), objs)
    timed("reinit", lambda: sk.reinit_votes(*rargs))
    timed("ba", engine.optimize)
    return out


def profile_run(run, per_ms, label):
    """`run()` once more under torch.profiler: the device time of its
    kernels, its share of the unprofiled latency `per_ms`, the number of
    kernels, the PyTorch operations that hold the most device time, and the
    device time per launch of each of the port's kernels (without the host
    time of its wrapper, which `cuda_ms` includes). Returns the trace's key
    averages, or None when the tracer lost the session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from suo_slam_tpu_torch import kernels

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    avg = prof.key_averages()
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms <= 0:  # the tracer lost the session; the run itself is not repeated
        log(f"[profile] {label}: the trace holds no device time (not measured)")
        return None
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms in {sum(e.count for e in kern)} "
        f"kernels = {busy_ms / per_ms:.4f} of the {per_ms:.2f} ms latency "
        f"(profiled wall {wall * 1e3:.2f} ms)")
    log(f"[profile] {label}: device ms and calls by operation: " + json.dumps(
        {e.key: [round(e.self_device_time_total / 1e3, 3), e.count] for e in ops}))
    mine = {}
    for name in kernels.LAUNCHES:  # csrc kernels are named <counter name>_kernel*
        keys = KERNEL_KEYS.get(name, (f"{name}_kernel",))
        es = [e for e in kern if any(k in e.key for k in keys)]
        n = sum(e.count for e in es)
        mine[name] = [round(sum(e.self_device_time_total for e in es) / max(n, 1), 3), n]
    log(f"[profile] {label}: the port's kernels, device us per launch and launches: "
        + json.dumps(mine))
    return avg


def phase_main_path(dev, rng, objs, net, seed, n_views=6):
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    engine = ObjectSlam(SlamConfig(single_view_mode=True), mesh_db=objs, net=net,
                        device=dev)
    views = _views(rng, objs, n_views + 1)
    kernels.reset_counts()
    with PnpCalls() as calls, PlainSamplerCalls() as plain:
        times, results = _drive(engine, objs, views)
    counts = kernels.counts()
    log(f"[main] launches over {len(views)} views: {json.dumps(counts)}; "
        f"{calls.n} pnp_ransac_batch calls; {plain.n} plain sampler calls on the card")
    if plain.n:  # K15 ranks the draws: no K22, no plain ranking
        raise AssertionError(f"{plain.n} plain sampler calls on the card (want none)")
    missing = [k for k in SINGLE_VIEW_KERNELS if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the single-view path: {missing}, or "
                             f"K3 / K4 / K7 / K22 / K13 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    if not counts["pnp_ransac"] == calls.n == len(views):
        raise AssertionError(f"K15: {counts['pnp_ransac']} launches for {calls.n} "
                             f"pnp_ransac_batch calls over {len(views)} views (want one each)")
    per_view_ms = statistics.median(times[1:]) * 1e3
    log(f"[main] per-view latency: median {per_view_ms:.2f} ms over {n_views} views "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    log(f"[main] crops/s at the 8-crop bucket: {N_OBJ / (per_view_ms / 1e3):.1f}")
    st = stage_times(engine, objs, views[-1], dev)
    log("[main] per-stage ms (each stage alone, last view's inputs): "
        + json.dumps({k: round(v, 3) for k, v in st.items()}))
    profile_run(lambda: _drive(engine, objs, [views[-1]])[0][0], per_view_ms, "one view")
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


class SlamScene:
    """The eight objects fixed in the world (the first camera's frame, on a
    4 x 2 grid 0.75-0.85 m away) and a smooth camera orbit around the
    scene's centre: frame i yaws 4 deg x sin(i / 4) and bobs a few mm."""

    def __init__(self, rng, objs: Objects, n_frames):
        self.objs = objs
        self.T_obj = np.tile(np.eye(4), (N_OBJ, 1, 1))
        for o in range(N_OBJ):
            z = rng.uniform(750, 850)
            self.T_obj[o, :3, :3] = random_rotation(rng)
            self.T_obj[o, :3, 3] = [-150 + 100 * (o % 4), -60 + 120 * (o // 4), z]
        c = np.array([0.0, 0.0, 800.0])
        self.cams = np.tile(np.eye(4), (n_frames, 1, 1))
        for i in range(n_frames):
            a = math.radians(4.0) * math.sin(i / 4.0)
            R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                          [-math.sin(a), 0, math.cos(a)]])
            self.cams[i, :3, :3] = R
            self.cams[i, :3, 3] = c - R @ c + [0.0, 5.0 * math.sin(i / 3.0), 0.0]

    def frame(self, i):
        """(T_OtoC [8, 4, 4], bboxes [8, 4], uv_gt [8, 41, 2] NDC) of frame i."""
        T = self.cams[i] @ self.T_obj
        bboxes = np.zeros((N_OBJ, 4), np.float32)
        uv_gt = np.zeros((N_OBJ, NK, 2), np.float32)
        for o in range(N_OBJ):
            p = self.objs.model_kps[o] @ T[o, :3, :3].T + T[o, :3, 3]
            uvw = p @ YCBV_K.T
            uv = uvw[:, :2] / uvw[:, 2:]
            m = self.objs.masks[o]
            x1, y1 = uv[m].min(0) - 10
            x2, y2 = uv[m].max(0) + 10
            if x1 < 0 or y1 < 0 or x2 > W_IMG or y2 > H_IMG:
                raise AssertionError(f"object {o + 1} leaves frame {i}")
            bboxes[o] = (x1, y1, x2, y2)
            uv_gt[o] = np.stack([2 * (uv[:, 0] - x1) / (x2 - x1) - 1,
                                 1 - 2 * (uv[:, 1] - y1) / (y2 - y1)], -1)
        return T, bboxes, uv_gt

    @staticmethod
    def k4(bboxes):
        from suo_slam_tpu_torch.slam.engine import _fix_K_np

        out = np.zeros((len(bboxes), 4), np.float32)
        for o, bb in enumerate(bboxes):
            K = _fix_K_np(YCBV_K, bb)
            out[o] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        return out


class GtPriorInfer:
    """The SLAM path's frame inference: runs the full-width net
    (`make_frame_inference`: K1 crop -> K5 prior render -> PkpNet -> K2
    readout) on every call, then returns, in place of its uv / cov /
    validity, the group's projected ground-truth keypoints + N(0, sigma)
    NDC noise, cov sigma^2 I and validity 1. The group's objects are found
    by their boxes (one small read-back of the boxes per call)."""

    supports_no_prior = True

    def __init__(self, fn, dev, seed, sigma=0.005):
        self.fn = fn
        self.dev = dev
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.last_prior_call = None
        self.n_prior_calls = 0

    def set_frame(self, bboxes, uv_gt):
        self.boxes = bboxes
        self.uv = (uv_gt + self.rng.normal(scale=self.sigma, size=uv_gt.shape)).astype(np.float32)

    def __call__(self, img, boxes, obj_valid, prior_uv, prior_valid, has_prior=True):
        import torch

        bx = boxes.cpu().numpy()
        out = self.fn(img, boxes, obj_valid, prior_uv, prior_valid, has_prior=has_prior)
        if has_prior:
            self.n_prior_calls += 1
            self.last_prior_call = ((img, boxes, obj_valid, prior_uv, prior_valid), out)
        ob = bx.shape[0]
        uv = np.zeros((ob, NK, 2), np.float32)
        for i in range(ob):
            hit = np.flatnonzero(np.all(np.abs(self.boxes - bx[i]) < 1e-3, axis=1))
            if hit.size:
                uv[i] = self.uv[hit[0]]
        cov = np.broadcast_to(np.eye(2, dtype=np.float32) * self.sigma ** 2, (ob, NK, 2, 2))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
        return t(uv), t(cov), t(np.ones((ob, NK), np.float32))


def _tracking_arrays(engine):
    """The tracking BA's problem on the engine's last view row (all objects
    fixed), as numpy arrays."""
    v = engine.view_slot[engine.view_ids[-1]]
    row = lambda a: a[v:v + 1]
    return dict(cam_T=row(engine.cam_T), obj_T=engine.obj_T, uv=row(engine.uv),
                info=row(engine.info), model_kp=engine.model_kp, cam_k=row(engine.cam_k4),
                valid=row(engine.valid), inliers=row(engine.inliers),
                cam_active=np.ones((1,), bool), obj_active=engine.obj_active)


def _ba_problem_of(arrays, device, f64=False):
    import torch

    from suo_slam_tpu_torch.solvers import ba

    return ba.BAProblem(**{k: torch.tensor(
        a.astype(np.float64) if f64 and a.dtype == np.float32 else a, device=device)
        for k, a in arrays.items()})


TRACKING = dict(iters_per_round=(10, 10, 10, 10), tracking_only=True, fix_first_cam=False)


def _tracking_ba_ms(engine, dev, fn, n=5):
    """`fn` (an `optimize`) on the tracking BA problem of the engine's last
    view row, host clock around a synchronized call, median of n."""
    import torch

    problem = _ba_problem_of(_tracking_arrays(engine), dev)
    vals = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn(problem, **TRACKING)
        torch.cuda.synchronize()
        vals.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(vals[1:])


def _add_ok(T_est, T_gt, objs, o):
    m = objs.masks[o]
    p_gt = objs.model_kps[o][m] @ T_gt[:3, :3].T + T_gt[:3, 3]
    p_es = objs.model_kps[o][m] @ T_est[:3, :3].T + T_est[:3, 3]
    return float(np.linalg.norm(p_gt - p_es, axis=-1).mean()) < 0.1 * objs.diameter[o]


def compare_ba(label, arrays, dev, act, designs=None, **kw):
    """One BA problem through each design of K14 (`_ba_lm_cuda`; the
    cluster design is `optimize` on the card), the eager schedule with K4 +
    K7 and with the plain versions on the card, and the plain eager
    schedule in f64 on the CPU. The cluster design (`optimize`'s) against
    the eager plain run: poses within 1e-4 (rotation absolute; translation
    relative to its norm, at least the 800 mm scene depth) and equal inlier
    masks, except edges within 1% of the chi2 threshold, each printed with
    its chi2; and no farther from the f64 result than twice the farther of
    the two eager runs, or 1e-5: f32 LM end states scatter that far around
    the f64 BA under another summation order (an f32 residual uv - pi(.) of
    ~3e-3 NDC keeps ~2e-5 of relative rounding, so the relative-gain exit
    at 1e-6 stops on noise; on the card the eager K4 + K7 run ended 2.1e-6
    from the f64 poses where the eager plain run ended 2.0e-8); and it must
    repeat bit for bit (poses, inliers, counts, iterations). The block
    design's errors and distances are printed beside it. Prints
    each run's host ms and iterations per round (the eager runs leave a
    round's loop at its `done` step) and each design's device time per call
    and per iteration and SM cycles by phase. Returns {design: {ms, iters,
    us, us_it, cycles}}."""
    import torch

    from suo_slam_tpu_torch.solvers import ba

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pk = _ba_problem_of(arrays, dev)
    tracking = bool(kw.get("tracking_only"))
    (re, ite), ms_e = timed(lambda: ba._optimize_eager(pk, use_kernels=True, **kw))
    (rp, itp), ms_p = timed(lambda: ba._optimize_eager(pk, **kw))
    with torch.inference_mode():
        r64, it64 = ba._optimize_eager(_ba_problem_of(arrays, "cpu", f64=True), **kw)
    ca, oa = act

    def gap(r1, r2):
        out = {}
        for name, a, b, m in (("cam", r1.cam_T, r2.cam_T, ca), ("obj", r1.obj_T, r2.obj_T, oa)):
            a = a.cpu().numpy()[m].astype(np.float64)
            b = b.cpu().numpy()[m].astype(np.float64)
            scale = np.maximum(np.linalg.norm(b[:, :3, 3], axis=-1), 800.0)
            rel_t = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) / scale
            out[name] = [float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max(initial=0.0)),
                         float(rel_t.max(initial=0.0))]
        return out

    worst = lambda g: max(max(e) for e in g.values())
    n64 = lambda r: int((r.inliers.cpu() != r64.inliers).sum())
    g_p, g_e = gap(rp, r64), gap(re, r64)
    log(f"[slam] {label}: eager K4 + K7 {ms_e:.2f} ms, eager plain {ms_p:.2f} ms; iterations "
        f"per round eager K4 + K7 {ite}, eager plain {itp}, f64 {it64}; against the f64 BA: "
        f"eager plain {json.dumps(g_p)} and {n64(rp)} edges apart, eager K4 + K7 "
        f"{json.dumps(g_e)}")
    out = {}
    for design in designs or ba.LM_DESIGNS:
        run = lambda: ba._ba_lm_cuda(pk, design=design, **kw)
        first = run()
        (rk, itk), ms_k = timed(run)
        with torch.inference_mode():
            chi2 = ba._edge_chi2_plain(rk.cam_T, rk.obj_T, pk.uv, pk.info, pk.model_kp, pk.cam_k)
        errs, g_k = gap(rk, rp), gap(rk, r64)
        flips = (rk.inliers != rp.inliers).nonzero().tolist()
        fchi2 = [round(float(chi2[tuple(f)]), 4) for f in flips]
        repeat = all(torch.equal(a, b) for a, b in zip(first[0], rk)) and torch.equal(first[1], itk)
        log(f"[slam] {label}: K14 {design} design {ms_k:.2f} ms, iterations per round "
            f"{itk.tolist()}; vs the eager plain run: rotation / relative translation errors "
            f"{json.dumps(errs)} (tol 1e-4); {int(rk.num_inliers)} inliers, {len(flips)} flipped "
            f"edges (v, o, k) {flips[:8]} with chi2 {fchi2[:8]} (threshold 5.991); against the "
            f"f64 BA {json.dumps(g_k)} and {n64(rk)} edges apart; two calls bit-equal {repeat}")
        # the gates hold the main path's design; the earlier design is
        # printed beside it (its end state scatters ~3e-5 around the f64 BA
        # on some problems, as an f32 state does: see `ba_lm.cu`)
        gated = design == "cluster"
        if gated and worst(errs) > 1e-4:
            raise AssertionError(f"{label}: K14 ({design}) disagrees with the eager plain "
                                 f"schedule: {errs}")
        if gated and any(abs(c - ba.CHI2_THRESH_2DOF) > 0.01 * ba.CHI2_THRESH_2DOF
                         for c in fchi2):
            raise AssertionError(f"{label}: K14 ({design}): an edge away from the threshold "
                                 f"flipped: {fchi2}")
        if gated and worst(g_k) > max(2 * worst(g_p), 2 * worst(g_e), 1e-5):
            raise AssertionError(f"{label}: K14 ({design}) is farther from the f64 BA than the "
                                 f"eager runs: {g_k} vs {g_p}, {g_e}")
        if gated and not repeat:
            raise AssertionError(f"{label}: two calls of K14's cluster design differ")
        us, src = device_us(run, lm_kernel_name(design, tracking), n=3)
        cyc = torch.zeros(len(ba.LM_PHASES), dtype=torch.int64, device=dev)
        ba._ba_lm_cuda(pk, design=design, **kw, cycles=cyc)
        cyc = cyc.tolist()
        n_it = sum(itk.tolist())
        b = lm_bound(pk, itk.tolist(), tracking)
        log(f"[slam] {label}: K14 {design} design device {us:.3f} us per call by {src}, "
            f"{us / max(1, n_it):.3f} us per iteration, bound {b[0]:.7f} ms ({b[1]}, this "
            f"call's {n_it} iterations); SM cycles by phase "
            + json.dumps(dict(zip(ba.LM_PHASES, cyc))) + f" ({sum(cyc)} in all)")
        out[design] = dict(ms=ms_k, iters=itk.tolist(), us=us, us_it=us / max(1, n_it),
                           cycles=cyc)
    return out


def compare_global_ba(engine, dev):
    """The SLAM path's global BA problem (V = 32, its poses moved ~0.2 mm
    off the engine's, inside the chi2 inlier basin) through `compare_ba`."""
    rng = np.random.default_rng(9)
    cam_T = engine.cam_T.copy()
    obj_T = engine.obj_T.copy()
    cam_T[1:, :3, 3] += rng.normal(scale=0.2, size=(engine.V - 1, 3)).astype(np.float32)
    obj_T[:, :3, 3] += rng.normal(scale=0.2, size=(engine.O, 3)).astype(np.float32)
    arrays = dict(cam_T=cam_T, obj_T=obj_T, uv=engine.uv, info=engine.info,
                  model_kp=engine.model_kp, cam_k=engine.cam_k4, valid=engine.valid,
                  inliers=engine.inliers, cam_active=engine.cam_active,
                  obj_active=engine.obj_active, cam_frozen=np.zeros(engine.V, bool))
    return compare_ba(f"global BA (V={engine.V}, O={engine.O})", arrays, dev,
                      (engine.cam_active, engine.obj_active))


def compare_tracking_ba(engine, dev):
    """The tracking BA's problem on the engine's last view row, its camera
    moved ~0.2 mm, through `compare_ba`."""
    arrays = _tracking_arrays(engine)
    arrays["cam_T"] = arrays["cam_T"].copy()
    arrays["cam_T"][0, :3, 3] += np.random.default_rng(10).normal(
        scale=0.2, size=3).astype(np.float32)
    return compare_ba("tracking BA (V=1)", arrays, dev,
                      (np.ones((1,), bool), engine.obj_active), **TRACKING)


def phase_slam(dev, rng, objs, net, seed, scene):
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.slam import kernels as sk
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    n_frames = len(scene.cams) - 1  # the last frame is the profiled one
    img = rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    fn = sk.make_frame_inference(net, device=dev)
    inf = GtPriorInfer(fn, dev, seed)
    engine = ObjectSlam(SlamConfig(), mesh_db=objs, infer_fn=inf, device=dev)
    ids = np.arange(1, N_OBJ + 1)

    def frame(i):
        _, bboxes, uv_gt = scene.frame(i)
        inf.set_frame(bboxes, uv_gt)
        t0 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks, objs.masks)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    kernels.reset_counts()
    with PnpCalls() as calls, PlainSamplerCalls() as plain, K6Calls() as k6, \
            SyncChecked() as synced:
        times = [frame(i) for i in range(n_frames)]
    t0 = time.perf_counter()
    results = engine.collect_results(final=True)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    counts = kernels.counts()
    log(f"[slam] launches over {n_frames} frames + the final BA: {json.dumps(counts)}; "
        f"{calls.n} pnp_ransac_batch calls, {json.dumps(k6.n)} camera RANSACs / re-init "
        f"votes; {synced.n} dispatch chains under set_sync_debug_mode('error')")
    if counts["pnp_ransac"] != calls.n or calls.n < 2 * n_frames:
        raise AssertionError(f"K15: {counts['pnp_ransac']} launches for {calls.n} "
                             f"pnp_ransac_batch calls over {n_frames} frames")
    # the sampler's draws go to K15 as they are: no K22, no plain ranking
    if counts["pnp_sample"] or plain.n:
        raise AssertionError(f"K22: {counts['pnp_sample']} launches, {plain.n} plain sampler "
                             f"calls on the card (want none)")
    if counts["chi2_counts"] != sum(k6.n.values()) or min(k6.n.values()) < n_frames // 2:
        raise AssertionError(f"K6: {counts['chi2_counts']} launches for {json.dumps(k6.n)} "
                             f"camera RANSACs / re-init votes (want one each)")
    if synced.n < 2 * n_frames:
        raise AssertionError(f"only {synced.n} dispatch chains ran under the sync check")
    log("[slam] launches per frame: " + json.dumps(
        {k: round(c / n_frames, 2) for k, c in counts.items()}))
    missing = [k for k, c in counts.items() if c == 0 and k != "add_dists"
               and k not in INT8_KERNELS + OFF_PATH_KERNELS + TRAIN_KERNELS + GROUP_KERNELS
               + CROSS_KERNELS]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the SLAM path: {missing}, or K3 / K4 / "
                             f"K7 / K22 / K13 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    n_global = len(engine.opt_times)  # frames 10, 20 and the final collect_results
    log(f"[slam] K14 launches: {counts['ba_lm']} = {counts['ba_lm'] - n_global} tracking BAs "
        f"over {n_frames} frames + {n_global} global BAs; K4 {counts['ba_edges']}, K7 "
        f"{counts['ba_schur']}")
    if engine.V != 32 or len(engine.opt_times) != 3:
        raise AssertionError(f"SLAM path: capacity {engine.V}, {len(engine.opt_times)} global BAs")
    per_frame_ms = statistics.median(times[1:]) * 1e3
    log(f"[slam] per-frame latency: median {per_frame_ms:.2f} ms over {n_frames - 1} frames "
        f"after 1 warm-up (all: {[round(t * 1e3, 2) for t in times]})")
    from suo_slam_tpu_torch.solvers import ba

    eager = lambda p, **kw: ba._optimize_eager(p, use_kernels=True, **kw)
    log(f"[slam] global BA ms (frames 10, 20, final): "
        f"{[round(t * 1e3, 2) for t in engine.opt_times]}; final collect_results "
        f"{final_s * 1e3:.2f} ms; tracking BA alone: K14 "
        f"{_tracking_ba_ms(engine, dev, ba.optimize):.2f} ms, the eager K4 + K7 schedule "
        f"{_tracking_ba_ms(engine, dev, eager):.2f} ms; {inf.n_prior_calls} with-prior "
        f"network calls")
    # the trajectory and the objects against the ground truth
    rot, trans, ok = [], [], []
    for i in range(n_frames):
        T_gt = scene.cams[i]
        Te = engine.cam_T[engine.view_slot[i]].astype(np.float64)
        c = (np.trace(Te[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
        rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
        trans.append(float(np.linalg.norm(Te[:3, 3] - T_gt[:3, 3])))
        T_OtoC, _, _ = scene.frame(i)
        for o in range(N_OBJ):
            p = results[i]["poses"].get(o + 1, {}).get("T_OtoC")
            ok.append(p is not None and np.isfinite(p).all() and _add_ok(p, T_OtoC[o], objs, o))
    frac = float(np.mean(ok))
    log(f"[slam] camera trajectory: max rotation error {max(rot):.4f} deg, max translation "
        f"error {max(trans):.3f} mm; ADD < 0.1 d for {frac:.3f} of {len(ok)} (frame, object) "
        f"poses")
    if frac < 0.9:
        raise AssertionError(f"SLAM path: ADD < 0.1 d for only {frac:.3f} of the poses")
    # the with-prior program on the card against the same net on the CPU
    if inf.last_prior_call is None:
        raise AssertionError("the SLAM path ran no with-prior network call")
    (img_d, boxes, valid, prior_uv, prior_valid), out = inf.last_prior_call
    if not prior_valid.any():
        raise AssertionError("the last with-prior call had no valid prior keypoint")
    cpu_fn = sk.make_frame_inference(full_width_net(seed), device="cpu")
    out_c = cpu_fn(img_d.cpu(), boxes[:2].cpu(), valid[:2].cpu(), prior_uv[:2].cpu(),
                   prior_valid[:2].cpu())
    errs = {n: (a[:2].cpu() - b).abs().max().item()
            for n, a, b in zip(("uv", "cov", "mask"), out, out_c)}
    log(f"[slam] with-prior network path vs CPU (2 crops, {int(prior_valid[:2].sum())} prior "
        f"keypoints): {json.dumps(errs)} (tol 1e-3)")
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"with-prior network path disagrees with the CPU: {errs}")
    compare_global_ba(engine, dev)
    compare_tracking_ba(engine, dev)
    # the profiled frame: its launches (counted at launch) and the bound of
    # its K8 / K9 calls, summed over their shapes
    from suo_slam_tpu_torch.models import hourglass as hg

    k89 = {"norm_relu": [0, 0.0], "upsample_add": [0, 0.0]}
    k8, k9 = hg._norm_relu_cuda, hg._upsample_add_cuda

    def spy_k8(x, inv, shift):
        k89["norm_relu"][0] += 1
        k89["norm_relu"][1] += bound(2 * x.numel() * x.element_size() + 2 * inv.numel() * 4,
                                     3 * x.numel())[0]
        return k8(x, inv, shift)

    def spy_k9(up1, low):
        k89["upsample_add"][0] += 1
        k89["upsample_add"][1] += bound((2 * up1.numel() + low.numel()) * up1.element_size(),
                                        up1.numel())[0]
        return k9(up1, low)

    hg._norm_relu_cuda, hg._upsample_add_cuda = spy_k8, spy_k9
    before = kernels.counts()
    try:
        with PnpCalls() as calls, K6Calls() as k6:
            avg = profile_run(lambda: frame(n_frames), per_frame_ms, "one SLAM frame")
    finally:
        hg._norm_relu_cuda, hg._upsample_add_cuda = k8, k9
    c = {k: v - before[k] for k, v in kernels.counts().items()}
    log(f"[slam] the profiled frame's launches: {json.dumps({k: v for k, v in c.items() if v})}; "
        f"{calls.n} pnp_ransac_batch calls, {json.dumps(k6.n)} camera RANSACs / re-init "
        f"votes; K8 / K9 calls and the sum of their bounds in ms "
        f"over the frame's shapes: "
        f"{json.dumps({k: [n, round(b, 5)] for k, (n, b) in k89.items()})}")
    if c["ba_lm"] != 1 or any(c[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"the profiled frame: K14 {c['ba_lm']} (want 1 tracking BA), "
                             f"K3 / K4 / K7 / K22 / K13 {[c[k] for k in OFF_PATH_KERNELS]} (want 0)")
    if not (c["pnp_ransac"] == calls.n >= 2 and c["chi2_counts"] == sum(k6.n.values()) >= 1):
        raise AssertionError(f"the profiled frame: K15 {c['pnp_ransac']} launches for "
                             f"{calls.n} pnp_ransac_batch calls (want one each, two or more), "
                             f"K6 {c['chi2_counts']} for {json.dumps(k6.n)} (want one each)")
    if avg is not None:
        from torch.autograd import DeviceType

        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        log(f"[slam] the profiled frame: {sum(e.count for e in kern)} kernels, device busy "
            f"{sum(e.self_device_time_total for e in kern) / 1e3:.2f} ms (before K15, on an H100 "
            f"80GB HBM3 at 700 W: 9,034 kernels, 33.00 ms)")
        if any("cholesky" in e.key for e in avg):
            raise AssertionError("the profiled frame ran a cholesky on the main path")
        per = {}
        for name in ("roi_crop", "pnp_ransac"):
            es = [e for e in kern if f"{name}_kernel" in e.key]
            per[name] = sum(e.self_device_time_total for e in es) / max(1, sum(e.count for e in es))
        log(f"[slam] the profiled frame: K1 {per['roi_crop']:.3f} us and K15 "
            f"{per['pnp_ransac']:.3f} us per launch (targets <= {TARGET_US['K1 device']} and <= "
            f"{TARGET_US['K15 frame']}; the earlier kernels on an H100 80GB HBM3, 700 W: "
            f"{EARLIER_US['K1 frame']} and {EARLIER_US['K15 frame']})")

    def again(i):  # the profiled frame's view once more, as view i
        _, bboxes, uv_gt = scene.frame(n_frames)
        inf.set_frame(bboxes, uv_gt)
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks, objs.masks)
        torch.cuda.synchronize()

    k15_frame_probe(again, n_frames + 1, fn.net, dev)
    return counts


def traced(fn, holds, label, attempts=3):
    """torch.profiler's key averages over one call of `fn` (a pure call: it
    is repeated), taken again while `holds(averages)` is false: the card's
    tracer now and then returns a short session without its kernels. None
    when every attempt came back without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        if holds(avg):
            return avg
        log(f"[profile] {label}: trace {i + 1} of {attempts} holds none of the kernels")
    return None


def device_us(fn, key, n=10, per_call=1):
    """Device microseconds per call of fn in the kernels whose names hold
    `key` (per_call of them per call), from torch.profiler over n calls
    (without the wrapper's host time, which `cuda_ms` includes), and where
    they were read. The time is averaged over the launches the trace holds,
    not over n: a retaken trace can also hold launches an earlier one lost,
    and a partial one fewer. When the tracer returns no such kernel, CUDA
    events around the n back-to-back calls (host time of the wrappers
    included) stand in for it."""
    import torch
    from torch.autograd import DeviceType

    def calls():
        for _ in range(n):
            fn()

    def mine(avg):
        return [e for e in avg if e.device_type == DeviceType.CUDA and key in e.key]

    fn()
    torch.cuda.synchronize()
    avg = traced(calls, lambda a: sum(e.count for e in mine(a)) > 0, key)
    if avg is not None:
        ks = mine(avg)
        launches = sum(e.count for e in ks)
        return sum(e.self_device_time_total for e in ks) * per_call / launches, "profiler"
    return 1e3 * cuda_ms(fn, n=5, inner=n), "CUDA events"


def lib_device_us(fn, n=5):
    """Device microseconds per call of a library yardstick: every kernel of
    one trace of n calls (the wrapper's host time, which `cuda_ms` includes,
    left out), over the calls the trace holds — the launches of its most
    launched kernel, since a short session can lose some; CUDA events when
    the tracer returns no kernel."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    cuda = lambda a: [e for e in a if e.device_type == DeviceType.CUDA]
    avg = traced(lambda: [fn() for _ in range(n)], lambda a: len(cuda(a)) > 0, "library")
    if avg is None:
        return 1e3 * cuda_ms(fn, n=5, inner=n), "CUDA events"
    ks = cuda(avg)
    calls = min(n, max(e.count for e in ks))
    return sum(e.self_device_time_total for e in ks) / calls, "profiler"


def _bf16_ulps(k, p):
    """|k - p| in units of the bf16 spacing at p (1 ulp: 2^(floor(log2|p|) - 7))."""
    import torch

    kd, pd = k.double(), p.double()
    e = torch.floor(torch.log2(pd.abs().clamp(min=2.0 ** -126)))
    return ((kd - pd).abs() / torch.exp2(e - 7)).max().item()


def _per_forward_launches(net, crops, names):
    """Launches of the named kernels in one forward of `net` on `crops`."""
    import torch

    from suo_slam_tpu_torch import kernels

    before = kernels.counts()
    with torch.inference_mode():
        net.backbone_logits(crops)
    torch.cuda.synchronize()
    after = kernels.counts()
    return {n: after[n] - before[n] for n in names}


def check_k8(dev, rng, net32, net16, crops):
    """K8 at the net's shapes (8 crops): the stem norm (64 ch at 128x128),
    a residual's first norm at 64x64 x 256 (the largest call) and a
    bottleneck norm at 64x64 x 128; f32 equal, bf16 within 1 ulp."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    shapes = [(N_OBJ, 64, 128, 128), (N_OBJ, 256, 64, 64), (N_OBJ, 128, 64, 64)]
    err32, ulps = 0.0, 0.0
    for shape in shapes:
        C = shape[1]
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).contiguous(
            memory_format=torch.channels_last)
        inv = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        shift = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev)
        k, p = hg._norm_relu_cuda(x, inv, shift), hg.norm_relu_plain(x, inv, shift)
        x16 = x.to(torch.bfloat16)
        k16, p16 = hg._norm_relu_cuda(x16, inv, shift), hg.norm_relu_plain(x16, inv, shift)
        torch.cuda.synchronize()
        err32 = max(err32, (k - p).abs().max().item())
        ulps = max(ulps, _bf16_ulps(k16, p16))
        if not (k16.is_contiguous(memory_format=torch.channels_last)
                and torch.equal(k16 == 0, p16 == 0)):
            raise AssertionError("K8 bf16: layout or zero pattern differs from the plain version")
    log(f"[kernel] K8 f32 max abs err {err32:.3e} (tol 0), bf16 max err {ulps:.3f} ulp (tol 1)")
    if not (err32 == 0.0 and ulps <= 1.0):
        raise AssertionError(f"K8 disagrees with its plain version: f32 {err32}, bf16 {ulps} ulp")
    per_fwd = {dt: _per_forward_launches(n, crops, ("norm_relu", "upsample_add"))
               for dt, n in (("f32", net32), ("bf16", net16))}
    log(f"[kernel] K8 / K9 launches per forward of the full-width net (8 crops): "
        f"{json.dumps(per_fwd)}")
    if any(v != {"norm_relu": 180, "upsample_add": 8} for v in per_fwd.values()):
        raise AssertionError(f"K8 / K9 launches per forward: {per_fwd}, expected 180 and 8")
    # timed at the largest call, a residual's first norm at 64x64 x 256; the
    # library yardstick is F.batch_norm(training=False) + relu on the same
    # running statistics (K8's function: the affine of fixed statistics)
    x = torch.from_numpy(rng.normal(size=shapes[1]).astype(np.float32)).to(dev).contiguous(
        memory_format=torch.channels_last)
    inv = torch.ones(256, device=dev)
    shift = torch.zeros(256, device=dev)
    rm, rv = torch.zeros(256, device=dev), torch.ones(256, device=dev)
    out = {}
    for name, xd in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        ms = cuda_ms(lambda: hg._norm_relu_cuda(xd, inv, shift))
        plain_ms = cuda_ms(lambda: hg.norm_relu_plain(xd, inv, shift))
        lib = lambda: torch.relu(torch.nn.functional.batch_norm(
            xd, rm, rv, inv, shift, training=False, eps=1e-5))
        lib_ms = cuda_ms(lib)
        us, src = device_us(lambda: hg._norm_relu_cuda(xd, inv, shift), "norm_relu_kernel")
        n = xd.numel()
        b = bound(2 * n * xd.element_size() + 2 * 256 * 4, n * 3)
        out[name] = (ms, plain_ms, b, lib_ms)
        _report(f"K8 norm_relu ({name}, {list(xd.shape)}, device {us:.3f} us by {src})",
                err32 if name == "f32" else ulps, "0" if name == "f32" else "1 bf16 ulp", ms,
                plain_ms, lib_ms, b, lib)
    # the wrapper's cost at one of the frame's small calls (a 4x4 hourglass
    # level, 8 crops), where the host time of the call dominates
    xs = x[:, :, :4, :4].contiguous(memory_format=torch.channels_last)
    us, src = device_us(lambda: hg._norm_relu_cuda(xs, inv, shift), "norm_relu_kernel")
    log(f"[host] K8 wrapper at a SLAM-frame call ({list(xs.shape)} f32): call "
        f"{cuda_ms(lambda: hg._norm_relu_cuda(xs, inv, shift)):.4f} ms, device {us:.3f} us by "
        f"{src}, host {host_ns({'k8': lambda: hg._norm_relu_cuda(xs, inv, shift)})['k8']} ns")
    ms, plain_ms, b, lib_ms = out["bf16"]
    return dict(name="norm_relu", route="cuda", source="suo_slam_tpu_torch/csrc/norm_relu.cu",
                replaces="suo_slam_tpu/models/hourglass.py:88", max_abs_err=err32, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k9(dev, rng):
    """K9 at the hourglass junctions: up1 [8, 256, H, W] for H = 64, 32, 16,
    8 and low at half; f32 and bf16 equal to the plain version."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    err = 0.0
    for H in (64, 32, 16, 8):
        up1 = cl(rng.normal(size=(N_OBJ, 256, H, H)).astype(np.float32))
        low = cl(rng.normal(size=(N_OBJ, 256, H // 2, H // 2)).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            a, b = up1.to(dt), low.to(dt)
            k, p = hg._upsample_add_cuda(a, b), hg.upsample_add_plain(a, b)
            torch.cuda.synchronize()
            err = max(err, (k.float() - p.float()).abs().max().item())
    log(f"[kernel] K9 max abs err over 4 levels, f32 and bf16: {err:.3e} (tol 0)")
    if err != 0.0:
        raise AssertionError(f"K9 disagrees with its plain version: {err}")
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a = cl(rng.normal(size=(N_OBJ, 256, 64, 64)).astype(np.float32)).to(dt)
        b = cl(rng.normal(size=(N_OBJ, 256, 32, 32)).astype(np.float32)).to(dt)
        ms = cuda_ms(lambda: hg._upsample_add_cuda(a, b))
        plain_ms = cuda_ms(lambda: hg.upsample_add_plain(a, b))
        us, src = device_us(lambda: hg._upsample_add_cuda(a, b), "upsample_add_kernel")
        cold = 1e3 * cuda_ms_cold(lambda: hg._upsample_add_cuda(a, b))
        bnd = bound((2 * a.numel() + b.numel()) * a.element_size(), a.numel())
        out[name] = (ms, plain_ms, bnd)
        _report(f"K9 upsample_add ({name}, up1 {list(a.shape)}, device {us:.3f} us by {src} "
                f"with warm inputs, {cold:.3f} us L2-cold)",
                err, "0",
                ms, plain_ms, None, bnd)
    ms, plain_ms, b = out["bf16"]
    return dict(name="upsample_add", route="cuda",
                source="suo_slam_tpu_torch/csrc/upsample_add.cu",
                replaces="suo_slam_tpu/models/hourglass.py:35", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def check_k10(dev, rng):
    """K10 at P = 4096 (the MeshDb subsample) on a resident table of 8 clouds
    read through an object index per pose: B = 1 and 8, and B = 96 (one call
    per scored scene: phase 7's 12 views x 8 objects, the main path's shape),
    on the current design (one launch) and the earlier one (two kernels, on
    the gathered clouds): per-point distances equal to the plain version's,
    means within 1e-6 relative, a pose's results the same bits in any batch.
    Bound: 9 f32 instructions a pair at half the 67 TFLOP/s (an FMA counts
    two there; with --fmad=false every instruction is one operation)."""
    import torch

    from suo_slam_tpu_torch.core import lie
    from suo_slam_tpu_torch.eval import meter

    P, R = 4096, N_OBJ
    table = torch.from_numpy(rng.uniform(-50, 50, (R, P, 3)).astype(np.float32)).to(dev)
    cnt = torch.full((R,), P, dtype=torch.int32, device=dev)
    cnt[1:] = torch.from_numpy(rng.integers(P // 2, P, R - 1).astype(np.int32)).to(dev)
    res = {}
    for B in (1, 8, 96):
        obj = torch.from_numpy((np.arange(B) % R).astype(np.int32)).to(dev)
        Tg = torch.from_numpy(np.stack([np.eye(4)] * B).astype(np.float32)).to(dev)
        Tg[:, :3, :3] = torch.from_numpy(np.stack([random_rotation(rng) for _ in range(B)])
                                         .astype(np.float32)).to(dev)
        Tg[:, 2, 3] = 800.0
        w = rng.normal(size=(B, 6)) * np.array([0.01] * 3 + [0.0] * 3)
        dT = lie.se3_exp(torch.from_numpy(w.astype(np.float32)).to(dev))
        dT[:, :3, 3] = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32) * 3).to(dev)
        Tp = (dT @ Tg).contiguous()
        pts, n = table[obj.long()], cnt[obj.long()]  # the earlier design's gathered clouds
        f = lambda: meter._add_dists_cuda(table, cnt, Tp, Tg, obj)
        f2 = lambda: meter._add_dists_cuda(pts, n, Tp, Tg, two_pass=True)
        plain = lambda: meter.add_dists_plain(table, cnt, Tp, Tg, obj=obj)
        k = meter._add_dists_cuda(table, cnt, Tp, Tg, obj, per_point=True)
        k2 = meter._add_dists_cuda(pts, n, Tp, Tg, per_point=True, two_pass=True)
        p = meter.add_dists_plain(table, cnt, Tp, Tg, per_point=True, obj=obj)
        pm, pd = torch.stack(p[:2]), torch.stack(p[2:])
        one = {i: meter._add_dists_cuda(table, cnt, Tp[i:i + 1], Tg[i:i + 1], obj[i:i + 1],
                                        per_point=True) for i in sorted({0, B - 1})}
        torch.cuda.synchronize()
        pt_equal = all(torch.equal(d, pd) for _, d in (k, k2))
        rel = max(((m - pm).abs() / pm.abs()).max().item() for m, _ in (k, k2))
        across = all(torch.equal(k[0][:, i:i + 1], m1) and torch.equal(k[1][:, i:i + 1], d1)
                     for i, (m1, d1) in one.items())
        log(f"[kernel] K10 B={B}: per-point distances equal {pt_equal}, means rel err "
            f"{rel:.3e} (tol 1e-6), a pose's results equal across B {across}; ADD "
            f"{k[0][0, :4].tolist()}, ADD-S {k[0][1, :4].tolist()}")
        if not (pt_equal and rel <= 1e-6 and across):
            raise AssertionError(f"K10 disagrees with its plain version or across B (B={B}): "
                                 f"{rel}")
        ms, ms2 = cuda_ms(f), cuda_ms(f2)
        plain_ms = cuda_ms(plain, n=5, inner=2 if B <= 8 else 1)

        def lib():  # the ADD-S minimum by cdist
            R_, t = Tg[:, :3, :3], Tg[:, :3, 3]
            g = pts @ R_.transpose(1, 2) + t[:, None]
            q = pts @ Tp[:, :3, :3].transpose(1, 2) + Tp[:, None, :3, 3]
            return torch.cdist(g, q).amin(-1)

        lib_ms = cuda_ms(lib, n=5, inner=2)
        us, src = device_us(f, "add_dists_kernel")
        us2, src2 = device_us(f2, "add_dists_", per_call=2)
        per, per2 = launches_per_call(f), launches_per_call(f2)
        if (per, per2) != (1, 2):
            raise AssertionError(f"K10 (B={B}) made {per} launches per call, its two-kernel "
                                 f"design {per2}")
        pairs = float((n.double() ** 2).sum())
        rows = len(set(obj.tolist()))  # the table's clouds this call reads
        b = bound(rows * P * 12 + B * (2 * 64 + 4 + 8), pairs * 9, F32_FLOP_PER_S / 2)
        res[B] = (rel, ms, plain_ms, lib_ms, b)
        log(f"[kernel] K10 B={B}: plan {meter.plan_add_dists(B, P)}; {per} kernels per call; "
            f"device {us:.3f} us by {src} (target <= {TARGET_US.get(f'K10 B={B}', 'none')}); "
            f"the earlier design: call {ms2:.4f} ms, device {us2:.3f} us by {src2} per call of "
            f"2 kernels (its run before this design {EARLIER_US.get(f'K10 B={B}', 'n/a')} us)")
        _report(f"K10 add_dists (B={B}, P={P}, device {us:.3f} us by {src})",
                rel, "1e-6 relative; per-point equal", ms, plain_ms, lib_ms, b, lib)
    rel, ms, plain_ms, lib_ms, b = res[96]
    return dict(name="add_dists", route="cuda", source="suo_slam_tpu_torch/csrc/add_dists.cu",
                replaces="suo_slam_tpu/eval/meter.py:83", max_abs_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def phase_bf16_net(dev, rng, seed, net32, net16, crops):
    """The full-width net in bf16 against the same weights in f32 on the
    card. With random weights the heatmaps are flat and uv moves with the
    rounding, so the gate is the bf16 error the CPU shows on the same two
    crops: the card's bf16-vs-f32 gap (largest and mean |uv|) within 1.5x the
    CPU's, whose convolutions round elsewhere. Prints both nets' ms per call
    (8 crops, backbone + readout)."""
    import torch

    cpu = {dt: full_width_net(seed, dt).eval().to(memory_format=torch.channels_last)
           for dt in (torch.float32, torch.bfloat16)}
    with torch.inference_mode():
        o32, o16 = net32(crops), net16(crops)
        torch.cuda.synchronize()
        c2 = crops[:2].cpu()
        c32, c16 = cpu[torch.float32](c2), cpu[torch.bfloat16](c2)
    gap = (o16.uv[:2].cpu() - o32.uv[:2].cpu()).abs()
    ref = (c16.uv - c32.uv).abs()
    card_all = (o16.uv - o32.uv).abs()
    f32_cpu = (o32.uv[:2].cpu() - c32.uv).abs().max().item()
    log(f"[bf16] uv |bf16 - f32| on the card: max {card_all.max().item():.4f} mean "
        f"{card_all.mean().item():.5f} NDC (8 crops); the 2 crops: card max "
        f"{gap.max().item():.4f} mean {gap.mean().item():.5f}, CPU max {ref.max().item():.4f} "
        f"mean {ref.mean().item():.5f} (gate 1.5x the CPU's); f32 card vs CPU {f32_cpu:.2e}; "
        f"mask |bf16 - f32| max {(o16.kp_mask - o32.kp_mask).abs().max().item():.4f}")
    if not (torch.isfinite(o16.uv).all() and torch.isfinite(o16.cov).all()):
        raise AssertionError("bf16 net: non-finite outputs")
    if not (gap.max() <= 1.5 * ref.max() and gap.mean() <= 1.5 * ref.mean()):
        raise AssertionError("bf16 net on the card: uv farther from f32 than the CPU's bf16 net")
    # ms per call with K8 / K9 and with their plain versions in the same
    # net, in turns (kernels, plain, plain, kernels), host clock around
    # synchronized calls: the layer's own A/B
    from suo_slam_tpu_torch.models import hourglass as hg

    fused = (hg.norm_relu, hg.upsample_add)
    plain = (hg.norm_relu_plain, hg.upsample_add_plain)

    def wall_ms(n, reps=10):
        vals = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                n(crops)
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(vals[1:])

    t = {}
    try:
        for turn, fns in (("kernels", fused), ("plain", plain), ("plain", plain),
                          ("kernels", fused)):
            hg.norm_relu, hg.upsample_add = fns
            for name, n in (("f32", net32), ("bf16", net16)):
                t.setdefault(f"{name} {turn}", []).append(wall_ms(n))
    finally:
        hg.norm_relu, hg.upsample_add = fused
    log("[bf16] full-width net ms per call (8 crops, 256x256, backbone + readout; median of "
        "10 synchronized calls; two turns each, kernels / plain epilogues in the order "
        "K P P K): " + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()}))
    # the same calls' device time, from torch.profiler: all kernels, and the
    # convolutions alone, per call of 3
    from torch.autograd import DeviceType

    def kern(avg):
        return [e for e in avg if e.device_type == DeviceType.CUDA]

    def three_calls(n):
        with torch.inference_mode():
            for _ in range(3):
                n(crops)

    dev_ms = {}
    for name, n in (("f32", net32), ("bf16", net16)):
        avg = traced(lambda: three_calls(n), lambda a: len(kern(a)) > 0, f"{name} net")
        if avg is None:
            dev_ms[name] = "not measured"
            continue
        conv = sum(e.self_device_time_total for e in avg if e.device_type == DeviceType.CPU
                   and e.key == "aten::cudnn_convolution")
        dev_ms[name] = {"busy": round(sum(e.self_device_time_total for e in kern(avg)) / 3e3, 3),
                        "conv": round(conv / 3e3, 3),
                        "kernels": sum(e.count for e in kern(avg)) // 3}
    log("[bf16] full-width net device ms per call (8 crops, with K8 / K9): " + json.dumps(dev_ms))
    return t


# evaluation phase ---------------------------------------------------------------
EVAL_CONFIGS = [  # kp config rows: class, grip, spout, brand name, nutrition facts, bar code
    ("box_like", 0, 0, 1, 0, 1), ("cylinder_like", 1, 1, 0, 0, 0), ("hand_tool", 0, 0, 1, 1, 0),
    ("box_like", 1, 0, 0, 1, 0), ("cylinder_like", 0, 0, 1, 0, 1), ("hand_tool", 1, 1, 0, 0, 1),
    ("box_like", 0, 1, 1, 1, 0), ("cylinder_like", 0, 0, 0, 1, 1),
]
EVAL_VIEWS = 12


def write_png(path, img):
    """A PNG of a uint8 (gray or RGB) or uint16 (gray) array: zlib + numpy,
    one row filter (None)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    data = img.astype(">u2") if img.dtype == np.uint16 else img.astype(np.uint8)
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 16 if img.dtype == np.uint16 else 8,
                       0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


class EvalObjects:
    """The evaluation phase's 8 objects: the channels of their kp config rows
    (14-18 of the 41), keypoints and 6000 model points in a 100 mm cube;
    objects 1, 4 and 7 symmetric (a 180-degree turn about z), as in the
    SLAM phase."""

    def __init__(self, rng):
        from suo_slam_tpu_torch.kp import config as kp_config

        self.names = [kp_config.get_kps(c, *map(bool, f)) for c, *f in EVAL_CONFIGS]
        self.model_kps = np.zeros((N_OBJ, NK, 3), np.float32)
        self.masks = np.zeros((N_OBJ, NK), bool)
        self.points = []
        for o, names in enumerate(self.names):
            ch = np.array(sorted(names.values()))
            self.masks[o, ch] = True
            self.model_kps[o, ch] = rng.uniform(-50, 50, (len(ch), 3))
            self.points.append(rng.uniform(-50, 50, (6000, 3)).astype(np.float32))
        self.diameter = np.full((N_OBJ,), 100.0 * math.sqrt(3.0), np.float32)
        self.is_symmetric = np.zeros((N_OBJ,), bool)
        self.is_symmetric[[0, 3, 6]] = True


def write_bop_tree(root, objs, scenes, n_views=EVAL_VIEWS):
    """One YCB-V-layout BOP dataset under `root`: models_bop-compat (binary
    PLYs + models_info.json), kp_info, kp_configs, one test scene per
    `SlamScene` of `scenes` (test/000000, test/000001, ...: n_views views
    each, rgb, depth and mask PNGs and the scene JSONs), keyframe.txt."""
    import os
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    models = os.path.join(root, "models_bop-compat")
    for d in (models, os.path.join(root, "kp_info"), os.path.join(root, "kp_configs")):
        os.makedirs(d)
    info = {}
    for o in range(N_OBJ):
        pts = objs.points[o]
        with open(os.path.join(models, f"obj_{o + 1:06d}.ply"), "wb") as f:
            f.write(f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\nend_header\n"
                    .encode())
            f.write(pts.astype("<f4").tobytes())
        mi = {"diameter": float(objs.diameter[o])}
        if objs.is_symmetric[o]:
            mi["symmetries_discrete"] = [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]
        info[str(o + 1)] = mi
        kps = {n: {"pos_mean": objs.model_kps[o, ch].tolist(),
                   "pos_cov": np.eye(3).reshape(-1).tolist()}
               for n, ch in objs.names[o].items()}
        with open(os.path.join(root, "kp_info", f"obj_{o + 1:06d}_kp_info.json"), "w") as f:
            json.dump({"keypoints": kps, "view_pose": np.eye(4).reshape(-1).tolist()}, f)
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    with open(os.path.join(root, "kp_configs", "ycbv_kp_config.csv"), "w") as f:
        f.write("# instance,class,has_grip,has_spout,has_brand_name,has_nutrition_facts,"
                "has_bar_code\n")
        for o, (c, *fl) in enumerate(EVAL_CONFIGS):
            f.write(f"obj_{o + 1},{c},{','.join(map(str, fl))}\n")
    keyframes = []
    for si, scene in enumerate(scenes):
        keyframes += _write_bop_scene(os.path.join(root, "test", f"{si:06d}"), si, scene,
                                      n_views)
    with open(os.path.join(root, "keyframe.txt"), "w") as f:
        f.write("\n".join(keyframes) + "\n")


def _write_bop_scene(sdir, si, scene, n_views):
    """Scene si of `write_bop_tree` under sdir; returns its keyframe lines."""
    import os

    for d in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(sdir, d))
    cams, gts, gt_infos, keyframes = {}, {}, {}, []
    for v in range(n_views):
        T, bboxes, _ = scene.frame(v)
        img = np.full((H_IMG, W_IMG, 3), 40, np.uint8)
        depth = np.zeros((H_IMG, W_IMG), np.uint16)
        gts[str(v)], gt_infos[str(v)] = [], []
        for o in range(N_OBJ):
            x1, y1, x2, y2 = (int(round(c)) for c in bboxes[o])
            img[y1:y2, x1:x2] = (60 + 20 * o, 200 - 15 * o, 90 + 10 * o)
            depth[y1:y2, x1:x2] = int(T[o, 2, 3])
            mask = np.zeros((H_IMG, W_IMG), np.uint8)
            mask[y1:y2, x1:x2] = 255
            write_png(os.path.join(sdir, "mask_visib", f"{v:06d}_{o:06d}.png"), mask)
            gts[str(v)].append({"obj_id": o + 1, "cam_R_m2c": T[o, :3, :3].reshape(-1).tolist(),
                                "cam_t_m2c": T[o, :3, 3].tolist()})
            x1, y1, x2, y2 = (float(c) for c in bboxes[o])
            gt_infos[str(v)].append({"bbox_obj": [x1, y1, x2 - x1, y2 - y1],
                                     "bbox_visib": [x1, y1, x2 - x1, y2 - y1],
                                     "visib_fract": 1.0, "px_count_visib": 1000})
        write_png(os.path.join(sdir, "rgb", f"{v:06d}.png"), img)
        write_png(os.path.join(sdir, "depth", f"{v:06d}.png"), depth)
        cams[str(v)] = {"cam_K": YCBV_K.reshape(-1).tolist(), "depth_scale": 1.0,
                        "cam_R_w2c": scene.cams[v, :3, :3].reshape(-1).tolist(),
                        "cam_t_w2c": scene.cams[v, :3, 3].tolist()}
        keyframes.append(f"{si:06d}/{v:06d}")
    for name, d in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", gt_infos)):
        with open(os.path.join(sdir, f"{name}.json"), "w") as f:
            json.dump(d, f)
    return keyframes


def phase_evaluate(dev, seed, net16):
    """The evaluation entry point on a BOP tree written here (see the module
    docstring, phase 7). Returns the kernel counts of the phase."""
    import contextlib
    import io
    import os
    import re

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.evaluate import Evaluator

    rng = np.random.default_rng(seed + 2)
    objs = EvalObjects(rng)
    scene = SlamScene(rng, objs, EVAL_VIEWS)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval")
    root = os.path.join(base, "bop_datasets", "ycbv")
    t0 = time.perf_counter()
    write_bop_tree(root, objs, [scene])
    log(f"[eval] BOP tree of {EVAL_VIEWS} views x {N_OBJ} objects written in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels.reset_counts()
    out = {}
    for leg, kw in (("slam", dict(nviews=-1, debug_gt_kp=True)),
                    ("single_view_bf16", dict(nviews=1, net=net16))):
        k10_before = kernels.counts()["add_dists"]
        ev = Evaluator("ycbv", root, "", detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev, **kw)
        ev.model_path = os.path.join(base, "results")
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summary = ev.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        if summary is None:
            raise AssertionError(f"evaluation leg {leg} failed:\n{text[-3000:]}")
        outdir = os.path.join(ev.model_path, ev.method_name())
        csv_path = os.path.join(outdir, ev.method_name() + ".csv")
        if not (os.path.isfile(os.path.join(outdir, "summary.txt")) and os.path.isfile(csv_path)):
            raise AssertionError(f"evaluation leg {leg}: summary.txt or the CSV is missing")
        rows = open(csv_path).read().splitlines()
        k10 = kernels.counts()["add_dists"] - k10_before
        # one scene: one K10 launch where any pose was scored (a CSV row is one)
        if k10 != 1 and (rows or k10 > 1):
            raise AssertionError(f"evaluation leg {leg}: {k10} K10 launches for one scored "
                                 f"scene ({len(rows)} CSV rows)")
        auc = float(re.search(r"AUC of ADD\(-S\): ([\d.]+)", text).group(1))
        cam = summary.get("cam_pose_pct")
        log(f"[eval] {leg}: {ev.method_name()}: AUC of ADD(-S) {auc:.1f}, ADD "
            f"{100 * summary['ours']['AUC of ADD']:.2f}, ADD-S "
            f"{100 * summary['ours']['AUC of ADD-S']:.2f}, camera poses found {cam}%, "
            f"{len(rows)} CSV rows; {wall:.2f} s for {EVAL_VIEWS} views = "
            f"{wall / EVAL_VIEWS * 1e3:.2f} ms per view (loading, engine and meter), {k10} K10 "
            f"launch(es) for the scene, tracking "
            f"{ev.object_slam.tracking_hz():.2f} Hz")
        out[leg] = (auc, cam, wall)
    counts = kernels.counts()
    log(f"[eval] launches over both legs: {json.dumps(counts)}")
    auc, cam, _ = out["slam"]
    if not (auc > 80.0 and cam == 100.0):
        raise AssertionError(f"evaluation (SLAM, GT keypoints): AUC {auc}, camera poses {cam}%")
    missing = [k for k in ("norm_relu", "upsample_add", "add_dists", "roi_crop",
                           "heatmap_readout", "pnp_ransac", "ba_lm", "chi2_counts")
               if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the evaluation path: {missing}, or "
                             f"K3 / K4 / K7 / K22 / K13 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    eval_viz_legs(dev, root, base, net16)
    return counts


NO_DISPLAY_LINE = "[evaluate] --show_viz: no display server; disabled"
VIZ_CHECK_VIEW = EVAL_VIEWS - 1  # the view whose written frame is redrawn and compared


def _viz_leg(dev, root, base, net16, guide, no_viz, label):
    """One SLAM sweep of phase 7's tree with the full-width bf16 net under
    `guide`: with visualization (viz_cov, do_viz_extra, show_viz) or
    without. Returns (Evaluator, output, per-view s, launches, per-view
    expectations {j: (frame shape, {obj: has a pose})}, detections with
    ellipses in the redrawn view)."""
    import io
    import os
    import shutil

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.data import png
    from suo_slam_tpu_torch.eval import viz as tviz
    from suo_slam_tpu_torch.evaluate import Evaluator

    buf = io.StringIO()
    starts, expect, n_cov = [], {}, []
    kernels.reset_counts()
    with guide.installed(), contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, "", nviews=-1, detection_type="gt", net=net16,
                       no_viz=no_viz, viz_cov=True, do_viz_extra=True, show_viz=not no_viz,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev)
        ev.model_path = os.path.join(base, "results_viz", label)
        shutil.rmtree(ev.model_path, ignore_errors=True)
        run_slam, write_viz = ev._run_slam, ev._write_viz

        def timed(*a, **kw):
            starts.append(time.perf_counter())
            return run_slam(*a, **kw)

        def checked(outdir, scene_id, j, view_id, results):
            write_viz(outdir, scene_id, j, view_id, results)
            eng = ev.object_slam
            view = eng.view_ids[-1] if eng.view_ids else view_id
            dets = eng.get_view_viz_data(view)
            poses = {o: r["T_OtoC"] for o, r in results.get(view, {}).get("poses", {}).items()}
            has_prior = any(d.get("prior_uv") is not None for d in dets.values())
            expect[j] = ((H_IMG, (3 if has_prior else 2) * W_IMG, 3),
                         {o: poses.get(o) is not None for o in dets})
            if j != VIZ_CHECK_VIEW:
                return
            # the written frame against make_frame_viz redrawn from the
            # engine's data, as _write_viz draws it (viz_cov: ellipses on)
            priors = None
            for d in dets.values():
                if d.get("prior_uv") is None:
                    continue
                pm = d["model_mask"]
                pmap = tviz.render_prior_px((H_IMG, W_IMG), tviz._bbox_ndc_to_px(
                    d["prior_uv"][pm], d["bbox"]), np.where(pm)[0])
                priors = pmap if priors is None else np.maximum(priors, pmap)
            want = tviz.make_frame_viz(ev._last_img, dets, poses, ev._last_K,
                                       mesh_db=ev.mesh_db, priors=priors)
            with open(os.path.join(outdir, "viz_images", f"scene_{scene_id}_{j:06d}.png"),
                      "rb") as f:
                got = png.decode(f.read())
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"viz leg: view {j}'s written frame differs from "
                                     f"make_frame_viz redrawn ({got.shape} vs {want.shape}, "
                                     f"{int((got != want).any(-1).sum())} pixels)")
            n_cov.append(sum(d["cov"] is not None for d in dets.values()))

        ev._run_slam, ev._write_viz = timed, checked
        torch.cuda.synchronize()
        summary = ev.run()
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
    text = buf.getvalue()
    if summary is None:
        raise AssertionError(f"viz leg {label} failed:\n{text[-3000:]}")
    return ev, text, np.diff(starts[:-1]), kernels.counts(), expect, n_cov


def eval_viz_legs(dev, root, base, net16):
    """Phase 7's visualization leg: `Evaluator(nviews=-1)` with the
    full-width bf16 net (each call guided to the ground truth by `GtGuided`,
    so objects initialise and the prior panel appears), viz on with viz_cov,
    do_viz_extra and show_viz, over the phase's views: a PNG per view of the
    shape its prior decides, each object's panels, one view's frame equal to
    `make_frame_viz` redrawn, the no-display line; the same leg without viz
    in turns (median view ms), `_write_viz`'s host ms per frame (drawing,
    PNG encoding and writing) and the legs' launches."""
    import os

    from suo_slam_tpu_torch.data import png

    guide = GtGuided(root, dev)
    saved = {k: os.environ.pop(k) for k in ("DISPLAY", "WAYLAND_DISPLAY") if k in os.environ}
    try:
        legs = [_viz_leg(dev, root, base, net16, guide, no_viz, f"{tag}{i}")
                for i in range(2) for no_viz, tag in ((False, "viz"), (True, "noviz"))]
    finally:
        os.environ.update(saved)
    ev, text, _, counts, expect, n_cov = legs[0]
    viz_dir = os.path.join(ev.model_path, ev.method_name(), "viz_images")
    n_frames = n_obj = n_overlay = 0
    for j in range(EVAL_VIEWS):
        if j not in expect:
            raise AssertionError(f"viz leg: view {j} drew no frame")
        shape, posed = expect[j]
        got = png.imread(os.path.join(viz_dir, f"scene_0_{j:06d}.png")).shape
        names = set(os.listdir(os.path.join(viz_dir, f"scene_0_{j:06d}")))
        want = {"bbox_input.png"} | {f"viz_obj_{o}_{k}.png" for o, p in posed.items()
                                     for k in ("input", "output") + (("overlay",) if p else ())}
        if got != shape or names != want:
            raise AssertionError(f"viz leg view {j}: frame {got} (want {shape}), panels "
                                 f"{sorted(names ^ want)} differ")
        n_frames += 1
        n_obj += len(posed)
        n_overlay += sum(posed.values())
    if text.count(NO_DISPLAY_LINE) != 1:
        raise AssertionError(f"viz leg: the no-display line printed {text.count(NO_DISPLAY_LINE)}"
                             " times")
    need = ("roi_crop", "norm_relu", "upsample_add", "heatmap_readout", "pnp_ransac", "ba_lm",
            "chi2_counts", "prior_render", "add_dists")
    if [k for k in need if counts[k] == 0]:
        raise AssertionError(f"viz leg: kernels not launched: {[k for k in need if not counts[k]]}")
    if len(n_cov) != 1:
        raise AssertionError(f"viz leg: view {VIZ_CHECK_VIEW} was not redrawn")
    med = {lab: 1e3 * float(np.median(leg[2])) for leg, lab in
           zip(legs, ("viz 1", "no viz 1", "viz 2", "no viz 2"))}
    vm = [leg[0].viz_ms for leg in legs[0::2]]
    draw = [m["draw"] / m["frames"] for m in vm]
    enc = [m["png"] / m["frames"] for m in vm]
    n_prior = sum(shape[1] == 3 * W_IMG for shape, _ in expect.values())
    log(f"[eval] viz leg: {n_frames} frames ({n_prior} with the prior panel), {n_obj} objects' "
        f"panels ({n_overlay} with the overlay), view {VIZ_CHECK_VIEW}'s frame equal to "
        f"make_frame_viz redrawn ({n_cov[0]} detections with ellipses), the "
        f"no-display line once; launches {json.dumps({k: v for k, v in counts.items() if v})}")
    log(f"[eval] viz leg, median view ms in turns: " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()) + "; _write_viz host ms per frame: drawing "
        + " / ".join(f"{d:.3f}" for d in draw) + ", PNG encoding and writing "
        + " / ".join(f"{e:.3f}" for e in enc))


# int8 phase ---------------------------------------------------------------------
def _eval_root():
    import os

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval")
    return base, os.path.join(base, "bop_datasets", "ycbv")


def _int8_traffic(name, a, kw):
    """(bytes, int8 operations) a K11 / K12 / K13 call must move and do:
    each input read once, each output written once (K12's pool and junction
    modes: the unpooled input, the half-resolution operand)."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    x = a[0]
    if name == "int8_conv":
        qc = a[1]
        cout, kh, kw_, _ = qc.wq.shape
        Ho, Wo = ik.out_hw(x.shape[1], x.shape[2], qc)
        M = x.shape[0] * Ho * Wo
        mode = ik.conv_mode(kw.get("out_s8", a[4] if len(a) > 4 else False),
                            kw.get("f32_epilogue"))
        out_b = {ik.MODE_S8: 1, ik.MODE_F32: 4}.get(mode, 2)
        return (x.numel() + qc.wq.numel() + M * cout * out_b + 8 * cout,
                2.0 * M * cout * kh * kw_ * qc.cin)
    if name == "int8_quant":  # the prologue's operands, the input, the outputs
        xq = x.q if isinstance(x, ik.Deq) else x
        C = xq.shape[-1]
        x2, pool = kw.get("x2"), bool(kw.get("pool"))
        # output pixels: a quarter of the input's in the pool mode (its input
        # read once, 4x its output); a junction reads x2 at a quarter
        P = ik.plan_quant(xq.shape, kw.get("c_out"), pool=pool,
                          up_shape=tuple(x2.q.shape) if x2 is not None and x2.up else None).P
        n_out = (a[1] is not None or pool) + (len(a) > 2 and a[2] is not None)
        nb = xq.numel() * xq.element_size() + n_out * P * (kw.get("c_out") or C)
        if x2 is not None:
            nb += x2.q.numel()
        if kw.get("add") is not None:
            nb += kw["add"].numel() * kw["add"].element_size()
        return nb, 0.0
    if name == "int8_maxpool":
        return x.numel() * 1.25, 0.0
    return x.numel() * 3.25, 0.0  # the junction: up1, low, bf16 out


def _quant_mode(a, kw):
    """A K12 call's mode: its input ("f32", "bf16", "s8", "s8 pool" (the
    pool mode), or the prologue "deq[+deq|+deq/2][+tensor|+vector]", "/2"
    the junction mode's half-resolution operand) and outputs ("raw", "norm",
    "pair"; the pool mode's raw output is the pooled codes), with "padded"
    where it writes wider rows."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    x = a[0]
    if isinstance(x, ik.Deq):
        x2 = kw.get("x2")
        src = "deq" + ("" if x2 is None else "+deq/2" if x2.up else "+deq")
        add = kw.get("add")
        if add is not None:
            src += "+vector" if add.dim() == 1 else "+tensor"
    else:
        src = str(x.dtype).replace("torch.", "").replace("bfloat16", "bf16").replace(
            "float32", "f32").replace("int8", "s8") + (" pool" if kw.get("pool") else "")
    raw, norm = a[1] is not None or bool(kw.get("pool")), len(a) > 2 and a[2] is not None
    out = "pair" if raw and norm else "raw" if raw else "norm"
    C = (x.q if isinstance(x, ik.Deq) else x).shape[-1]
    return (f"{src} {out}" + (" padded" if (kw.get("c_out") or C) != C else "")
            + (" f32 ops" if kw.get("f32_ops") else ""))


def _int8_calls(run, traffic=None):
    """`run()` with the int8 kernel entry points spied: the arguments of the
    first call of each distinct shape (K11 by input and weight shape and
    epilogue, K12 by input dtype, shape and outputs, K13 by shape); every
    call's (bytes, operations) go to `traffic` when given."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    names = ("int8_conv", "int8_quant", "int8_maxpool", "int8_upsample_add")
    orig = {n: getattr(ik, n) for n in names}
    seen = {}

    def key(name, a, kw):
        x = a[0]
        if name == "int8_conv":
            return (name, tuple(x.shape), tuple(a[1].wq.shape), a[1].stride,
                    bool(kw.get("out_s8", a[4] if len(a) > 4 else False)),
                    kw.get("f32_epilogue"))
        if name == "int8_quant":
            return (name, _quant_mode(a, kw), tuple((x.q if isinstance(x, ik.Deq) else x).shape))
        return (name, tuple(x.shape))

    def spy(name):
        def f(*a, **kw):
            seen.setdefault(key(name, a, kw), (a, kw))
            if traffic is not None:
                traffic.append((name,) + _int8_traffic(name, a, kw))
            return orig[name](*a, **kw)
        return f

    try:
        for n in names:
            setattr(ik, n, spy(n))
        run()
    finally:
        for n, f in orig.items():
            setattr(ik, n, f)
    return seen


def _im2col(x, kh, kw, pad, cin_p):
    """[N, H, W, C] s8 -> [N*H*W, kh*kw*cin_p] patches in the K11 weights'
    (r, s, c) order (stride 1, channels zero-padded to cin_p), for the
    library GEMM yardstick."""
    import torch
    import torch.nn.functional as F

    N, H, W, C = x.shape
    xp = F.pad(x, (0, cin_p - C, pad, pad, pad, pad))
    cols = [xp[:, r:r + H, s:s + W] for r in range(kh) for s in range(kw)]
    return torch.cat(cols, dim=-1).reshape(N * H * W, kh * kw * cin_p)


def _int_mm(x, qc, M):
    """`torch._int_mm` (cuBLASLt s8 GEMM) on the convolution's GEMM as a
    function, or None where its shape rules (M > 16, K and N multiples of 8)
    or the layout refuse it; the im2col of a 3x3 input is made here, before
    any clock."""
    import torch

    cout, kh, kw, cin_p = qc.wq.shape
    if qc.stride != 1 or M <= 16 or cin_p % 8 or cout % 8:
        return None
    A = x.reshape(M, -1) if kh == 1 and x.shape[-1] == cin_p else _im2col(x, kh, kw, qc.pad,
                                                                         cin_p)
    B = qc.wq.reshape(cout, -1).t()
    try:
        torch._int_mm(A, B)
    except RuntimeError as e:
        log(f"[kernel] torch._int_mm refused [{M}, {A.shape[1]}] x [{B.shape[0]}, {cout}]: {e}")
        return None
    return lambda: torch._int_mm(A, B)


def check_k11(dev, calls, label="8 crops", stem=True, time_plain=True):
    """K11 at every distinct convolution of one forward (their real codes
    and epilogue vectors, in the calls' epilogue modes) and, with `stem`, the
    concat stem's 7x7 stride-2 prior convolution: equal bf16 bits / s8 codes
    / f32 values, each call's route from `plan_conv` (mma.sync for a
    stride-2 stem, wgmma for every stride-1 convolution); times, device
    times, bounds (int8 operations or bytes) and
    `torch._int_mm` on the same s8 GEMM (1x1: the activations as [M, Cin];
    3x3: an im2col of them, made before the clock), its wrapper and device
    time. Returns the JSON row (8 crops) and the per-shape numbers."""
    import torch

    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.models import int8_kernels as ik

    convs = [(k, v) for k, v in calls.items() if k[0] == "int8_conv"]
    if stem:
        g = torch.Generator(device=dev).manual_seed(12)
        qs = i8.quantize_conv(torch.nn.Conv2d(44, 64, 7, 2, 3).to(dev), 3, dev)
        xp = torch.randint(0, 128, (N_OBJ, 256, 256, 48), device=dev, generator=g,
                           dtype=torch.int32).to(torch.int8)
        xp[..., 41:] = 0  # as K12 writes the prior: 41 channels in 48-wide rows
        e1 = torch.full((64,), 1e-4, device=dev).to(torch.bfloat16).float()
        convs.append((("int8_conv", tuple(xp.shape), tuple(qs.wq.shape), 2, False, None),
                      ((xp, qs, e1, torch.zeros(64, device=dev), False), {})))
    rows, routes = [], {}
    for key, (a, kw) in convs:
        x, qc, e1, e2 = a[:4]
        out_s8 = kw.get("out_s8", a[4] if len(a) > 4 else False)
        f32e = kw.get("f32_epilogue")
        cout, kh, kwd, cin_p = qc.wq.shape
        plan = ik.plan_conv(x.shape[0], x.shape[1], x.shape[2], cin_p, cout, kh, kwd,
                            qc.stride, qc.pad, ik.conv_mode(out_s8, f32e))
        k = ik._int8_conv_cuda(x, qc, e1, e2, out_s8, f32e)
        p = ik.int8_conv_plain(x, qc, e1, e2, out_s8, f32e)
        torch.cuda.synchronize()
        if not (k.dtype == p.dtype and torch.equal(k, p)):
            raise AssertionError(f"K11 disagrees with its plain version at {key} ({label}): "
                                 f"{(k.float() - p.float()).abs().max().item()}")
        del k, p
        Ho, Wo = ik.out_hw(x.shape[1], x.shape[2], qc)
        M = x.shape[0] * Ho * Wo
        b = bound(*_int8_traffic("int8_conv", a, kw), INT8_OPS_PER_S)
        routes[f"{kh}x{kwd} s{qc.stride} {list(x.shape)}"] = (plan.route, plan.tile)
        rows.append((key, x, qc, e1, e2, out_s8, f32e, M, b))
    log(f"[kernel] K11 ({label}) routes and pixel tiles: " + json.dumps(
        {k: f"{r} {list(t)}" for k, (r, t) in routes.items()}))
    if stem and not any(" s2 " in k for k in routes):
        raise AssertionError("K11: the concat stem's stride-2 convolution was not checked")
    off = [k for k, (r, _) in routes.items() if r != ("mma_sync" if " s2 " in k else "wgmma")]
    if off:
        raise AssertionError(f"K11 ({label}): off their routes (mma.sync for stride 2, wgmma "
                             f"for stride 1): {off}")
    # time one call of each distinct weight shape at its largest input
    best = {}
    for r in rows:
        wk = (r[0][2], r[0][3])
        if wk not in best or r[7] > best[wk][7]:
            best[wk] = r
    out = {}
    outs = {None: "", torch.float32: " (f32 epilogue)", torch.bfloat16: " (f32 epilogue)"}
    for wk, (key, x, qc, e1, e2, out_s8, f32e, M, b) in sorted(best.items(),
                                                                key=lambda t: -t[1][7]):
        f = lambda: ik._int8_conv_cuda(x, qc, e1, e2, out_s8, f32e)
        ms = cuda_ms(f, n=10, inner=5)
        plain_ms = (cuda_ms(lambda: ik.int8_conv_plain(x, qc, e1, e2, out_s8, f32e), n=3,
                            inner=2, warmup=1) if time_plain else None)
        us, src = device_us(f, "int8_conv_kernel", n=5)
        cout, kh, kwd, cin_p = qc.wq.shape
        lib = _int_mm(x, qc, M)
        lib_ms = cuda_ms(lib, n=10, inner=5) if lib else None
        lib_us = lib_device_us(lib) if lib else (None, None)
        del lib
        name = (f"{kh}x{kwd} {x.shape[-1]}->{cout} s{qc.stride} on {list(x.shape)} "
                f"{'s8' if out_s8 else 'f32' if f32e == torch.float32 else 'bf16'} out"
                + outs[f32e])
        lib_txt = ("n/a" if lib_ms is None
                   else f"{lib_ms:.4f} ms, device {lib_us[0]:.3f} us by {lib_us[1]}")
        log(f"[kernel] K11 int8_conv ({label}, {name}): bit-equal | kernel {ms:.4f} ms, device "
            f"{us:.3f} us by {src} | plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'} | torch._int_mm "
            f"{lib_txt} | bound {b[0]:.5f} ms ({b[1]})")
        out[name] = (ms, us, plain_ms, lib_ms, b, lib_us[0])
    log(f"[kernel] K11 ({label}): {len(rows)} distinct convolution calls bit-equal to the plain "
        f"version, {len(best)} weight shapes timed")
    # the JSON row: the forward's own convolution with the most operations
    # (3x3 128->128 at 64x64 at full width), not the concat stem's
    name = max((n for n in out if " s1 " in n),
               key=lambda n: out[n][4][0] if out[n][4][1] == "operations" else 0)
    ms, us, plain_ms, lib_ms, b, _ = out[name]
    return dict(name="int8_conv", route="cuda", source="suo_slam_tpu_torch/csrc/int8_conv.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:254", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms), out


def check_k12(dev, calls, label="8 crops", time_plain=True):
    """K12 in every mode the forward used (f32 / bf16 / s8 input or a
    prologue of s8 operands; raw, normalised or both outputs; padded rows),
    on its real inputs: equal codes; wrapper and device times at each mode's
    largest call."""
    import torch

    from suo_slam_tpu_torch.models import int8_kernels as ik

    res = {}
    for key, (a, kw) in calls.items():
        if key[0] != "int8_quant":
            continue
        k = ik._int8_quant_cuda(*a, **kw)
        p = ik.int8_quant_plain(*a, **kw)
        torch.cuda.synchronize()
        if not all((u is None and v is None) or torch.equal(u, v) for u, v in zip(k, p)):
            raise AssertionError(f"K12 disagrees with its plain version at {key} ({label})")
        b = bound(*_int8_traffic("int8_quant", a, kw))
        n = key[2]
        if key[1] not in res or np.prod(n) > np.prod(res[key[1]][0]):
            res[key[1]] = (n, a, kw, b)
    out = {}
    for mode, (shape, a, kw, b) in res.items():
        f = lambda: ik._int8_quant_cuda(*a, **kw)
        ms = cuda_ms(f, n=10, inner=5)
        plain_ms = (cuda_ms(lambda: ik.int8_quant_plain(*a, **kw), n=5, inner=2)
                    if time_plain else None)
        us, src = device_us(f, "int8_quant_kernel", n=5)
        log(f"[kernel] K12 int8_quant ({label}, {mode}, {list(shape)}): bit-equal | kernel "
            f"{ms:.4f} ms, device {us:.3f} us by {src} | plain "
            f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'} | bound "
            f"{b[0]:.5f} ms ({b[1]})")
        out[mode] = (ms, plain_ms, b, int(np.prod(shape)), us)
    log(f"[kernel] K12 ({label}): {len(res)} modes bit-equal to the plain version")
    plain_modes = [k for k in out if " pool" not in k and "/2" not in k]
    key = max(plain_modes, key=lambda k: (k.endswith("pair"), k.startswith("deq"), out[k][3]))
    ms, plain_ms, b, _, _ = out[key]
    return dict(name="int8_quant", route="cuda", source="suo_slam_tpu_torch/csrc/int8_quant.cu",
                replaces="suo_slam_tpu/models/int8_forward.py:223", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None), out


def _k13_level(a, kw):
    """For a K12 call in its pool or junction mode (arguments a, kw): its
    kind and the K13 call, its plain version and the K13 -> K12 chain it
    replaced (K13's output, then K12's plain mode on it), as functions; None
    for a K12 call in neither mode."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    x, x2 = a[0], kw.get("x2")
    if kw.get("pool"):
        k13 = lambda: ik._int8_maxpool_cuda(x)

        def chain():
            p = k13()
            return p, ik._int8_quant_cuda(p, None, *a[2:])[1]

        return "max-pool", (x,), k13, lambda: ik.int8_maxpool_plain(x), chain
    if x2 is not None and x2.up:
        args = (x.q, x2.q, x.s, x2.s)
        k13 = lambda: ik._int8_upsample_add_cuda(*args)
        chain = lambda: ik._int8_quant_cuda(k13(), *a[1:], c_out=kw.get("c_out"))
        return "junction", args, k13, lambda: ik.int8_upsample_add_plain(*args), chain
    return None


def check_k13(dev, calls, time_plain=True):
    """K13, the earlier design of the hourglass's max-pool and junction (off
    the int8 forward since K12's pool and junction modes took them), at
    every level of the forward, on the inputs of the K12 calls that replaced
    it: K13 equal to its plain version, with its times; the fused K12 call
    bit-equal to the K13 -> K12 chain, both calls' device us in turns
    (fused, chain, chain, fused: every kernel of a call, from the profiler)
    and the fused call's bytes bound. Returns K13's JSON row and the rows of
    K12's pool and junction modes (their largest calls)."""
    import torch

    from suo_slam_tpu_torch.models import int8_kernels as ik

    out, fused_rows, levels = {}, {}, 0
    for key, (a, kw) in sorted(calls.items(), key=lambda t: str(t[0])):
        if key[0] != "int8_quant" or _k13_level(a, kw) is None:
            continue
        kind, k13_args, kf, pf, chain = _k13_level(a, kw)
        fused = lambda: ik._int8_quant_cuda(*a, **kw)
        k, p = kf(), pf()
        got, want = fused(), chain()
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K13 disagrees with its plain version at {key}")
        if not all((u is None and v is None) or torch.equal(u, v) for u, v in zip(got, want)):
            raise AssertionError(f"K12's {kind} mode disagrees with the K13 -> K12 chain at {key}")
        levels += 1
        name = "int8_maxpool" if kind == "max-pool" else "int8_upsample_add"
        b = bound(*_int8_traffic(name, k13_args, {}))
        ms = cuda_ms(kf, n=10, inner=5)
        plain_ms = cuda_ms(pf, n=5, inner=2)
        us, src = device_us(kf, "int8_pool_junction_kernel", n=5)
        _report(f"K13 {kind} ({list(k13_args[0].shape)}, device {us:.3f} us by {src})", 0.0,
                "0 (bit-equal)", ms, plain_ms, None, b)
        out[(kind, k13_args[0].numel())] = (ms, plain_ms, b)
        turns = {"fused": [], "chain": []}
        for turn in ("fused", "chain", "chain", "fused"):
            turns[turn].append(lib_device_us(fused if turn == "fused" else chain)[0])
        fb = bound(*_int8_traffic("int8_quant", a, kw))
        # the chain: K13, then K12 on its output (the pooled codes, the bf16 sum)
        mid = k if kind == "max-pool" else torch.empty(k13_args[0].shape, dtype=torch.bfloat16,
                                                       device="meta")
        cb = bound(_int8_traffic(name, k13_args, {})[0] + _int8_traffic(
            "int8_quant", (mid,) + tuple(a[1:]), {"c_out": kw.get("c_out")})[0], 0.0)
        log(f"[kernel] K12 {kind} mode ({_quant_mode(a, kw)}, {list(k13_args[0].shape)}): "
            f"bit-equal to the K13 -> K12 chain | device us in turns (fused, chain, chain, "
            f"fused): {[round(v, 3) for v in turns['fused'][:1] + turns['chain'] + turns['fused'][1:]]}"
            f" | bound {fb[0]:.5f} ms ({fb[1]}; the chain's {cb[0]:.5f})")
        fms = cuda_ms(fused, n=10, inner=5)
        fplain = (cuda_ms(lambda: ik.int8_quant_plain(*a, **kw), n=5, inner=2)
                  if time_plain else None)
        n = k13_args[0].numel()
        if kind not in fused_rows or n > fused_rows[kind][0]:
            fused_rows[kind] = (n, fms, fplain, fb)
    log(f"[kernel] K13 and K12's pool / junction modes: {levels} levels, each bit-equal")
    key = max((k for k in out if k[0] == "junction"), key=lambda k: k[1])
    ms, plain_ms, b = out[key]
    rows = [dict(name="int8_pool_junction", route="cuda",
                 source="suo_slam_tpu_torch/csrc/int8_pool_junction.cu",
                 replaces="suo_slam_tpu/models/int8_forward.py:292", max_abs_err=0.0, ms=ms,
                 plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)]
    for kind, name, line in (("max-pool", "int8_quant_pool", 286),
                             ("junction", "int8_quant_junction", 292)):
        _, fms, fplain, fb = fused_rows[kind]
        rows.append(dict(name=name, route="cuda", source="suo_slam_tpu_torch/csrc/int8_quant.cu",
                         replaces=f"suo_slam_tpu/models/int8_forward.py:{line}",
                         max_abs_err=0.0, ms=fms, plain_ms=fplain, bound_ms=fb[0],
                         bound_by=fb[1], library_ms=None))
    return rows



def check_k2_bf16(dev, raw16):
    """K2 on the int8 net's bf16 logits against its plain version, on both
    paths (the int8 head's contiguous NHWC logits take the dense path)."""
    from suo_slam_tpu_torch.ops import heatmap as hm

    paths = k2_paths(f"bf16 int8-net logits {list(raw16.shape)}", raw16,
                     n_bytes=raw16.numel() * 2)
    err, ms, us = paths["dense"]
    plain_ms = cuda_ms(lambda: hm.heatmap_readout_plain(raw16, 1e-6))
    n = raw16.numel()
    b = bound(n * 2 + N_OBJ * NK * 7 * 4, n * 24)
    _report(f"K2 heatmap_readout (bf16 logits {list(raw16.shape)}, dense path, device "
            f"{us:.3f} us; target <= {TARGET_US['K2 bf16']}, the earlier design "
            f"{EARLIER_US['K2 bf16']} us)", err, 1e-5, ms, plain_ms, None, b)
    return max(err, paths["strided (earlier)"][0])


def _with_plain_int8(fn):
    """fn() with the int8 wrappers routing CUDA tensors through the plain
    versions instead of K11-K13."""
    from suo_slam_tpu_torch.models import int8_kernels as ik

    ops = ("conv", "quant", "maxpool", "upsample_add")
    kernels = {op: getattr(ik, f"_int8_{op}_cuda") for op in ops}
    try:
        for op in ops:
            setattr(ik, f"_int8_{op}_cuda", getattr(ik, f"int8_{op}_plain"))
        return fn()
    finally:
        for op, f in kernels.items():
            setattr(ik, f"_int8_{op}_cuda", f)


def _net_device_ms(nets, n_crops, calls=3):
    """Device ms per call of each net in `nets` (name -> call) from one
    torch.profiler trace of `calls` calls: busy time, crops per second of
    device time, kernels per call, the port's kernels and the torch
    operations that hold the most device time."""
    from torch.autograd import DeviceType

    dev_ms = {}
    for name, f in nets.items():
        avg = traced(lambda: [f() for _ in range(calls)], lambda a: any(
            e.device_type == DeviceType.CUDA for e in a), f"{name} net")
        if avg is None:
            dev_ms[name] = "not measured"
            continue
        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        by = {k: sum(e.self_device_time_total for e in kern if f"{k}_kernel" in e.key)
              / (1e3 * calls) for k in INT8_KERNEL_NAMES + ("heatmap_readout", "norm_relu",
                                                            "upsample_add")}
        ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)[:6]
        busy = sum(e.self_device_time_total for e in kern) / (1e3 * calls)
        dev_ms[name] = {"busy": round(busy, 4), "crops/s": round(n_crops / busy * 1e3, 1),
                        "kernels": sum(e.count for e in kern) // calls,
                        "by kernel": {k: round(v, 4) for k, v in by.items() if v},
                        "by torch operation": {
                            e.key: round(e.self_device_time_total / (1e3 * calls), 4)
                            for e in ops}}
    return dev_ms


def _int8_128(dev, seed, net16, qw, scales, n=128):
    """Phase 8 at the JAX bench's batch, 128 crops: launches per prior-free
    forward, K11 at every distinct convolution and K12 in every mode
    bit-equal to their plain versions on the forward's own inputs (kernel
    and device times; the plain versions are not timed), then the int8 and
    bf16 nets' device ms per call and crops/s."""
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import int8_forward as i8

    g = torch.Generator(device=dev).manual_seed(seed + 128)
    crops = torch.rand((n, 256, 256, 3), device=dev, generator=g)
    apply_np = i8.make_int8_apply(net16, no_prior=True)
    f = lambda: apply_np(qw, scales, crops)
    f()
    torch.cuda.synchronize()
    kernels.reset_counts()
    f()
    torch.cuda.synchronize()
    c = kernels.counts()
    c = {k: c[k] for k in INT8_KERNELS + ("int8_pool_junction", "heatmap_readout")}
    log(f"[int8 {n}] launches per prior-free forward ({n} crops): {json.dumps(c)}")
    if tuple(c[k] for k in INT8_KERNELS + ("int8_pool_junction",)) != (185, 84, 9, 8, 0):
        raise AssertionError(f"int8 launches per forward at {n} crops: {c}")
    calls = _int8_calls(f)
    check_k11(dev, calls, f"{n} crops", stem=False, time_plain=False)
    check_k12(dev, calls, f"{n} crops", time_plain=False)
    del calls
    torch.cuda.empty_cache()

    def bf16_call():
        with torch.inference_mode():
            return net16(crops)

    log(f"[int8 {n}] full-width net device ms per call ({n} crops, 256x256, backbone + "
        f"readout, prior-free int8 and bf16): "
        + json.dumps(_net_device_ms({"int8": f, "bf16": bf16_call}, n)))
    del crops
    torch.cuda.empty_cache()


def phase_int8_only(dev, seed, sizes=(128, 8)):
    """`--int8-only`: phase 8's full-width prior-free int8 forward alone at
    128 and 8 crops (the seeded bf16 net, calibrated on 8 seeded crops):
    launches per forward, device ms per call by torch.profiler (busy time,
    kernels, the int8 kernels' share) over 5 calls and CUDA-event ms per
    call, against whichever package sits beside this script — run in two
    checkouts in turns, it compares them in one call."""
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.slam import kernels as sk

    net16 = sk.make_frame_inference(full_width_net(seed, torch.bfloat16), device=dev).net
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    scales = i8.calibrate(net16, [torch.rand((N_OBJ, 256, 256, 3), device=dev, generator=g)])
    qw = i8.quantize_weights(net16)
    apply_np = i8.make_int8_apply(net16, no_prior=True)
    out = {}
    for n in sizes:
        g = torch.Generator(device=dev).manual_seed(seed + n)
        crops = torch.rand((n, 256, 256, 3), device=dev, generator=g)
        f = lambda: apply_np(qw, scales, crops)
        f()
        torch.cuda.synchronize()
        kernels.reset_counts()
        f()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.counts().items() if v}
        ms = cuda_ms(f, n=5, inner=3, warmup=1)
        out[n] = {"launches": launches, "event_ms": ms,
                  "device": _net_device_ms({"int8": f}, n, calls=5)["int8"]}
        log(f"[int8 {n}] prior-free forward alone: " + json.dumps(out[n]))
        del crops
        torch.cuda.empty_cache()
    return out


def phase_int8(dev, rng, seed, net32, net16, crops, objs, scene):
    """int8 serving on the card (the module docstring's phase 8). Returns the
    kernels' JSON entries and the launches of the int8 path's runs."""
    import contextlib
    import io
    import os

    import torch

    from suo_slam_tpu_torch import calibrate_int8 as ci8
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.evaluate import Evaluator
    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig

    t0 = time.perf_counter()
    scales = i8.calibrate(net16, [crops])  # the worst-case all-ones prior
    qw = i8.quantize_weights(net16)
    apply, apply_np = i8.make_int8_apply(net16), i8.make_int8_apply(net16, no_prior=True)
    uv0 = torch.from_numpy(rng.uniform(-0.8, 0.8, (N_OBJ, NK, 2)).astype(np.float32)).to(dev)
    pv = torch.from_numpy(rng.uniform(size=(N_OBJ, NK)) < 0.4).to(dev)
    prior = hm.render_prior_heatmaps(uv0, pv, (64, 64), hm.prior_sigma_for((64, 64)))
    torch.cuda.synchronize()
    log(f"[int8] calibration ({len(scales)} points) and weight quantization "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    # launches per forward, then every distinct kernel call of a forward
    per_fwd = {}
    for name, f in (("with prior", lambda: apply(qw, scales, crops, prior)),
                    ("prior-free", lambda: apply_np(qw, scales, crops))):
        f()
        torch.cuda.synchronize()
        kernels.reset_counts()
        f()
        torch.cuda.synchronize()
        c = kernels.counts()
        per_fwd[name] = {k: c[k] for k in INT8_KERNELS + ("int8_pool_junction",
                                                          "heatmap_readout")}
    log(f"[int8] launches per forward (8 crops; K12's pool and junction modes counted in its "
        f"calls too; K13 off the path): {json.dumps(per_fwd)}")
    want = {"with prior": (186, 85), "prior-free": (185, 84)}
    for name, c in per_fwd.items():
        if tuple(c[k] for k in INT8_KERNELS + ("int8_pool_junction", "heatmap_readout")) != (
                want[name] + (9, 8, 0, 1)):
            raise AssertionError(f"int8 launches per forward ({name}): {c}")
    calls, traffic = {}, []
    calls.update(_int8_calls(lambda: apply(qw, scales, crops, prior)))
    calls.update(_int8_calls(lambda: apply_np(qw, scales, crops), traffic))
    tot = {}
    for name, nb, ops in traffic:
        t = tot.setdefault(name, [0, 0.0, 0.0, 0.0])
        t[0] += 1
        t[1] += nb
        t[2] += ops
        t[3] += bound(nb, ops, INT8_OPS_PER_S)[0]
    log("[int8] the prior-free forward's K11 / K12 calls (8 crops): calls, GB, G int8 "
        "operations and the sum of their bounds in ms: " + json.dumps(
            {k: [v[0], round(v[1] / 1e9, 4), round(v[2] / 1e9, 3), round(v[3], 4)]
             for k, v in tot.items()})
        + f"; total bound {sum(v[3] for v in tot.values()):.4f} ms")
    (k11, _), (k12, _) = check_k11(dev, calls), check_k12(dev, calls)
    entries = [k11, k12] + check_k13(dev, calls)
    del calls
    # the whole net: kernels against plain versions on the card, then against f32
    o8 = apply(qw, scales, crops, prior)
    o8p = _with_plain_int8(lambda: apply(qw, scales, crops, prior))
    torch.cuda.synchronize()
    if not torch.equal(o8.prob_logits, o8p.prob_logits):
        d = (o8.prob_logits.float() - o8p.prob_logits.float()).abs()
        raise AssertionError(f"int8 net: kernels and plain versions differ on "
                             f"{int((d > 0).sum())} logits (max {d.max().item()})")
    k2_err = check_k2_bf16(dev, o8.prob_logits)
    with torch.inference_mode():
        o32 = net32(crops, prior)
    cpu16 = full_width_net(seed, torch.bfloat16).eval()
    cpu32 = full_width_net(seed).eval()
    c2, p2 = crops[:2].cpu(), prior[:2].cpu()
    oc8 = i8.make_int8_apply(cpu16)(None, scales, c2, p2)
    with torch.inference_mode():
        oc32 = cpu32(c2, p2)
    gap = (o8.uv[:2].cpu() - o32.uv[:2].cpu()).abs()
    ref = (oc8.uv - oc32.uv).abs()
    card_all = (o8.uv - o32.uv).abs()
    same = torch.equal(o8.prob_logits[:2].cpu(), oc8.prob_logits)
    log(f"[int8] int8 net (8 crops, with prior) equal to its plain-version run on the card: "
        f"logits equal, uv max diff {(o8.uv - o8p.uv).abs().max().item():.2e}; uv |int8 - f32| "
        f"on the card: max {card_all.max().item():.4f} mean {card_all.mean().item():.5f} NDC; "
        f"the 2 crops: card max {gap.max().item():.4f} mean {gap.mean().item():.5f}, CPU max "
        f"{ref.max().item():.4f} mean {ref.mean().item():.5f} (gate 1.5x the CPU's); card and "
        f"CPU int8 logits equal: {same}")
    if not (torch.isfinite(o8.uv).all() and torch.isfinite(o8.cov).all()):
        raise AssertionError("int8 net: non-finite outputs")
    if not (gap.max() <= 1.5 * ref.max() and gap.mean() <= 1.5 * ref.mean()):
        raise AssertionError("int8 net on the card: uv farther from f32 than the CPU's int8 net")

    # host ms per call, int8 (prior-free program, as the frame's
    # non-symmetric group) and bf16 in turns (I B B I), and device ms
    def wall_ms(f, reps=10):
        vals = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                f()
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(vals[1:])

    def bf16_call():
        with torch.inference_mode():
            return net16(crops)

    nets = {"int8": lambda: apply_np(qw, scales, crops), "bf16": bf16_call}
    t = {}
    for turn in ("int8", "bf16", "bf16", "int8"):
        t.setdefault(turn, []).append(wall_ms(nets[turn]))
    log("[int8] full-width net ms per call (8 crops, 256x256, backbone + readout, prior-free; "
        "median of 10 synchronized calls, turns I B B I): "
        + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()})
        + "; device ms per call: " + json.dumps(_net_device_ms(nets, N_OBJ)))
    _int8_128(dev, seed, net16, qw, scales)

    # the evaluation entry point with a sidecar from calibrate_int8, then a
    # short SLAM run; the int8 path's launches
    base, root = _eval_root()
    ds = BopDataset(root, "test", bop_dset="ycbv", ignore_symmetry=True,
                    kp_config_root=os.path.join(root, "kp_configs"))
    sc, n_frames, n_crops = ci8.calibrate_dataset(net16, ds, n_frames=EVAL_VIEWS, device=dev)
    side = os.path.join(base, "int8_scales.npz")
    i8.save_scales(side, sc)
    log(f"[int8] calibrate_int8: {len(sc)} scales from {n_crops} crops of {n_frames} frames "
        f"-> {side}")
    kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, "", nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev, net=net16,
                       int8=True, int8_scales=side)
    ev.model_path = os.path.join(base, "results_int8")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = ev.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    text = buf.getvalue()
    outdir = os.path.join(ev.model_path, ev.method_name())
    if summary is None or f"int8 scales sidecar: {side}" not in text or not os.path.isfile(
            os.path.join(outdir, "summary.txt")):
        raise AssertionError(f"int8 evaluation leg failed:\n{text[-3000:]}")
    log(f"[int8] Evaluator(nviews=1, int8=True): {ev.method_name()} ran to its end, "
        f"{wall / EVAL_VIEWS * 1e3:.2f} ms per view over {EVAL_VIEWS} views; launches "
        + json.dumps({k: v for k, v in kernels.counts().items() if v}))
    engine = ObjectSlam(SlamConfig(int8_inference=True, int8_calib_frames=2), mesh_db=objs,
                        net=net16, device=dev)
    inf = GtPriorInfer(engine._infer, dev, seed)
    engine._infer = inf
    img = rng.uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    ids = np.arange(1, N_OBJ + 1)
    times, ok = [], []
    before = kernels.counts()
    for i in range(6):
        T_OtoC, bboxes, uv_gt = scene.frame(i)
        inf.set_frame(bboxes, uv_gt)
        t1 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks,
                            objs.masks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    results = engine.collect_results(final=True)
    counts = kernels.counts()
    for i in range(6):
        T_OtoC, _, _ = scene.frame(i)
        for o in range(N_OBJ):
            p = results[i]["poses"].get(o + 1, {}).get("T_OtoC")
            ok.append(p is not None and np.isfinite(p).all() and _add_ok(p, T_OtoC[o], objs, o))
    state = inf.fn.int8_state
    slam_counts = {k: counts[k] - before[k] for k in counts}
    log(f"[int8] SLAM, 6 frames, int8_calib_frames=2: {inf.n_prior_calls} with-prior int8 "
        f"calls, {state['n_calib']} calibration frames; ms per frame "
        f"{[round(x, 2) for x in times]}; ADD < 0.1 d for {float(np.mean(ok)):.3f} of "
        f"{len(ok)} poses; launches " + json.dumps({k: v for k, v in slam_counts.items() if v}))
    if inf.n_prior_calls == 0 or slam_counts["prior_render"] == 0 or state["n_calib"] != 2:
        raise AssertionError("int8 SLAM run: no with-prior int8 call, no K5 or no calibration")
    if float(np.mean(ok)) < 0.9:
        raise AssertionError(f"int8 SLAM run: ADD < 0.1 d for only {np.mean(ok):.3f}")
    missing = [k for k in INT8_KERNELS + ("roi_crop", "heatmap_readout", "prior_render",
                                          "pnp_ransac") if counts[k] == 0]
    if missing or any(counts[k] for k in OFF_PATH_KERNELS):
        raise AssertionError(f"kernels not launched on the int8 path: {missing}, or K3 / K4 / "
                             f"K7 / K22 / K13 launched: {[counts[k] for k in OFF_PATH_KERNELS]}")
    return entries, counts, k2_err


# training phase ------------------------------------------------------------------
TRAIN_VIEWS = 40  # YCB-V train_real keeps every 5th frame: 8 training frames
TRAIN_N = 32  # rows of the kernel checks' tensors: the CLI's step, 2 frames x 16 slots
# the train step's expected launches per forward (2 stacks x 2 modules x 256)
NORMS_PER_FWD, JUNCTIONS_PER_FWD = 180, 8


def write_train_split(root, objs, rng):
    """`train_real` beside phase 7's test split: TRAIN_VIEWS 480x640 PNG views
    with the YCB-V intrinsics, each a random 5-8 of the eight objects (so a
    batch pads its object slots), on phase 7's camera orbit."""
    import os

    scene = SlamScene(rng, objs, TRAIN_VIEWS)
    sdir = os.path.join(root, "train_real", "000000")
    for d in ("rgb", "mask_visib"):
        os.makedirs(os.path.join(sdir, d), exist_ok=True)
    cams, gts, gt_infos = {}, {}, {}
    for v in range(TRAIN_VIEWS):
        T, bboxes, _ = scene.frame(v)
        keep = np.sort(rng.choice(N_OBJ, int(rng.integers(5, N_OBJ + 1)), replace=False))
        img = np.full((H_IMG, W_IMG, 3), 40, np.uint8)
        gts[str(v)], gt_infos[str(v)] = [], []
        for o in keep:
            x1, y1, x2, y2 = (int(round(c)) for c in bboxes[o])
            img[y1:y2, x1:x2] = (60 + 20 * o, 200 - 15 * o, 90 + 10 * o)
            gts[str(v)].append({"obj_id": int(o) + 1,
                                "cam_R_m2c": T[o, :3, :3].reshape(-1).tolist(),
                                "cam_t_m2c": T[o, :3, 3].tolist()})
            x1, y1, x2, y2 = (float(c) for c in bboxes[o])
            gt_infos[str(v)].append({"bbox_obj": [x1, y1, x2 - x1, y2 - y1],
                                     "bbox_visib": [x1, y1, x2 - x1, y2 - y1],
                                     "visib_fract": 1.0, "px_count_visib": 1000})
        write_png(os.path.join(sdir, "rgb", f"{v:06d}.png"), img)
        cams[str(v)] = {"cam_K": YCBV_K.reshape(-1).tolist(), "depth_scale": 1.0}
    for name, d in (("scene_camera", cams), ("scene_gt", gts), ("scene_gt_info", gt_infos)):
        with open(os.path.join(sdir, f"{name}.json"), "w") as f:
            json.dump(d, f)


def _row_mask(dev):
    """TRAIN_N rows with every fourth one a padded slot (8 of 32)."""
    import torch

    return torch.arange(TRAIN_N, device=dev) % 4 != 3


def bn_clocks(label, fn, phases, rows, tag="[train]"):
    """SM clock cycles by phase of one L2-cold call (`fn(cycles)` launches
    the clocked instance; thread 0 of each block): the mean over the blocks
    that ran each phase, and the largest block's total."""
    import torch

    cyc = torch.zeros((rows, len(phases)), dtype=torch.int64, device="cuda")
    fn(cyc)
    cyc.zero_()
    buf = _L2_FLUSH["buf"]
    buf.sum()
    fn(cyc)
    r = cyc.cpu().double()
    mean = {k: round((r[:, i].sum() / max(int((r[:, i] > 0).sum()), 1)).item())
            for i, k in enumerate(phases)}
    log(f"{tag} {label}: SM cycles by phase, mean over the blocks that ran it "
        + json.dumps(mean) + f"; the slowest block {int(r.sum(1).max())} in all")
    return mean


def bn_kernel_of(name: str):
    """"K16" or "K17" for a kernel of `csrc/bn_train.cu` in a profiler
    trace (both designs: the fused kernels, and the split design's partial
    pass by its mode, finalizes and dx pass), None for any other."""
    import re

    if "bn_stats_fused_kernel" in name or "stats_finalize_kernel" in name:
        return "K16"
    if "bn_bwd_fused_kernel" in name or "bwd_finalize_kernel" in name \
            or re.search(r"(^|[^_\w])dx_kernel<", name):
        return "K17"
    m = re.search(r"(^|[^_\w])partial_kernel<[^,]+,\s*\d+,\s*(\d)", name)
    if m:
        return "K16" if m.group(2) == "0" else "K17"
    return None


def check_k16_k17(dev, rng):
    """K16 (masked batch statistics) and K17 (the norm + ReLU backward, with
    the statistics' terms) at the train step's norm shapes, N = 32 rows of
    which 8 padded, f32 and bf16, both designs: the stem norm (64 ch at
    128x128), the largest residual norm (256 ch at 64x64), a bottleneck norm
    (128 ch at 64x64) and two of the smallest (256 ch at 8x8, 128 ch at
    4x4). Statistics within 1e-6 relative (f64 sums in another order), K17's
    sums within 1e-5 of their scale, dx within 1e-5 of its largest magnitude
    in f32 and 1 bf16 ulp of it in bf16. The fused design (the main path)
    exactly: its K16 affine and running averages and its K17 scale gradient
    equal to the eager ops they replace, every output equal when a call is
    repeated, one kernel a call. Times at the largest shape with the L2
    flushed (`cuda_ms_cold`), the designs in turns (split, fused, fused,
    split), and SM cycles by phase of both; the library yardstick is
    F.batch_norm(training=True) + relu, forward (K16 + K8's work) and
    backward (K17's)."""
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models import hourglass as hg

    mask = _row_mask(dev).to(torch.uint8)  # as the net passes it
    shapes = [(TRAIN_N, 64, 128, 128), (TRAIN_N, 256, 64, 64), (TRAIN_N, 128, 64, 64),
              (TRAIN_N, 256, 8, 8), (TRAIN_N, 128, 4, 4)]
    err = {d: {"stats": 0.0, "sums": 0.0, "dx f32": 0.0, "dx bf16": 0.0} for d in hg.DESIGNS}
    exact = {"K16 affine": True, "K16 running": True, "K17 dscale": True, "repeat": True}
    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))
    for shape in shapes:
        C = shape[1]
        x32 = cl((rng.normal(size=shape) * 1.5 + rng.normal(size=(1, C, 1, 1))).astype(np.float32))
        dy32 = cl(rng.normal(size=shape).astype(np.float32))
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev) * 0.3
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            mp, vp = hg.bn_stats_plain(x, mask)
            rstd = torch.rsqrt(vp + 1e-5)
            inv = rstd * scale
            shift = bias - mp * inv
            p = hg.norm_relu_bwd_plain(x, dy, inv, shift, mp, rstd, mask)
            pf = hg.norm_relu_bwd_plain(x, dy, inv, shift)
            for design in hg.DESIGNS:
                e = err[design]
                mk, vk = hg._bn_stats_cuda(x, mask, design=design)
                torch.cuda.synchronize()
                rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-3)).max().item()
                e["stats"] = max(e["stats"], rel(mk, mp), rel(vk, vp))
                key = "dx f32" if dt == torch.float32 else "dx bf16"
                for kw, ref in ((dict(mean=mp, rstd=rstd, row_mask=mask), p), ({}, pf)):
                    k = hg._norm_relu_bwd_cuda(x, dy, inv, shift, design=design, **kw)
                    torch.cuda.synchronize()
                    for a, b in zip(k[1:], ref[1:]):
                        e["sums"] = max(e["sums"], (a - b).abs().max().item()
                                        / max(b.abs().max().item(), 1.0))
                    e[key] = max(e[key], (k[0].float() - ref[0].float()).abs().max().item()
                                 / ref[0].float().abs().max().item())
                    if design == "fused":
                        exact["K17 dscale"] &= torch.equal(k[3], k[2] * rstd if kw else k[2])
                        again = hg._norm_relu_bwd_cuda(x, dy, inv, shift, **kw)
                        exact["repeat"] &= same(k, again)
                if design == "fused":
                    rm = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev)
                    rv = torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)).to(dev)
                    rm0, rv0 = rm.clone(), rv.clone()
                    out = hg._bn_train_stats_cuda(x, mask, scale, bias, 1e-5, rm, rv, 0.9)
                    m2, v2, rs2, iv2, sh2 = out
                    exact["repeat"] &= torch.equal(m2, mk) and torch.equal(v2, vk)
                    r_e = torch.rsqrt(vk + 1e-5)
                    i_e = r_e * scale
                    exact["K16 affine"] &= (torch.equal(rs2, r_e) and torch.equal(iv2, i_e)
                                            and torch.equal(sh2, bias - mk * i_e))
                    exact["K16 running"] &= (torch.equal(rm, rm0 * 0.9 + mk * (1 - 0.9))
                                             and torch.equal(rv, rv0 * 0.9 + vk * (1 - 0.9)))
                    exact["repeat"] &= same(out, hg._bn_train_stats_cuda(x, mask, scale, bias,
                                                                         1e-5, rm0, rv0, 0.9))
    for design in hg.DESIGNS:
        log(f"[train] K16 / K17 ({design} design) errors over {len(shapes)} shapes, f32 and "
            f"bf16, 8 of 32 rows padded, K17 in both modes: "
            + json.dumps({k: f"{v:.3e}" for k, v in err[design].items()})
            + " (tol: stats 1e-6 relative, sums 1e-5 of scale, dx f32 1e-5 of max, bf16 2^-8)")
    log(f"[train] fused K16 / K17 bit-equal to the eager ops they replace and across "
        f"repeated calls: {json.dumps(exact)}")
    for design, e in err.items():
        if not (e["stats"] <= 1e-6 and e["sums"] <= 1e-5 and e["dx f32"] <= 1e-5
                and e["dx bf16"] <= 2.0 ** -8):
            raise AssertionError(f"K16 / K17 ({design}) disagree with their plain versions: {e}")
    if not all(exact.values()):
        raise AssertionError(f"fused K16 / K17 not bit-equal: {exact}")

    # kernels a call, by the nodes of a captured graph
    big = shapes[1]
    x = cl((rng.normal(size=big) * 1.5).astype(np.float32)).to(torch.bfloat16)
    dy = cl(rng.normal(size=big).astype(np.float32)).to(torch.bfloat16)
    C = big[1]
    one, zero = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    rm, rv = zero.clone(), one.clone()
    mean, _, rstd, inv, shift = hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9)
    per_call = {}
    for label, fn in (
            ("K16 fused", lambda: hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9)),
            ("K17 fused train", lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd,
                                                               mask)),
            ("K17 fused fixed", lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift)),
            ("K16 split", lambda: hg._bn_stats_cuda(x, mask, design="split")),
            ("K17 split train", lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd,
                                                               mask, design="split"))):
        per_call[label] = launches_per_call(fn)
    log(f"[train] K16 / K17 kernels per call (captured graph, bf16 {list(big)}): "
        + json.dumps(per_call))
    if any(per_call[k] != 1 for k in ("K16 fused", "K17 fused train", "K17 fused fixed")):
        raise AssertionError(f"fused K16 / K17 launch more than one kernel a call: {per_call}")
    if any(w[0].any().item() for w in hg._bn_work.values()):
        raise AssertionError("a fused launch left its grid-barrier counters non-zero")

    # times at the largest shape, L2 flushed, the designs in turns; clocks
    lu = launch_us()
    log(f"[train] an empty kernel in a replayed graph: {lu:.3f} us of device time (a launch's "
        f"cost, against the grid barriers' SM cycles below)")
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = cl((rng.normal(size=big) * 1.5).astype(np.float32)).to(dt)
        dy = cl(rng.normal(size=big).astype(np.float32)).to(dt)
        mp, vp = hg.bn_stats_plain(x, mask)
        rstd = torch.rsqrt(vp + 1e-5)
        inv, shift = rstd, -mp * rstd
        w = torch.ones(C, device=dev, requires_grad=True)
        bb = torch.zeros(C, device=dev, requires_grad=True)
        xg = x.detach().requires_grad_(True)
        y = torch.relu(F.batch_norm(xg, None, None, w, bb, training=True))
        dyl = dy.contiguous()
        rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
        k16 = {"fused": lambda: hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9),
               "split": lambda: hg._bn_stats_cuda(x, mask, design="split")}
        k17 = {d: (lambda d=d: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mp, rstd, mask,
                                                      design=d)) for d in hg.DESIGNS}
        lib16 = lambda: torch.relu(F.batch_norm(x, None, None, None, None, training=True))
        lib17 = lambda: torch.autograd.grad(y, (xg, w, bb), dyl, retain_graph=True)
        n = x.numel()
        es = x.element_size()
        real = int(mask.sum().item()) * n // big[0]
        res = {}
        for label, fns, plain, lib, nbytes, ops in (
                ("K16 bn_stats", k16, lambda: hg.bn_stats_plain(x, mask), lib16,
                 real * es + 11 * C * 4, 3 * real),
                ("K17 norm_relu_bwd", k17,
                 lambda: hg.norm_relu_bwd_plain(x, dy, inv, shift, mp, rstd, mask), lib17,
                 3 * n * es + 7 * C * 4, 12 * n)):
            cold = {d: [] for d in hg.DESIGNS}
            for d in ("split", "fused", "fused", "split"):
                cold[d].append(1e3 * cuda_ms_cold(fns[d]))
            ms, plain_ms, lib_ms = cuda_ms(fns["fused"]), cuda_ms(plain, n=5, inner=2), \
                cuda_ms(lib)
            lib_cold = 1e3 * cuda_ms_cold(lib)
            b = bound(nbytes, ops)
            _report(f"{label} ({name}, {list(x.shape)}, 8 of 32 rows padded; L2-cold device us, "
                    f"in turns: fused {[round(v, 3) for v in cold['fused']]}, split "
                    f"{[round(v, 3) for v in cold['split']]}, library {lib_cold:.3f})",
                    err["fused"]["stats" if label.startswith("K16") else f"dx {name}"],
                    "1e-6 rel" if label.startswith("K16") else
                    ("1e-5 of max" if name == "f32" else "2^-8 of max"),
                    ms, plain_ms, lib_ms, b, lib)
            res[label] = (ms, plain_ms, lib_ms, b, statistics.mean(cold["fused"]),
                          statistics.mean(cold["split"]))
        kc = lambda d: (lambda cyc: hg._bn_stats_cuda(x, mask, design=d, cycles=cyc))
        bc = lambda d: (lambda cyc: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mp, rstd, mask,
                                                           design=d, cycles=cyc))
        it = x.element_size()
        plan16 = hg.plan_bn("stats", big[0], big[2] * big[3], C, it, True, hg._multiprocessors(dev))
        plan17 = hg.plan_bn("bwd", big[0], big[2] * big[3], C, it, True, hg._multiprocessors(dev))
        rows_split = max(hg.plan_split(big[0], big[2] * big[3], C, it, True), -(-C // 32))
        for d, rows16, rows17 in (("fused", plan16.grid, plan17.grid),
                                  ("split", rows_split, rows_split)):
            bn_clocks(f"K16 {d} ({name}, {list(big)})", kc(d), hg.BN_STATS_PHASES, rows16)
            bn_clocks(f"K17 {d} ({name}, {list(big)})", bc(d), hg.BN_BWD_PHASES, rows17)
        out[name] = res
    entries = []
    for label, kname, src, rep in (
            ("K16 bn_stats", "bn_stats", "suo_slam_tpu_torch/csrc/bn_train.cu",
             "suo_slam_tpu/models/hourglass.py:69"),
            ("K17 norm_relu_bwd", "norm_relu_bwd", "suo_slam_tpu_torch/csrc/bn_train.cu",
             "suo_slam_tpu/models/hourglass.py:88")):
        ms, plain_ms, lib_ms, b, _, _ = out["bf16"][label]
        e = err["fused"]
        entries.append(dict(name=kname, route="cuda", source=src, replaces=rep,
                            max_abs_err=e["stats"] if kname == "bn_stats" else e["dx bf16"],
                            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                            library_ms=lib_ms))
    return entries


def bn_step_shapes(dev, rng):
    """K16 and K17 at every norm shape of the bf16 train step (one train-mode
    forward of the full-width net on 32 crops, 8 padded, records them): one
    L2-cold call of each design per shape, and the sums over the step's 180
    calls of each — where a step's K16 / K17 time goes."""
    import collections

    import torch

    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    mask = _row_mask(dev).to(torch.uint8)
    net = PkpNet(dtype=torch.bfloat16).to(dev)
    shapes = collections.Counter()
    real = hg.bn_train_stats

    def spy(x, *a, **kw):
        shapes[tuple(x.shape)] += 1
        return real(x, *a, **kw)

    crops = torch.from_numpy(rng.uniform(0, 1, (TRAIN_N, 256, 256, 3)).astype(np.float32)).to(dev)
    hg.bn_train_stats = spy
    try:
        with torch.no_grad():
            net(crops, train=True, row_mask=mask.bool())
    finally:
        hg.bn_train_stats = real
    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    rows, tot = [], collections.Counter()
    for shape, n in sorted(shapes.items(), key=lambda kv: -kv[0][2]):
        C = shape[1]
        x = cl(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        dy = cl(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
        one, zero = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        rm, rv = zero.clone(), one.clone()
        mean, _, rstd, inv, shift = hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9)
        t = {"K16 fused": lambda: hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv, 0.9),
             "K16 split": lambda: hg._bn_stats_cuda(x, mask, design="split"),
             "K17 fused": lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, mask),
             "K17 split": lambda: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, mask,
                                                         design="split")}
        us = {k: 1e3 * cuda_ms_cold(f, n=7) for k, f in t.items()}
        for k, v in us.items():
            tot[k] += n * v
        rows.append([list(shape), n] + [round(us[k], 2) for k in t])
        if shape in ((TRAIN_N, 128, 64, 64), (TRAIN_N, 128, 16, 16), (TRAIN_N, 128, 4, 4)):
            it = x.element_size()
            for kind, fn, phases in (
                    ("stats", lambda cyc: hg._bn_stats_cuda(x, mask, cycles=cyc),
                     hg.BN_STATS_PHASES),
                    ("bwd", lambda cyc: hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, mask,
                                                               cycles=cyc), hg.BN_BWD_PHASES)):
                plan = hg.plan_bn(kind, shape[0], shape[2] * shape[3], C, it, True,
                                  hg._multiprocessors(dev))
                bn_clocks(f"{'K16' if kind == 'stats' else 'K17'} fused ({list(shape)}, grid "
                          f"{plan.grid})", fn, phases, plan.grid)
    log("[train] K16 / K17 by norm shape of the bf16 step (shape, calls, L2-cold device us a "
        "call: K16 fused, K16 split, K17 fused, K17 split): " + json.dumps(rows))
    log("[train] ... summed over the step's calls (ms): "
        + json.dumps({k: round(v / 1e3, 3) for k, v in tot.items()}))
    return tot


K18_LEVELS = (64, 32, 16, 8)  # the train step's junctions: up1 [32, 256, H, H]


def k18_cold_us(dev, seed=18):
    """K18's L2-cold device us (`cuda_ms_cold`) at the four junctions of the
    train step in f32 and bf16, beside the bytes bound: rows [dtype, H, us,
    bound us]."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    rng = np.random.default_rng(seed)
    rows = []
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for H in K18_LEVELS:
            dy = torch.from_numpy(rng.normal(size=(TRAIN_N, 256, H, H)).astype(np.float32)).to(
                dev).to(dt).contiguous(memory_format=torch.channels_last)
            us = 1e3 * cuda_ms_cold(lambda: hg._upsample_add_bwd_cuda(dy))
            b = 1e6 * dy.numel() * dy.element_size() * 5 / 4 / HBM_BYTES_PER_S
            rows.append([name, H, round(us, 3), round(b, 3)])
    return rows


def check_k18(dev, rng):
    """K18 at each junction of the train step (up1 [32, 256, H, H] for H =
    64, 32, 16, 8), f32 and bf16, on its vector route and its scalar route
    (a dy one value off 16 bytes): equal to its plain version
    (the same f32 additions in the same order, one rounding); L2-cold device
    us at every level beside the bytes bound (`k18_cold_us`). Library: 4 x
    F.avg_pool2d(dy, 2)."""
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models import hourglass as hg

    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    err, routes, n = 0.0, {}, 0
    for H in K18_LEVELS:
        dy32 = cl(rng.normal(size=(TRAIN_N, 256, H, H)).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            dy = dy32.to(dt)
            base = torch.empty(1 + dy.numel(), dtype=dt, device=dev)
            odd = base[1:].view(TRAIN_N, H, H, 256).permute(0, 3, 1, 2).copy_(dy)
            p = hg.upsample_add_bwd_plain(dy)
            for x in (dy, odd):
                r = hg.plan_upsample_bwd(tuple(x.shape), x.element_size(), x.data_ptr())
                routes[r] = routes.get(r, 0) + 1
                k = hg._upsample_add_bwd_cuda(x)
                torch.cuda.synchronize()
                err = max(err, (k.float() - p.float()).abs().max().item())
                n += 1
    log(f"[train] K18 max abs err over 4 levels, f32 and bf16, both routes "
        f"({json.dumps(routes)}): {err:.3e} (tol 0)")
    want = {hg.K18_VECTOR: 2 * len(K18_LEVELS), hg.K18_SCALAR: 2 * len(K18_LEVELS)}
    if n != 4 * len(K18_LEVELS) or routes != want or err != 0.0:
        raise AssertionError(f"K18 disagrees with its plain version: {err} over {n} calls, "
                             f"routes {routes} (expected {want})")
    cold = k18_cold_us(dev)
    log("[train] K18 L2-cold device us by level (dtype, H of dy [32, 256, H, H], us, "
        "bytes bound us): " + json.dumps(cold))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        dy = cl(rng.normal(size=(TRAIN_N, 256, 64, 64)).astype(np.float32)).to(dt)
        fn = lambda: hg._upsample_add_bwd_cuda(dy)
        lib = lambda: F.avg_pool2d(dy, 2) * 4
        ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(lambda: hg.upsample_add_bwd_plain(dy)), cuda_ms(lib)
        us, src = lib_device_us(fn)
        c, lib_cold = 1e3 * cuda_ms_cold(fn), 1e3 * cuda_ms_cold(lib)
        b = bound(dy.numel() * dy.element_size() * 5 / 4, dy.numel())
        _report(f"K18 upsample_add_bwd ({name}, dy {list(dy.shape)}, device {us:.3f} us by "
                f"{src} with warm inputs, {c:.3f} us L2-cold; library {lib_cold:.3f} us "
                f"L2-cold)", err, "0", ms, plain_ms, lib_ms, b, lib)
        out[name] = (ms, plain_ms, lib_ms, b)
    ms, plain_ms, lib_ms, b = out["bf16"]
    return dict(name="upsample_add_bwd", route="cuda",
                source="suo_slam_tpu_torch/csrc/upsample_add.cu",
                replaces="suo_slam_tpu/models/hourglass.py:35", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


def check_k19(dev, rng):
    """K19 on the readout's [32, 64, 64, 41] logits (the head's NHWC view of
    channels_last, and its transpose), f32 and bf16, on both paths — dense
    (a cluster of 8 CTAs per crop, the main path's since `plan_readout_bwd`
    sends the head's layout there) and strided (the earlier design) —
    against the plain version: within 1e-4 of the largest gradient in f32
    (f - E[f] cancels near a heatmap's peak, and the two round the moments'
    sums in other orders), 2^-7 in bf16 (one rounding of each); the dense
    path one kernel a call, a crop's gradient the same bits in the 32-crop
    call and alone, a captured call replaying the eager bits; L2-cold device
    us of both paths in turns (dense, strided, strided, dense) for each
    dtype and order. Library: autograd of softmax + einsum."""
    import torch

    from suo_slam_tpu_torch.ops import heatmap as hm

    x = torch.from_numpy((rng.normal(size=(TRAIN_N, 41, 64, 64)) * 3).astype(np.float32)).to(
        dev).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
         for s in ((TRAIN_N, 41, 2), (TRAIN_N, 41, 2, 2), (TRAIN_N, 41))]
    errs, cold = {}, {}
    tols = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    for dt in (torch.float32, torch.bfloat16):
        for order, view in (("plain", x), ("transposed", x.transpose(1, 2))):
            v = view.to(dt)
            label = f"{str(dt)[6:]} {order}"
            plan = hm.plan_readout_bwd(v.shape, v.stride(), v.element_size(), v.data_ptr())
            if plan.path != hm.DENSE:
                raise AssertionError(f"K19 {label}: the head's layout took the strided path")
            p = hm.heatmap_readout_bwd_plain(v, *g).float()
            for path, name in ((None, "dense"), (hm.STRIDED, "strided")):
                k = hm._heatmap_readout_bwd_cuda(v, *g, path=path)
                torch.cuda.synchronize()
                if k.stride() != v.stride() or k.dtype != dt:
                    raise AssertionError(f"K19 {label} {name}: did not write the logits' layout")
                errs[(label, name)] = ((k.float() - p).abs().max() / p.abs().max()).item()
                if errs[(label, name)] > tols[dt]:
                    raise AssertionError(f"K19 {label} {name} disagrees with its plain version: "
                                         f"{errs[(label, name)]}")
            dense = lambda: hm._heatmap_readout_bwd_cuda(v, *g)
            strided = lambda: hm._heatmap_readout_bwd_cuda(v, *g, path=hm.STRIDED)
            if launches_per_call(dense) != 1:
                raise AssertionError(f"K19 {label}: the dense path is not one kernel a call")
            full = dense()
            bad = [n for n in (0, TRAIN_N // 2 - 3, TRAIN_N - 1) if not torch.equal(
                full[n], hm._heatmap_readout_bwd_cuda(v[n:n + 1], *(t[n:n + 1] for t in g))[0])]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                captured = dense()
            graph.replay()
            torch.cuda.synchronize()
            if bad or not torch.equal(captured, full):
                raise AssertionError(f"K19 {label}: crops {bad} differ alone, or the captured "
                                     f"call replays other bits")
            del graph, captured
            turns = {"dense": [], "strided": []}
            for turn in ("dense", "strided", "strided", "dense"):
                turns[turn].append(1e3 * cuda_ms_cold(dense if turn == "dense" else strided))
            cold[label] = turns
            log(f"[train] K19 {label} {list(v.shape)}: max err dense {errs[(label, 'dense')]:.3e}, "
                f"strided {errs[(label, 'strided')]:.3e} of the largest gradient (tol "
                f"{tols[dt]:.1e}); dense one kernel a call, batch-invariant, graph replay "
                f"equal; L2-cold device us in turns (dense, strided, strided, dense): "
                f"{[round(t, 3) for t in turns['dense'][:1] + turns['strided'] + turns['dense'][1:]]}"
                f" (targets: dense <= {60 if dt == torch.float32 else 45} us)")
    err = max(e for (label, name), e in errs.items()
              if label.startswith("float32") and name == "dense")
    xg = x.detach().requires_grad_(True)
    H, W = 64, 64
    u, v = hm.ndc_grid(H, W, torch.float32, dev)
    feats = torch.stack([u, v, u * u, v * v, u * v], -1).reshape(H * W, 5)
    p = torch.softmax(xg.reshape(TRAIN_N, H * W, 41), 1)
    m = torch.einsum("npk,pf->nkf", p, feats)
    gm = torch.randn_like(m)
    fn = lambda: hm._heatmap_readout_bwd_cuda(x, *g)
    lib = lambda: torch.autograd.grad(m, xg, gm, retain_graph=True)
    ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(lambda: hm.heatmap_readout_bwd_plain(x, *g)), \
        cuda_ms(lib)
    us, src = lib_device_us(fn)
    lib_cold = 1e3 * cuda_ms_cold(lib)
    b = bound(2 * x.numel() * 4 + TRAIN_N * 41 * 7 * 4, 40 * x.numel())
    b16 = bound(2 * x.numel() * 2 + TRAIN_N * 41 * 7 * 4, 40 * x.numel())
    dcold = statistics.median(cold["float32 plain"]["dense"])
    _report(f"K19 heatmap_readout_bwd (f32, {list(x.shape)}, dense path, device {us:.3f} us by "
            f"{src} with warm inputs, {dcold:.3f} us L2-cold; bf16 bound {b16[0]:.5f} ms; "
            f"library {lib_cold:.3f} us L2-cold)", err, "1e-4 of max", ms, plain_ms, lib_ms, b,
            lib)
    return dict(name="heatmap_readout_bwd", route="cuda",
                source="suo_slam_tpu_torch/csrc/heatmap_readout.cu",
                replaces="suo_slam_tpu/models/pkpnet.py:125", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper of the train step (K1, K2, K5, K8, K9, K16-K21)
    takes its plain version on CUDA tensors for the duration; no kernel may
    launch meanwhile (a call site the patches miss would raise here)."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.ops import roi

    patches = [(hg, "_norm_relu_fwd", hg.norm_relu_plain),
               (hg, "bn_train_stats", hg.bn_train_stats_plain),
               (hg, "norm_relu_bwd", hg.norm_relu_bwd_plain),
               (hg, "_upsample_add_fwd", hg.upsample_add_plain),
               (hg, "upsample_add_bwd", hg.upsample_add_bwd_plain),
               (hg, "group_norm_relu", hg.group_norm_relu_plain),
               (hg, "group_norm_relu_bwd", hg.group_norm_relu_bwd_plain),
               (hm, "_heatmap_readout_fwd", hm.heatmap_readout_plain),
               (hm, "heatmap_readout_bwd", hm.heatmap_readout_bwd_plain),
               (hm, "render_prior_heatmaps", hm.render_prior_heatmaps_plain),
               (roi, "roi_crop_batch", roi.roi_crop_batch_plain)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    before = kernels.counts()
    try:
        for m, k, f in patches:
            setattr(m, k, f)
        yield
        launched = {k: v - before[k] for k, v in kernels.counts().items() if v != before[k]}
        if launched:
            raise AssertionError(f"kernels launched while the plain versions ran: {launched}")
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


@contextlib.contextmanager
def plain_on_cuda_counter():
    """Counts calls of the train path's plain versions on CUDA tensors (the
    wrappers must launch their kernels there)."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.ops import heatmap as hm
    from suo_slam_tpu_torch.ops import roi

    hits = {}
    names = [(hg, "norm_relu_plain"), (hg, "bn_train_stats_plain"), (hg, "norm_relu_bwd_plain"),
             (hg, "upsample_add_plain"), (hg, "upsample_add_bwd_plain"),
             (hg, "group_norm_relu_plain"), (hg, "group_norm_relu_bwd_plain"),
             (hm, "heatmap_readout_plain"), (hm, "heatmap_readout_bwd_plain"),
             (hm, "render_prior_heatmaps_plain"), (roi, "roi_crop_batch_plain")]
    saved = [(m, k, getattr(m, k)) for m, k in names]

    def wrap(k, f):
        def g(*a, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                hits[k] = hits.get(k, 0) + 1
            return f(*a, **kw)
        return g

    try:
        for m, k, f in saved:
            setattr(m, k, wrap(k, f))
        yield hits
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


def _first_batch(root, dev, seed, truncate_obj=16):
    """The CLI's first training batch (2 frames, `gt+noise` boxes, priors),
    padded to 16 object slots, on the card."""
    import os

    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.data.loader import ConcatLoader
    from suo_slam_tpu_torch.train import harness

    ds = BopDataset(root, "train_real", bop_dset="ycbv", ignore_symmetry=False, no_aug=True,
                    det_type="gt+noise", kp_config_root=os.path.join(root, "kp_configs"),
                    seed=seed)
    np_batch = next(iter(ConcatLoader([ds], 2, truncate_obj, seed=seed, workers=1).epoch()))
    return harness.to_batch(np_batch, dev, o_pad=truncate_obj)


def _step_record(dt, seed, batch, keep, dev, norm="batch", calc_cov=True):
    """One full-width train step from seeded flax-style weights: loss, its
    terms, every parameter gradient and the new running statistics
    (`calc_cov=False`: the -u net and loss)."""
    import torch

    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    net = PkpNet(n_stack=2, n_modules=2, features=256, dtype=dt, norm=norm,
                 calc_cov=calc_cov).to(dev)
    state = harness.init_state(net, seed=seed)
    _, m = harness.make_train_step()(state, batch, 0.0, dropout_mask=keep)
    torch.cuda.synchronize()
    named = dict(net.named_parameters())
    conv_bias = {k for k in named if k.endswith(".bias") and k[:-5] + ".weight" in named
                 and k not in ("classifier.bias", "backbone.heads.1.bias")}
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={k: p.grad.float().clone() for k, p in named.items() if k not in conv_bias},
                stats={k: b.clone() for k, b in net.named_buffers()})


def _distances(a, b):
    import torch

    terms = max(abs(a["metrics"][k] - v) / max(abs(v), 1e-3) for k, v in b["metrics"].items())
    grad = max(((a["grads"][k] - b["grads"][k]).abs().max()
                / b["grads"][k].abs().max().clamp(min=1e-30)).item() for k in b["grads"])
    va = torch.cat([g.reshape(-1).double() for g in a["grads"].values()])
    vb = torch.cat([g.reshape(-1).double() for g in b["grads"].values()])
    cos = (va @ vb / va.norm() / vb.norm()).item()
    stats = max([((a["stats"][k] - b["stats"][k]).abs().max()
                  / b["stats"][k].abs().max().clamp(min=1.0)).item() for k in b["stats"]],
                default=0.0)
    return dict(terms=terms, grad=grad, cos=cos, stats=stats)


# fixed gates of the full-width step, kernels against plain versions: the
# forward's kernels reproduce their plain versions' rounding (K8, K9, K2 and
# K1 / K5 exactly, K16 to f64 sums), so the loss, its terms and the
# statistics are held to 1e-5; the gradients go through the
# backward kernels' other summation orders, which the ill-conditioned step
# (see tests/test_torch_train_step.py) amplifies, so they are held by the
# whole gradient's cosine and, in f32, by each tensor within half its
# largest magnitude (an all-zero or sign-flipped gradient is 1 or 2 away)
STEP_GATES = {"f32": dict(terms=1e-5, stats=1e-5, cos=0.999, grad=0.5),
              "bf16": dict(terms=1e-2, stats=2e-2, cos=0.99)}


@contextlib.contextmanager
def _pinned_cudnn():
    """cuDNN deterministic, no autotuning: a convolution's algorithm is then
    a function of its shapes alone."""
    import torch

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench


def train_step_parity(dev, seed, root, norm="batch", calc_cov=True):
    """One full-width train step (2 x 16 crop slots, the CLI's first batch,
    seeded flax-style weights, one dropout mask) with the kernels against the
    same step with every wrapper on its plain version, in f32 and bf16, cuDNN
    deterministic, within the fixed `STEP_GATES`: loss and terms (relative),
    running statistics (against their scale), gradients (the whole
    gradient's cosine; each tensor against its largest magnitude). bf16
    rounds each activation to 2^-9 relative: its terms and statistics are
    held to 1e-2 and 2e-2. `calc_cov=False`: the -u step (L2 + the
    readout's spread, through K2 and K19)."""
    import torch

    batch = _first_batch(root, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand((32, NK), generator=g, device=dev) < 0.5
    out = {}
    with _pinned_cudnn():
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            gate = STEP_GATES[name]
            kern = _step_record(dt, seed, batch, keep, dev, norm, calc_cov)
            with plain_versions():
                plain = _step_record(dt, seed, batch, keep, dev, norm, calc_cov)
            d = _distances(kern, plain)
            log(f"[train] full-width {'' if calc_cov else '-u '}step ({name}, norm={norm}), "
                f"kernels vs plain: "
                + json.dumps({k: f"{v:.6e}" for k, v in d.items()})
                + f" (gates {json.dumps(gate)}); loss {kern['metrics']['loss']:.6f}"
                + f" (plain {plain['metrics']['loss']:.6f})")
            ok = (d["terms"] <= gate["terms"] and d["stats"] <= gate["stats"]
                  and d["cos"] >= gate["cos"] and d["grad"] <= gate.get("grad", np.inf))
            finite = all(np.isfinite(v) for v in kern["metrics"].values())
            if not (ok and finite):
                raise AssertionError(f"train step ({name}, norm={norm}, calc_cov={calc_cov}): "
                                     f"kernels vs plain {d}, gates {gate}")
            out[name] = d
    return out


def _k18_step_ms(events):
    """(device ms, launches) of K18 in a step's CUDA events."""
    k = [e for e in events if "upsample_add_bwd" in e.key]
    return sum(e.self_device_time_total for e in k) / 1e3, sum(e.count for e in k)


def step_timing(dev, seed, root, norm="batch"):
    """The bf16 full-width step's host ms (median of 5 synchronized steps),
    device ms and kernels (torch.profiler over one step), busy share, peak
    memory and launches per step, of the BatchNorm net or (`norm="group"`)
    the GroupNorm net; the norm kernels' share of the device time (K16 /
    K17, or K20 / K21), and for the group net the layout of the dy each K21
    call receives (a dy that is not channels_last would cost a copy)."""
    import torch
    from torch.autograd import DeviceType

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    batch = _first_batch(root, dev, seed)
    net = PkpNet(dtype=torch.bfloat16, norm=norm).to(dev)
    state = harness.init_state(net, seed=seed)
    step = harness.make_train_step()
    for _ in range(2):
        state, _ = step(state, batch, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    dy_layouts = {"channels_last": 0, "other": 0}
    real_bwd = hg.group_norm_relu_bwd

    def spy(x, dy, *a):
        dy_layouts["channels_last" if dy.is_contiguous(memory_format=torch.channels_last)
                   else "other"] += 1
        return real_bwd(x, dy, *a)

    # the route of K19's calls (the planner is absent from a checkout older
    # than K19's dense path: every call then takes the strided kernel)
    from suo_slam_tpu_torch.ops import heatmap as hm

    k19_routes = {}
    real_k19 = hm.heatmap_readout_bwd

    def k19_spy(logits, *a):
        plan = getattr(hm, "plan_readout_bwd", None)
        r = "strided (no planner)" if plan is None else "dense" if plan(
            logits.shape, logits.stride(), logits.element_size(),
            logits.data_ptr()).path == hm.DENSE else "strided"
        k19_routes[r] = k19_routes.get(r, 0) + 1
        return real_k19(logits, *a)

    # K18's calls: the bytes of each dy, for the bound summed over them
    k18_bytes = []
    real_k18 = hg.upsample_add_bwd

    def k18_spy(dy):
        k18_bytes.append(dy.numel() * dy.element_size() * 5 / 4)
        return real_k18(dy)

    hg.group_norm_relu_bwd, hm.heatmap_readout_bwd, hg.upsample_add_bwd = spy, k19_spy, k18_spy
    try:
        state, _ = step(state, batch, 0.0)
        torch.cuda.synchronize()
    finally:
        hg.group_norm_relu_bwd, hm.heatmap_readout_bwd = real_bwd, real_k19
        hg.upsample_add_bwd = real_k18
    per_step = {k: v for k, v in kernels.counts().items() if v}
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, m = step(state, batch, 0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host = statistics.median(times)
    # kernels only: a record_function range (Adam's `Optimizer.step`) also
    # shows on the device's timeline, spanning kernels counted already
    kern = lambda a: [e for e in a if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
    avg = traced(lambda: step(state, batch, 0.0), lambda a: len(kern(a)) > 0, "train step")
    group = norm == "group"
    tag = "[group]" if group else "[train]"
    names, kind_of = (("K20", "K21"), gn_kernel_of) if group else (("K16", "K17"), bn_kernel_of)
    bn = {k: [0.0, 0] for k in names}
    k19_ms = k18_ms = "not measured"
    if avg is None:
        dev_ms, n_k, bn, copies = "not measured", "not measured", "not measured", "not measured"
    else:
        k19 = [e for e in kern(avg) if "heatmap_readout_bwd_kernel" in e.key]
        k19_ms = sum(e.self_device_time_total for e in k19) / 1e3
        log(f"{tag} the step's K19 (readout backward): {k19_ms:.4f} ms of device time in "
            f"{sum(e.count for e in k19)} launches ({[e.key[:48] for e in k19]}); routes of its "
            f"calls: {json.dumps(k19_routes)}")
        k18_ms = _k18_step_ms(kern(avg))
        log(f"{tag} the step's K18 (junction backward): "
            f"{k18_ms[0]:.4f} ms of device time in {k18_ms[1]} launches; bytes bound "
            f"{1e3 * sum(k18_bytes) / HBM_BYTES_PER_S:.4f} ms summed over its "
            f"{len(k18_bytes)} calls")
        dev_ms = sum(e.self_device_time_total for e in kern(avg)) / 1e3
        n_k = sum(e.count for e in kern(avg))
        top = sorted(kern(avg), key=lambda e: -e.self_device_time_total)[:14]
        log(f"{tag} the step's device time by kernel (ms, launches): " + json.dumps(
            [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count] for e in top]))
        for e in kern(avg):
            k = kind_of(e.key)
            if k is not None:
                bn[k][0] += e.self_device_time_total / 1e3
                bn[k][1] += e.count
        copies = sum(e.count for e in kern(avg) if "copy" in e.key.lower())
        log(f"{tag} the step's {' / '.join(names)} kernels (device ms, kernels): "
            + json.dumps(bn) + f"; together {bn[names[0]][0] + bn[names[1]][0]:.3f} ms, "
            f"{(bn[names[0]][0] + bn[names[1]][0]) / dev_ms:.3f} of the device time; "
            f"{copies} copy kernels in the step")
    busy = dev_ms / host if isinstance(dev_ms, float) else "not measured"
    log(f"{tag} full-width bf16 step, norm={norm} (2 frames x 16 slots, 256x256 crops): host "
        f"{host:.2f} ms (median of 5: {[round(t, 2) for t in times]}), device {dev_ms} ms in "
        f"{n_k} kernels, busy share {busy}, peak memory {peak:.2f} GiB; launches per step "
        + json.dumps(per_step) + (f"; dy of K21's calls: {json.dumps(dy_layouts)}" if group
                                  else ""))
    if group:
        want = {"group_norm_relu": NORMS_PER_FWD, "group_norm_relu_bwd": NORMS_PER_FWD,
                "bn_stats": 0, "norm_relu_bwd": 0, "norm_relu": 0}
    else:
        want = {"bn_stats": NORMS_PER_FWD, "norm_relu_bwd": NORMS_PER_FWD,
                "norm_relu": NORMS_PER_FWD}
    want.update({"upsample_add": JUNCTIONS_PER_FWD, "upsample_add_bwd": JUNCTIONS_PER_FWD,
                 "heatmap_readout": 1, "heatmap_readout_bwd": 1, "roi_crop": 1,
                 "prior_render": 1})
    if any(per_step.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"launches per train step {per_step}, expected {want}")
    if hasattr(hm, "plan_readout_bwd") and k19_routes != {"dense": 1}:
        raise AssertionError(f"the step's readout backward did not take K19's dense path: "
                             f"{k19_routes}")
    return dict(host_ms=host, device_ms=dev_ms, kernels=n_k, busy=busy, peak_gib=peak,
                norm_kernels=bn, host_runs=times, dy_layouts=dy_layouts, k19_ms=k19_ms,
                k19_routes=k19_routes, k18_ms=k18_ms,
                k18_bound_ms=1e3 * sum(k18_bytes) / HBM_BYTES_PER_S)


def phase_step_only(dev, seed, norm="batch"):
    """`--step-only`: phase 9's (phase 10's with `norm="group"`) train-step
    timing alone (`step_timing` on phase 7's and 9's trees), against
    whichever package sits beside this script — run in two checkouts in
    turns, it compares them in one call."""
    base, root = _eval_root()
    rng = np.random.default_rng(seed + 2)
    objs = EvalObjects(rng)
    write_bop_tree(root, objs, [SlamScene(rng, objs, EVAL_VIEWS)])
    write_train_split(root, EvalObjects(np.random.default_rng(seed + 2)),
                      np.random.default_rng(seed + 9))
    return step_timing(dev, seed, root, norm)


def overfit(dev, seed, root, steps=30):
    """30 steps on one fixed batch (full width, bf16, epoch 0's weights):
    the mean loss of the last 5 must fall below that of the first 5."""
    import torch

    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    batch = _first_batch(root, dev, seed + 5)
    state = harness.init_state(PkpNet(dtype=torch.bfloat16).to(dev), seed=seed + 5)
    step = harness.make_train_step()
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, 0.0)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"[train] overfit of one batch, {steps} steps: loss {[round(x, 4) for x in losses]}; "
        f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"overfit: the loss did not fall ({first} -> {last})")
    return first, last


def u_step_kernels(dev, seed, root):
    """The bf16 -u step (no covariance head) beside the covariance step, each
    from seeded weights on the CLI's first batch: launches per step (the
    counters: K2 and K19 once each), host ms (median of 5 synchronized
    steps), device ms and kernels by torch.profiler over one step, and the
    kernels that would form a probability map (a softmax): none."""
    import torch
    from torch.autograd import DeviceType

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    batch = _first_batch(root, dev, seed)
    kern = lambda a: [e for e in a if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
    out = {}
    for label, calc_cov in (("cov", True), ("-u", False)):
        net = PkpNet(dtype=torch.bfloat16, calc_cov=calc_cov).to(dev)
        state = harness.init_state(net, seed=seed)
        step = harness.make_train_step()
        for _ in range(2):
            state, _ = step(state, batch, 0.0)
        torch.cuda.synchronize()
        kernels.reset_counts()
        state, m = step(state, batch, 0.0)
        torch.cuda.synchronize()
        per_step = {k: v for k, v in kernels.counts().items() if v}
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, m = step(state, batch, 0.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        avg = traced(lambda: step(state, batch, 0.0), lambda a: len(kern(a)) > 0,
                     f"{label} train step")
        if avg is None:
            dev_ms = n_k = "not measured"
            softmax = []
        else:
            dev_ms = sum(e.self_device_time_total for e in kern(avg)) / 1e3
            n_k = sum(e.count for e in kern(avg))
            softmax = [e.key[:60] for e in kern(avg) if "softmax" in e.key.lower()]
        out[label] = dict(host_ms=statistics.median(times), device_ms=dev_ms, kernels=n_k,
                          launches=per_step, softmax=softmax,
                          var_loss=float(m["var_loss"]))
        log(f"[train] full-width bf16 {label} step: host {out[label]['host_ms']:.2f} ms "
            f"(median of 5: {[round(t, 2) for t in times]}), device {dev_ms} ms in {n_k} "
            f"kernels; K2 / K19 launches {per_step.get('heatmap_readout')} / "
            f"{per_step.get('heatmap_readout_bwd')}; softmax kernels {softmax}; var_loss "
            f"{out[label]['var_loss']:.6f}")
    u = out["-u"]
    if (u["launches"].get("heatmap_readout") != 1 or u["launches"].get("heatmap_readout_bwd") != 1
            or u["softmax"] or not np.isfinite(u["var_loss"])):
        raise AssertionError(f"-u step: {u}")
    if isinstance(u["kernels"], int) and isinstance(out["cov"]["kernels"], int) \
            and u["kernels"] > out["cov"]["kernels"] + 16:
        raise AssertionError(f"-u step: {u['kernels']} kernels against the covariance step's "
                             f"{out['cov']['kernels']}")
    return out


def loader_timing(root, seed, workers=4, epochs=2, copies=6, split="train_real"):
    """Host ms a batch of the training loader over one of phase 9's splits
    concatenated `copies` times (`train_real`: 48 480x640 PNG frames;
    augmentations on, 2 frames a batch, 24 batches an epoch): in line (1 worker),
    `workers` threads and `workers` processes, after one warm-up batch (the
    pool's start in process mode, timed apart); the modes' first batches
    bit-equal; the machine's CPU count."""
    import os

    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.data.loader import ConcatLoader

    def make(w, mode):
        ds = [BopDataset(root, split, bop_dset="ycbv", ignore_symmetry=False,
                         det_type="gt+noise", kp_config_root=os.path.join(root, "kp_configs"),
                         seed=123 + i) for i in range(copies)]
        return ConcatLoader(ds, 2, 16, seed=seed, workers=w, mode=mode)

    out, firsts = {}, {}
    for label, w, mode in (("inline", 1, "thread"), ("thread", workers, "thread"),
                           ("process", workers, "process")):
        loader = make(w, mode)
        try:
            t0 = time.perf_counter()
            firsts[label] = next(iter(loader.epoch(shuffle=False, seed=1)))
            warm = time.perf_counter() - t0
            n, t1 = 0, time.perf_counter()
            for _ in range(epochs):
                for _ in loader.epoch():
                    n += 1
            out[label] = dict(ms_per_batch=(time.perf_counter() - t1) * 1e3 / n, batches=n,
                              first_batch_s=warm, workers=w)
        finally:
            loader.close()
    cpus = os.cpu_count()
    avail = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else cpus
    log(f"[train] loader, {split} x {copies}, 480x640 augmented, 2 frames a batch, {out['inline']['batches']} "
        f"batches a mode, host ms a batch: "
        + json.dumps({k: round(v["ms_per_batch"], 2) for k, v in out.items()})
        + f" (workers {workers}; first batch s "
        + json.dumps({k: round(v["first_batch_s"], 2) for k, v in out.items()})
        + f"); CPUs {cpus}, available {avail}")
    for label in ("thread", "process"):
        a, b = firsts["inline"], firsts[label]
        if set(a) != set(b) or any(not np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"loader ({split}): the {label} mode's first batch differs "
                                 "from in-line")
    return dict(out, cpus=cpus, cpus_available=avail)


def _cli_run(argv, work):
    """`python -m suo_slam_tpu_torch.train` in process, from `work`: (rc, its
    output, wall s, launches, plain versions called on CUDA tensors, the
    host clock at each train step's call)."""
    import io
    import os

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.train import __main__ as cli
    from suo_slam_tpu_torch.train import harness

    stamps, make = [], harness.make_train_step

    def make_timed(*a, **kw):
        step = make(*a, **kw)

        def timed(*sa, **skw):
            stamps.append(time.perf_counter())
            return step(*sa, **skw)
        return timed

    cwd = os.getcwd()
    os.chdir(work)
    harness.make_train_step = make_timed
    try:
        buf = io.StringIO()
        kernels.reset_counts()
        t1 = time.perf_counter()
        with plain_on_cuda_counter() as hits, contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
            torch.cuda.synchronize()
        return (rc, buf.getvalue(), time.perf_counter() - t1, kernels.counts(), dict(hits),
                stamps)
    finally:
        harness.make_train_step = make
        os.chdir(cwd)


def _epoch_stats(text, stamps=()):
    """(epoch s, the CLI's printed sec/it, s between consecutive train
    steps' calls: loading and the step's host time, the steady sec/it) from
    the training CLI's output and `_cli_run`'s step clock."""
    import re

    secs = [float(x) for x in re.findall(r"Epoch \d+ done in ([\d.]+)s", text)]
    its = [float(x) for x in re.findall(r"sec/it=([\d.]+)", text)]
    gaps = [round(b - a, 3) for a, b in zip(stamps, stamps[1:])]
    return secs, its, gaps


def _want_launches(steps, vals, dumps):
    """The training CLI's launches of the BatchNorm net: `steps` train steps,
    `vals` validation batches and `dumps` per-epoch prediction dumps (one
    crop and one prior-free forward each: K1, K8, K9 and K2, no K5)."""
    fwd = steps + vals + dumps
    return {"bn_stats": NORMS_PER_FWD * steps, "norm_relu_bwd": NORMS_PER_FWD * steps,
            "upsample_add_bwd": JUNCTIONS_PER_FWD * steps, "heatmap_readout_bwd": steps,
            "norm_relu": NORMS_PER_FWD * fwd, "upsample_add": JUNCTIONS_PER_FWD * fwd,
            "heatmap_readout": fwd, "roi_crop": fwd, "prior_render": steps + vals}


def phase_train(dev, seed):
    """Training on the card (the module docstring's phase 9). Returns the
    K16-K19 entries, the launches of the CLI run and those of the -u CLI
    run."""
    import io
    import os
    import re
    import shutil

    from suo_slam_tpu_torch.evaluate import Evaluator

    base, root = _eval_root()
    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    write_train_split(root, EvalObjects(np.random.default_rng(seed + 2)), rng)
    log(f"[train] train_real split of {TRAIN_VIEWS} views written in "
        f"{time.perf_counter() - t0:.2f} s")
    entries = check_k16_k17(dev, rng) + [check_k18(dev, rng), check_k19(dev, rng)]
    bn_step_shapes(dev, rng)
    train_step_parity(dev, seed, root)
    train_step_parity(dev, seed, root, calc_cov=False)
    step_timing(dev, seed, root)
    u_step_kernels(dev, seed, root)
    overfit(dev, seed, root)

    # the CLI, full width and bf16 (its defaults), from the repository's
    # results directory contract, then its auto-resume
    work = os.path.join(base, "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = ["--device", dev.type, "--dataset", "ycbv", "--data_split", "real", "--no_augmentations",
            "--steps_per_epoch", "4", "--val_steps", "2", "--data_root", root,
            "--kp_config_root", os.path.join(root, "kp_configs")]
    rc, text, wall, counts, hits, stamps = _cli_run(argv + ["--epochs", "2"], work)
    rc2, text2 = _cli_run(argv + ["--epochs", "3"], work)[:2]
    with open(os.path.join(work, "cli.log"), "w") as f:
        f.write(text + "\n---- resume ----\n" + text2)
    (outdir,) = [os.path.join(work, "results", d) for d in os.listdir(os.path.join(work, "results"))]
    losses = [float(x) for x in re.findall(r"train loss ([-\d.eE+naninf]+)", text)]
    files = sorted(os.listdir(outdir))
    log(f"[train] CLI, 2 epochs x 4 steps + 2 val batches, full width bf16: rc {rc}, "
        f"{wall:.2f} s; epoch train losses {losses}; epoch s, sec/it, s between steps "
        f"{_epoch_stats(text, stamps)}; files {files}")
    for line in text.splitlines():
        if line.startswith(("Epoch", "Training on", "Validating")):
            log(f"[train]   {line.strip()}")
    want = _want_launches(8, 4, 4)  # a train and a test dump per epoch
    got = {k: counts[k] for k in want}
    log(f"[train] CLI launches: {json.dumps(got)} (want {json.dumps(want)}); plain versions "
        f"on CUDA tensors: {json.dumps(hits)}")
    need = {f"checkpoint-{e}{s}" for e in (0, 1) for s in ("", ".meta.json")} | {
        "checkpoint-latest", "checkpoint-latest.meta.json", "params.txt"}
    if rc != 0 or not need <= set(files) or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"training CLI: rc {rc}, files {files}, losses {losses}:\n"
                             f"{text[-3000:]}")
    if got != want or hits:
        raise AssertionError(f"training CLI launches {got} (want {want}), plain on CUDA {hits}")
    if rc2 != 0 or "Auto-resuming from" not in text2 or "Epoch: 2 [" not in text2 \
            or not os.path.isfile(os.path.join(outdir, "checkpoint-2")):
        raise AssertionError(f"training CLI did not auto-resume at epoch 2:\n{text2[-3000:]}")
    log("[train] second run: auto-resumed at epoch 2, wrote checkpoint-2")
    check_epoch_dumps(outdir, epochs=3)

    # the trained checkpoint through the evaluation entry point
    ck = os.path.join(outdir, "checkpoint-latest")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, ck, nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev)
        ev.model_path = os.path.join(base, "results_trained")
        summary = ev.run()
    if summary is None or ev.model_epoch != 2:
        raise AssertionError(f"Evaluator on the trained checkpoint:\n{buf.getvalue()[-3000:]}")
    log(f"[train] Evaluator(nviews=1) on {ck} (epoch {ev.model_epoch}): ran to its end, "
        f"{ev.method_name()}")
    plot_cov_run(dev, root, ck, os.path.join(base, "plot_cov"))
    sweep_ycbv(dev, root, os.path.join(outdir, "model_best"))
    loader_timing(root, seed)
    u_counts = train_cli_more(dev, base, root)
    phase_train_jpeg(dev, seed, base, root)
    return entries, counts, u_counts


def check_epoch_dumps(outdir, epochs):
    """The training CLI's per-epoch prediction dumps: a train and a test
    folder per epoch with a 2-panel sample.png, and viz_best holding one
    epoch's test dump."""
    import os

    from suo_slam_tpu_torch.data import png

    shapes, data = {}, {}
    for e in range(epochs):
        for split in ("train", "test"):
            path = os.path.join(outdir, f"viz_{split}_epoch_{e}", "sample.png")
            shapes[f"{split} {e}"] = png.imread(path).shape if os.path.isfile(path) else None
            if split == "test" and shapes[f"{split} {e}"]:
                data[e] = open(path, "rb").read()
    best = os.path.join(outdir, "viz_best", "sample.png")
    best_of = [e for e, d in data.items() if os.path.isfile(best) and open(best, "rb").read() == d]
    log(f"[train] per-epoch dumps: {json.dumps(shapes)}; viz_best is epoch {best_of}'s test dump")
    if any(v != (H_IMG, 2 * W_IMG, 3) for v in shapes.values()) or not best_of:
        raise AssertionError(f"training CLI dumps: {shapes}, viz_best of {best_of}")


def sweep_ycbv(dev, root, ck):
    """The YCB-V paper sweep (`suo_slam_tpu_torch/scripts/eval_all_ycbv.sh`)
    as a subprocess on phase 7's tree with `ck`: its 5 runs and table.txt's
    5 blocks, the seconds it took."""
    import os
    import re
    import signal

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "suo_slam_tpu_torch",
                          "scripts", "eval_all_ycbv.sh")
    env = {k: v for k, v in os.environ.items() if k not in ("DISPLAY", "WAYLAND_DISPLAY")}
    cmd = ["bash", script, ck, "--detection_type", "gt", "--device", dev.type, "--data_root",
           root, "--kp_config_root", os.path.join(root, "kp_configs")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(ck), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("the YCB-V sweep ran past 600 s")
    sec = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(ck), "sweep_ycbv.log"), "w") as f:
        f.write(text)
    table = os.path.join(os.path.dirname(ck), "table.txt")
    body = open(table).read() if os.path.isfile(table) else ""
    blocks = re.findall(r"^==== (.*) ====$", body, re.M)
    cams = re.findall(r"NOTE: ([\d.]+)% of camera poses found", body)
    frames = [len([f for f in os.listdir(os.path.join(os.path.dirname(b), "viz_images"))
                   if f.endswith(".png")]) for b in blocks]
    log(f"[train] YCB-V sweep (eval_all_ycbv.sh) on the trained {os.path.basename(ck)}: rc "
        f"{proc.returncode}, {sec:.1f} s; table.txt blocks "
        f"{[os.path.basename(os.path.dirname(b)) for b in blocks]}; camera poses found "
        f"{cams} %; frames written per run {frames}")
    if proc.returncode != 0 or len(blocks) != 5 or text.count("RUN: --nviews") != 5:
        raise AssertionError(f"the YCB-V sweep: rc {proc.returncode}, {len(blocks)} blocks:\n"
                             f"{text[-3000:]}")


def plot_cov_run(dev, root, ck, out):
    """`python -m suo_slam_tpu_torch.plot_cov` in process on a trained
    checkpoint over the `train_real` split: both files, the line."""
    import io
    import os
    import shutil

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch import plot_cov

    shutil.rmtree(out, ignore_errors=True)
    buf = io.StringIO()
    kernels.reset_counts()
    t0 = time.perf_counter()
    with plain_on_cuda_counter() as hits, contextlib.redirect_stdout(buf):
        rc = plot_cov.main(["-c", ck, "--dataset", "ycbv", "--split", "train_real",
                            "--data_root", root, "--kp_config_root",
                            os.path.join(root, "kp_configs"), "--out", out,
                            "--device", dev.type])
    wall = time.perf_counter() - t0
    got = {k: v for k, v in kernels.counts().items() if v}
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    line = open(os.path.join(out, "percent_sigma_inbounds.txt")).read().strip() \
        if "percent_sigma_inbounds.txt" in files else None
    log(f"[train] plot_cov on {os.path.basename(ck)} over train_real: rc {rc}, {wall:.2f} s, "
        f"\"{line}\"; files {files}; launches {json.dumps(got)}; plain versions on CUDA "
        f"tensors {json.dumps(hits)}")
    if rc != 0 or files != ["percent_sigma_inbounds.txt", "sigma_plot.png"] or hits \
            or not got.get("roi_crop") or not got.get("heatmap_readout"):
        raise AssertionError(f"plot_cov: rc {rc}, files {files}, launches {got}, plain {hits}:\n"
                             f"{buf.getvalue()[-2000:]}")


def train_cli_more(dev, base, root):
    """The training CLI at full width, bf16, augmentations on: (1) `-u
    --loader process --workers 4`, 1 epoch x 4 steps + 2 validation batches,
    its checkpoint then through `Evaluator(nviews=1, no_network_cov=True)`;
    (2) `--use_cache` (thread mode), 1 epoch x 4 steps. Each: exact
    launches (K2 and K19 once a step), no plain version on a CUDA tensor,
    epoch s and sec/it. Returns run 1's launches."""
    import io
    import os
    import shutil

    from suo_slam_tpu_torch.evaluate import Evaluator

    common = ["--device", dev.type, "--dataset", "ycbv", "--data_split", "real",
              "--epochs", "1", "--steps_per_epoch", "4", "--data_root", root,
              "--kp_config_root", os.path.join(root, "kp_configs")]
    runs = [("-u, process loader", ["-u", "--loader", "process", "--workers", "4",
                                    "--val_steps", "2"], 4, 2, 2),
            ("cache, thread loader", ["--use_cache", "--no_val"], 4, 0, 1)]
    cache = os.path.join(root, "train_real.suocache")
    if os.path.exists(cache):
        os.remove(cache)
    u_counts = None
    for i, (label, flags, steps, vals, dumps) in enumerate(runs):
        work = os.path.join(base, f"train_cli_{i + 1}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        rc, text, wall, counts, hits, stamps = _cli_run(common + flags, work)
        with open(os.path.join(work, "cli.log"), "w") as f:
            f.write(text)
        want = _want_launches(steps, vals, dumps)
        got = {k: counts[k] for k in want}
        log(f"[train] CLI run {i + 1} ({label}), augmentations on, 1 epoch x {steps} steps + "
            f"{vals} val batches, full width bf16: rc {rc}, {wall:.2f} s; epoch s, sec/it, s "
            f"between steps {_epoch_stats(text, stamps)}; launches {json.dumps(got)} (want {json.dumps(want)}); "
            f"plain versions on CUDA tensors {json.dumps(hits)}")
        for line in text.splitlines():
            if line.startswith(("Epoch", "Training on", "Native cache", "Packing")):
                log(f"[train]   {line.strip()}")
        if rc != 0 or got != want or hits or len(_epoch_stats(text)[0]) != 1:
            raise AssertionError(f"training CLI run {i + 1}: rc {rc}, launches {got} (want "
                                 f"{want}), plain on CUDA {hits}:\n{text[-3000:]}")
        if i == 0:
            u_counts = counts
            (run,) = os.listdir(os.path.join(work, "results"))
            ck = os.path.join(work, "results", run, "checkpoint-latest")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ev = Evaluator("ycbv", root, ck, nviews=1, detection_type="gt", no_viz=True,
                               no_network_cov=True, kp_config_root=os.path.join(root, "kp_configs"),
                               device=dev)
                ev.model_path = os.path.join(base, "results_trained_u")
                summary = ev.run()
            if summary is None or ev.model_epoch != 0:
                raise AssertionError(f"Evaluator(no_network_cov=True) on the -u checkpoint:\n"
                                     f"{buf.getvalue()[-3000:]}")
            log(f"[train] Evaluator(nviews=1, no_network_cov=True) on the -u checkpoint: ran "
                f"to its end, {ev.method_name()}")
        elif not os.path.isfile(cache):
            raise AssertionError(f"--use_cache wrote no {cache}")
    return u_counts


SYNT_VIEWS = 16  # train_synt and train_pbr keep every frame
VOC_IMAGES = 8


def _texture(rng, h, w, level, spread=14.0):
    """A uint8 [h, w, 3] surface: `level` (a colour) plus seeded noise."""
    return np.clip(np.asarray(level, np.float32) + rng.normal(0, spread, (h, w, 3)), 0,
                   255).astype(np.uint8)


def write_jpeg_splits(base, root, objs, rng):
    """`train_synt` (480x640 PNG frames) and `train_pbr` (the same frames as
    JPEG, quality 95, 4:2:0, written by `data/jpeg.py`'s encoder) beside
    `train_real`: SYNT_VIEWS views of 5-8 of the eight objects over textured
    surroundings, with PNG depth maps that are 0 off the objects (the
    synthetic splits' background mask); and a VOC directory of VOC_IMAGES
    JPEGs at 500x375 and 375x500, one gray and one with a restart interval,
    at `<bop_root>/VOCdevkit/VOC2012/JPEGImages`. Returns the VOC directory
    and one pbr frame's path."""
    import os

    from suo_slam_tpu_torch.data import jpeg

    scene = SlamScene(rng, objs, SYNT_VIEWS)
    dirs = {sp: os.path.join(root, sp, "000000") for sp in ("train_synt", "train_pbr")}
    for sdir in dirs.values():
        for d in ("rgb", "depth", "mask_visib"):
            os.makedirs(os.path.join(sdir, d), exist_ok=True)
    cams, gts, gt_infos = {}, {}, {}
    for v in range(SYNT_VIEWS):
        T, bboxes, _ = scene.frame(v)
        keep = np.sort(rng.choice(N_OBJ, int(rng.integers(5, N_OBJ + 1)), replace=False))
        img = _texture(rng, H_IMG, W_IMG, (45, 50, 40))
        depth = np.zeros((H_IMG, W_IMG), np.uint16)
        gts[str(v)], gt_infos[str(v)] = [], []
        for o in keep:
            x1, y1, x2, y2 = (int(round(c)) for c in bboxes[o])
            img[y1:y2, x1:x2] = _texture(rng, y2 - y1, x2 - x1,
                                         (60 + 20 * o, 200 - 15 * o, 90 + 10 * o))
            depth[y1:y2, x1:x2] = int(T[o, 2, 3])
            gts[str(v)].append({"obj_id": int(o) + 1,
                                "cam_R_m2c": T[o, :3, :3].reshape(-1).tolist(),
                                "cam_t_m2c": T[o, :3, 3].tolist()})
            x1, y1, x2, y2 = (float(c) for c in bboxes[o])
            gt_infos[str(v)].append({"bbox_obj": [x1, y1, x2 - x1, y2 - y1],
                                     "bbox_visib": [x1, y1, x2 - x1, y2 - y1],
                                     "visib_fract": 1.0, "px_count_visib": 1000})
        write_png(os.path.join(dirs["train_synt"], "rgb", f"{v:06d}.png"), img)
        jpeg.imwrite(os.path.join(dirs["train_pbr"], "rgb", f"{v:06d}.jpg"), img, 95, "4:2:0")
        for sdir in dirs.values():
            write_png(os.path.join(sdir, "depth", f"{v:06d}.png"), depth)
        cams[str(v)] = {"cam_K": YCBV_K.reshape(-1).tolist(), "depth_scale": 1.0}
    for sdir in dirs.values():
        for name, d in (("scene_camera", cams), ("scene_gt", gts),
                        ("scene_gt_info", gt_infos)):
            with open(os.path.join(sdir, f"{name}.json"), "w") as f:
                json.dump(d, f)
    voc = os.path.join(base, "bop_datasets", "VOCdevkit", "VOC2012", "JPEGImages")
    os.makedirs(voc, exist_ok=True)
    for i in range(VOC_IMAGES):
        h, w = (375, 500) if i % 2 == 0 else (500, 375)
        img = _texture(rng, h, w, rng.uniform(60, 200, 3), spread=30.0)
        if i == 1:
            img = img[..., 1]
        jpeg.imwrite(os.path.join(voc, f"2008_{i:06d}.jpg"), img, 90, "4:2:0",
                     restart_interval=4 if i == 2 else 0)
    return voc, os.path.join(dirs["train_pbr"], "rgb", "000000.jpg")


def _median_ms(fn, n=20):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def jpeg_timing(root, voc, pbr_frame):
    """Host ms on the host CPU, one thread, median of 20: the
    decoder on a 640x480 q95 4:2:0 pbr frame, `png.imread` on a 480x640
    `train_real` frame, `resize_linear` 500x375 -> 480x640 (a VOC
    background); then the decoder's SHA-256 digests on `jpeg.check_images()`
    against the ones the CPU tests pin (and tie to `cv2.imread`)."""
    import os

    from suo_slam_tpu_torch.data import augmentations, jpeg, png

    data = open(pbr_frame, "rb").read()
    real = os.path.join(root, "train_real", "000000", "rgb", "000000.png")
    bg = jpeg.imread(os.path.join(voc, "2008_000000.jpg"))
    out = dict(jpeg_decode_ms=_median_ms(lambda: jpeg.decode(data)),
               png_imread_ms=_median_ms(lambda: png.imread(real)),
               resize_linear_ms=_median_ms(lambda: augmentations.resize_linear(bg, (640, 480))),
               pbr_frame_bytes=len(data), bg_shape=list(bg.shape))
    log(f"[train] host ms, one thread, median of 20: " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v for k, v in out.items()}))
    got = jpeg.check_digests()
    log(f"[train] JPEG decoder digests (this checkout's g++ build): {json.dumps(got)}")
    if got != jpeg.CHECK_SHA256:
        raise AssertionError(f"JPEG decoder digests {got} differ from the CPU tests' pins "
                             f"{jpeg.CHECK_SHA256}")
    log("[train] JPEG decoder digests equal the CPU tests' pins (cv2.imread's bits)")
    return out


def train_cli_jpeg(dev, base, root):
    """The training CLI at full width, bf16, augmentations on, 1 epoch x 4
    steps + 2 validation batches: (1) `--data_split real+synt` with the VOC
    directory present (train_synt composited), (2) `--data_split pbr
    --use_cache` (the cache packed from the JPEG frames). Each: epoch s,
    sec/it, exact launches and no plain version on a CUDA tensor."""
    import os
    import shutil

    common = ["--device", dev.type, "--dataset", "ycbv", "--epochs", "1", "--steps_per_epoch",
              "4", "--val_steps", "2", "--data_root", root,
              "--kp_config_root", os.path.join(root, "kp_configs")]
    runs = [("real+synt, VOC present", ["--data_split", "real+synt"]),
            ("pbr, cache", ["--data_split", "pbr", "--use_cache"])]
    cache = os.path.join(root, "train_pbr.suocache")
    if os.path.exists(cache):
        os.remove(cache)
    for i, (label, flags) in enumerate(runs):
        work = os.path.join(base, f"train_cli_jpeg_{i + 1}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        rc, text, wall, counts, hits, stamps = _cli_run(common + flags, work)
        with open(os.path.join(work, "cli.log"), "w") as f:
            f.write(text)
        want = _want_launches(4, 2, 2)
        got = {k: counts[k] for k in want}
        log(f"[train] CLI ({label}), augmentations on, 1 epoch x 4 steps + 2 val batches, "
            f"full width bf16: rc {rc}, {wall:.2f} s; epoch s, sec/it, s between steps "
            f"{_epoch_stats(text, stamps)}; launches {json.dumps(got)} (want "
            f"{json.dumps(want)}); plain versions on CUDA tensors {json.dumps(hits)}")
        for line in text.splitlines():
            if line.startswith(("Epoch", "Training on", "Native cache", "Packing", "WARNING")):
                log(f"[train]   {line.strip()}")
        if rc != 0 or got != want or hits or len(_epoch_stats(text)[0]) != 1 \
                or "WARNING: no background images" in text:
            raise AssertionError(f"training CLI ({label}): rc {rc}, launches {got} (want "
                                 f"{want}), plain on CUDA {hits}:\n{text[-3000:]}")
    if not os.path.isfile(cache):
        raise AssertionError(f"--use_cache wrote no {cache}")


def phase_train_jpeg(dev, seed, base, root):
    """Phase 9's JPEG part: the synthetic and pbr splits and VOC written by
    the port's encoder, the decoder's and resize's host ms, the digests, the
    loader on each split in its three modes, two CLI runs."""
    t0 = time.perf_counter()
    voc, pbr_frame = write_jpeg_splits(base, root, EvalObjects(np.random.default_rng(seed + 2)),
                                       np.random.default_rng(seed + 20))
    log(f"[train] train_synt and train_pbr ({SYNT_VIEWS} views each) and {VOC_IMAGES} VOC "
        f"JPEGs written in {time.perf_counter() - t0:.2f} s")
    jpeg_timing(root, voc, pbr_frame)
    for split in ("train_synt", "train_pbr"):
        loader_timing(root, seed, epochs=1, copies=3, split=split)
    train_cli_jpeg(dev, base, root)
    log(f"[train] JPEG part of phase 9: {time.perf_counter() - t0:.1f} s")


# quantized and GroupNorm nets -------------------------------------------------------
QUANT_CALIB_BATCHES = 4


def _conv_calls():
    """A counter of `F.conv2d` calls (cuDNN's convolutions) for the
    duration: `hourglass.float_conv` and `nn.Conv2d` call it through the
    module attribute."""
    import torch.nn.functional as F

    class Counter:
        n = 0

    orig = F.conv2d

    def counted(*a, **kw):
        Counter.n += 1
        return orig(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        F.conv2d = counted
        try:
            yield Counter
        finally:
            F.conv2d = orig

    return ctx()


def _rel_rms(a, b):
    a, b = a.double(), b.double()
    return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()


def phase_quant(dev, seed, net32, net16, crops):
    """The quantized PkpNet (`quant="int8"`, B12) at full width (the module
    docstring's phase 10, first half). Returns the JSON entries of K11's and
    K12's f32 modes and their launches in one 8-crop f32 forward."""
    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.models import int8_kernels as ik
    from suo_slam_tpu_torch.models import quant

    cl = torch.channels_last
    t0 = time.perf_counter()
    nets = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        n = full_width_net(seed, dt, quant="int8")  # the float weights, act_absmax 0
        nets[name] = n.to(dev).eval().to(memory_format=cl)
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    batches = [torch.rand((N_OBJ, 256, 256, 3), device=dev, generator=g)
               for _ in range(QUANT_CALIB_BATCHES)]
    quant.calibrate(nets["f32"], batches)
    nets["bf16"].load_state_dict(nets["f32"].state_dict())
    torch.cuda.synchronize()
    absmax = [float(m.act_absmax) for m in quant.quant_convs(nets["f32"])]
    log(f"[quant] calibrate over {QUANT_CALIB_BATCHES} batches of {N_OBJ} crops: "
        f"{len(absmax)} act_absmax, {sum(a == 0 for a in absmax)} zero (the prior projection, "
        f"no prior given), range [{min(a for a in absmax if a > 0):.4f}, {max(absmax):.4f}]; "
        f"{(time.perf_counter() - t0):.2f} s with the nets' set-up")
    n_conv = len(quant.quant_convs(nets["f32"])) - 1  # the prior-free program skips one
    per_fwd, run = {}, {}
    for name, n in nets.items():
        f = lambda n=n: n(crops)
        with torch.inference_mode():
            f()
            torch.cuda.synchronize()
            kernels.reset_counts()
            with _conv_calls() as cc:
                out = f()
            torch.cuda.synchronize()
        c = kernels.counts()
        per_fwd[name] = {"K11": c["int8_conv"], "K12": c["int8_quant"], "cuDNN": cc.n,
                         "K8": c["norm_relu"], "K9": c["upsample_add"]}
        run[name] = (dict(int8_conv_f32=c["int8_conv"], int8_quant_f32=c["int8_quant"]), out)
        if not torch.isfinite(out.uv).all() or not torch.isfinite(out.prob_logits).all():
            raise AssertionError(f"quantized net ({name}): non-finite outputs")
    log(f"[quant] launches per prior-free forward (8 crops, {n_conv} QuantConvs run): "
        + json.dumps(per_fwd))
    for name, c in per_fwd.items():
        if (c["K11"], c["K12"], c["cuDNN"], c["K8"], c["K9"]) != (n_conv, n_conv, 2, 180, 8):
            raise AssertionError(f"quantized net ({name}): launches per forward {c}, expected "
                                 f"one K11 and one K12 per QuantConv and cuDNN for the 2 heads")
    # K11's and K12's f32 modes bit-equal to their plain versions at every
    # distinct call of both forwards
    entries = []
    for name, n in nets.items():
        with torch.inference_mode():
            calls = _int8_calls(lambda: n(crops))
        k11, _ = check_k11(dev, calls, f"quant {name}, 8 crops", stem=False)
        k12, _ = check_k12(dev, calls, f"quant {name}, 8 crops")
        if name == "f32":
            k11.update(name="int8_conv_f32", replaces="suo_slam_tpu/models/quant.py:89")
            k12.update(name="int8_quant_f32", replaces="suo_slam_tpu/models/quant.py:84")
            entries = [k11, k12]
        del calls
    # the whole net: kernels against their plain versions on the card; then
    # against the float net, beside the CPU's gap on the same two crops
    with torch.inference_mode():
        o_plain = _with_plain_int8(lambda: nets["f32"](crops))
        o_off = {"f32": net32(crops), "bf16": net16(crops)}
    torch.cuda.synchronize()
    o8 = run["f32"][1]
    if not torch.equal(o8.prob_logits, o_plain.prob_logits):
        raise AssertionError("quantized net: kernels and plain versions give other logits")
    cpu_q = full_width_net(seed, quant="int8").eval()
    cpu_q.load_state_dict(nets["f32"].state_dict())
    cpu_off = full_width_net(seed).eval()
    c2 = crops[:2].cpu()
    with torch.inference_mode():
        oc_q, oc_off = cpu_q(c2), cpu_off(c2)
    gaps = {}
    for name in nets:
        o = run[name][1]
        gaps[name] = {"logits rel RMS": _rel_rms(o.prob_logits, o_off["f32"].prob_logits),
                      "uv max": (o.uv - o_off["f32"].uv).abs().max().item(),
                      "2 crops logits rel RMS": _rel_rms(o.prob_logits[:2],
                                                         o_off["f32"].prob_logits[:2]),
                      "2 crops uv max": (o.uv[:2] - o_off["f32"].uv[:2]).abs().max().item()}
    cpu_gap = {"logits rel RMS": _rel_rms(oc_q.prob_logits, oc_off.prob_logits),
               "uv max": (oc_q.uv - oc_off.uv).abs().max().item()}
    log("[quant] int8 nets (8 crops) against the f32 quant='off' net on the card: "
        + json.dumps({k: {a: round(b, 6) for a, b in v.items()} for k, v in gaps.items()})
        + "; the CPU's int8 f32 net on crops 0-1: "
        + json.dumps({a: round(b, 6) for a, b in cpu_gap.items()})
        + f"; card int8 logits equal to its plain-version run: True")
    g32 = gaps["f32"]
    if not (g32["2 crops logits rel RMS"] <= max(1.5 * cpu_gap["logits rel RMS"], 1e-3)
            and g32["logits rel RMS"] <= 0.03):
        raise AssertionError(f"quantized f32 net on the card farther from f32 than the CPU's: "
                             f"{g32} vs {cpu_gap}")

    # host and device ms per call, 8 crops (turns Q F F Q), then 128 crops
    def wall_ms(f, reps=10):
        vals = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                f()
            torch.cuda.synchronize()
            vals.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(vals[1:])

    def calls_of(x):
        def mk(n):
            def f():
                with torch.inference_mode():
                    return n(x)
            return f
        return {"int8 f32": mk(nets["f32"]), "int8 bf16": mk(nets["bf16"]),
                "f32": mk(net32), "bf16": mk(net16)}

    fs = calls_of(crops)
    t = {}
    for turn in ("int8 f32", "f32", "f32", "int8 f32", "int8 bf16", "bf16", "bf16",
                 "int8 bf16"):
        t.setdefault(turn, []).append(wall_ms(fs[turn]))
    log("[quant] full-width net host ms per call (8 crops, prior-free, median of 10, in "
        "turns): " + json.dumps({k: [round(x, 3) for x in v] for k, v in t.items()})
        + "; device ms per call: " + json.dumps(_net_device_ms(fs, N_OBJ)))
    g = torch.Generator(device=dev).manual_seed(seed + 129)
    c128 = torch.rand((128, 256, 256, 3), device=dev, generator=g)
    f128 = calls_of(c128)
    kernels.reset_counts()
    f128["int8 f32"]()
    torch.cuda.synchronize()
    c = kernels.counts()
    log(f"[quant 128] launches per prior-free f32 forward (128 crops): K11 {c['int8_conv']}, "
        f"K12 {c['int8_quant']}; device ms per call: "
        + json.dumps(_net_device_ms({k: f128[k] for k in ("int8 f32", "int8 bf16", "f32")},
                                    128, calls=2)))
    if (c["int8_conv"], c["int8_quant"]) != (n_conv, n_conv):
        raise AssertionError(f"quantized net at 128 crops: launches {c}")
    del c128, f128
    torch.cuda.empty_cache()
    return entries, run["f32"][0]


def gn_kernel_of(name: str):
    """"K20" or "K21" for a kernel of `csrc/group_norm.cu` in a profiler
    trace (both designs: the cluster kernels, and the split design's partial
    pass by its mode, finalizes and second passes), None for any other."""
    import re

    if "gn_fwd_cluster_kernel" in name or "gn_stats_kernel" in name or "gn_apply_kernel" in name:
        return "K20"
    if any(k in name for k in ("gn_bwd_cluster_kernel", "gn_bwd_sample_kernel",
                               "gn_bwd_channel_kernel", "gn_dx_kernel")):
        return "K21"
    m = re.search(r"gn_partial_kernel<[^,]+,\s*\d+,\s*(\d)", name)
    if m:
        return "K20" if m.group(1) == "0" else "K21"
    return None


GN_CHECK_SHAPES = ((N_OBJ, 256, 64, 64), (16, 128, 128, 128), (TRAIN_N, 256, 64, 64))
GN_GATES = {"stats": 1e-6, "y f32": 1e-5, "dx f32": 1e-5, "y bf16": 2.0 ** -8,
            "dx bf16": 2.0 ** -8, "sums": 1e-5}


def gn_designs(hg):
    """K20 / K21's two designs as (forward, backward): the wrappers (the
    cluster design wherever `plan_gn` plans the shape: every shape of the
    net) and the split design's functions (the wrappers' route for wider
    pixels)."""
    return {"cluster": (hg._group_norm_relu_cuda, hg._group_norm_relu_bwd_cuda),
            "split": (hg._group_norm_relu_split, hg._group_norm_relu_bwd_split)}


def gn_errors(fw, bw, x, dy, scale, bias, G, ref):
    """One design's K20 / K21 errors against the plain versions' outputs
    `ref` ((y, mean, rstd), (dx, dscale, dbias)) on the same inputs, keyed
    as GN_GATES: statistics relative, y and dx of their largest magnitude,
    the parameter gradients of their scale. Returns (errors, K20's outputs,
    K21's)."""
    import torch

    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp(min=1e-30)).item()
    (yp, mp, rp), p = ref
    yk, mk, rk = fw(x, scale, bias, G)
    k = bw(x, dy, scale, bias, mp, rp)
    torch.cuda.synchronize()
    name = "f32" if x.dtype == torch.float32 else "bf16"
    e = {"stats": max(rel(mk, mp), rel(rk, rp)), f"y {name}": rel(yk, yp),
         f"dx {name}": rel(k[0], p[0]),
         "sums": max(((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
                     for a, b in zip(k[1:], p[1:]))}
    return e, (yk, mk, rk), k


def gn_plan_class(plan) -> str:
    """A cluster-design plan's class: one CTA (and samples a CTA), or a
    cluster of 2-8 or 16 with the slice on chip or partly read again."""
    if plan.k == 1:
        return "k=1, spp>1" if plan.spp > 1 else "k=1"
    return (f"k={'16' if plan.k == 16 else '2-8'}, "
            + ("on chip" if plan.keep == plan.iters else "read again"))


def check_k20_k21(dev, rng):
    """K20 and K21 against their plain versions in both designs at the
    GroupNorm net's shapes, 8 x 256 x 64 x 64 (a residual's first norm at 8
    crops), 16 x 128 x 128 x 128 (a pre-residual's at 16 slots) and 32 x 256
    x 64 x 64 (the train step's largest), f32 and bf16: statistics 1e-6
    relative (f64 sums in another order), y and dx within 1e-5 of their
    largest magnitude (f32) or 2^-8 (bf16), dscale / dbias 1e-5 of their
    scale; against F.group_norm + relu and its autograd (the library
    yardstick) within 1e-4 of the largest magnitude (f32). The cluster
    design (the main path): every output bit-equal when a call is repeated,
    one `gn_` kernel a call (the nodes of a captured graph), its workspace
    counters back at 0. Times at each shape and dtype: L2-cold device us of
    both designs in turns (split, cluster, cluster, split) and of the
    library; host us a call of both designs (`host_ns`); kernel (warm),
    device (profiler), plain and library ms and the bytes bound (x read, y
    written; x, dy read, dx written). Then the route's boundary
    (`gn_route_boundary`)."""
    import torch
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models import hourglass as hg

    cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
    designs = gn_designs(hg)
    err = {d: dict.fromkeys(GN_GATES, 0.0) for d in designs}
    err_lib, repeat = 0.0, True
    res, entries, cold_sums = {}, [], {}
    for shape in GN_CHECK_SHAPES:
        C = shape[1]
        G = hg.num_groups(C)
        x32 = cl((rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32))
        dy32 = cl(rng.normal(size=shape).astype(np.float32))
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32)).to(dev)
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, dy = x32.to(dt), dy32.to(dt)
            yp, mp, rp = hg.group_norm_relu_plain(x, scale, bias, G)
            p = hg.group_norm_relu_bwd_plain(x, dy, scale, bias, mp, rp)
            rel = lambda a, b: ((a.float() - b.float()).abs().max()
                                / b.float().abs().max().clamp(min=1e-30)).item()
            if hg._gn_plan("fwd", x, G) is None or hg._gn_plan("bwd", x, G, dy) is None:
                raise AssertionError(f"K20 / K21: no cluster plan at {list(x.shape)} {name}")
            for d, (fw, bw) in designs.items():
                e1, (yk, mk, rk), k = gn_errors(fw, bw, x, dy, scale, bias, G, ((yp, mp, rp), p))
                for key, v in e1.items():
                    err[d][key] = max(err[d][key], v)
                if d == "cluster":
                    again = (hg._group_norm_relu_cuda(x, scale, bias, G)
                             + hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, mp, rp))
                    repeat &= all(torch.equal(u, v) for u, v in zip((yk, mk, rk) + k, again))
                    ycl, kcl = yk, k
            # (F.group_norm on the card takes its affine in the input's dtype)
            xg = x.detach().clone().requires_grad_(True)
            w = scale.detach().to(dt).requires_grad_(True)
            bb = bias.detach().to(dt).requires_grad_(True)
            ylib = torch.relu(F.group_norm(xg, G, w, bb, hg.GN_EPS))
            if dt == torch.float32:
                glib = torch.autograd.grad(ylib, (xg, w, bb), dy, retain_graph=True)
                err_lib = max(err_lib, rel(ycl, ylib.detach()), rel(kcl[0], glib[0]),
                              rel(kcl[1], glib[1]), rel(kcl[2], glib[2]))
            n, es = x.numel(), x.element_size()
            timing = {}
            for label, fns, plain, lib, nbytes, ops in (
                    ("K20 group_norm_relu",
                     {d: (lambda f=f: f[0](x, scale, bias, G)) for d, f in designs.items()},
                     lambda: hg.group_norm_relu_plain(x, scale, bias, G),
                     lambda: torch.relu(F.group_norm(x, G, w, bb, hg.GN_EPS)),
                     2 * n * es + 2 * C * 4, 8 * n),
                    ("K21 group_norm_relu_bwd",
                     {d: (lambda f=f: f[1](x, dy, scale, bias, mp, rp))
                      for d, f in designs.items()},
                     lambda: hg.group_norm_relu_bwd_plain(x, dy, scale, bias, mp, rp),
                     lambda: torch.autograd.grad(ylib, (xg, w, bb), dy, retain_graph=True),
                     3 * n * es + 2 * C * 4, 12 * n)):
                cold = {d: [] for d in designs}
                for d in ("split", "cluster", "cluster", "split"):
                    cold[d].append(1e3 * cuda_ms_cold(fns[d]))
                lib_cold = 1e3 * cuda_ms_cold(lib)
                hns = host_ns(fns, n=500)
                ms, plain_ms = cuda_ms(fns["cluster"]), cuda_ms(plain, n=5, inner=2)
                lib_ms = cuda_ms(lib)
                us, src = device_us(fns["cluster"], "gn_", per_call=1)
                b = bound(nbytes, ops)
                key = f"{'y' if label.startswith('K20') else 'dx'} {name}"
                _report(f"{label} ({name}, {list(x.shape)}, {G} groups, device {us:.3f} us by "
                        f"{src}; L2-cold device us, in turns: cluster "
                        f"{[round(v, 3) for v in cold['cluster']]}, split "
                        f"{[round(v, 3) for v in cold['split']]}, library {lib_cold:.3f})",
                        err["cluster"][key], "1e-5 of max" if name == "f32" else "2^-8 of max",
                        ms, plain_ms, lib_ms, b, lib)
                timing[label] = (ms, plain_ms, lib_ms, b, us)
                cold_sums[(label[:3], "x".join(map(str, x.shape)), name)] = (
                    statistics.mean(cold["cluster"]), statistics.mean(cold["split"]), lib_cold,
                    b[0] * 1e3, hns["cluster"] / 1e3, hns["split"] / 1e3)
            res[(shape, name)] = timing
            del x, dy, xg, ylib
    for d in designs:
        log(f"[group] K20 / K21 ({d} design) errors over {len(GN_CHECK_SHAPES)} shapes, f32 and "
            f"bf16: " + json.dumps({k: f"{v:.3e}" for k, v in err[d].items()})
            + " (tol: stats 1e-6, y / dx f32 1e-5 of max, bf16 2^-8, sums 1e-5 of scale)")
    log(f"[group] cluster K20 / K21 against F.group_norm + relu and its autograd (f32): "
        f"{err_lib:.3e} of max (tol 1e-4); repeated calls bit-equal: {repeat}")
    log("[group] K20 / K21 L2-cold device us (cluster, split, library, bound), then host us a "
        "call (cluster, split; `host_ns`) by kernel, shape, dtype: " + json.dumps({" ".join(map(str, k)): [round(v, 3) for v in t]
                                for k, t in cold_sums.items()}))
    for d, e in err.items():
        if any(e[key] > tol for key, tol in GN_GATES.items()):
            raise AssertionError(f"K20 / K21 ({d} design) disagree with their plain versions: {e}")
    if err_lib > 1e-4 or not repeat:
        raise AssertionError(f"cluster K20 / K21: library {err_lib}, repeats equal {repeat}")

    # kernels a call, by the nodes of a captured graph
    big = GN_CHECK_SHAPES[2]
    C = big[1]
    G = hg.num_groups(C)
    x = cl((rng.normal(size=big) * 1.5).astype(np.float32)).to(torch.bfloat16)
    dy = cl(rng.normal(size=big).astype(np.float32)).to(torch.bfloat16)
    one, zero = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    _, mean, rstd = hg._group_norm_relu_cuda(x, one, zero, G)
    per_call = {f"{kn} {d}": launches_per_call(fn) for d, f in designs.items() for kn, fn in (
        ("K20", lambda f=f: f[0](x, one, zero, G)),
        ("K21", lambda f=f: f[1](x, dy, one, zero, mean, rstd)))}
    log(f"[group] K20 / K21 kernels per call (captured graph, bf16 {list(big)}): "
        + json.dumps(per_call))
    if per_call["K20 cluster"] != 1 or per_call["K21 cluster"] != 1:
        raise AssertionError(f"cluster K20 / K21 launch more than one kernel a call: {per_call}")
    torch.cuda.synchronize()
    if any(w[0].any().item() for w in hg._gn_work.values()):
        raise AssertionError("a cluster K21 launch left its arrival counters non-zero")
    gn_route_boundary(dev, rng)
    timing = res[(GN_CHECK_SHAPES[0], "bf16")]
    for kname, label, key in (("group_norm_relu", "K20 group_norm_relu", "y bf16"),
                              ("group_norm_relu_bwd", "K21 group_norm_relu_bwd", "dx bf16")):
        ms, plain_ms, lib_ms, b, _ = timing[label]
        entries.append(dict(name=kname, route="cuda",
                            source="suo_slam_tpu_torch/csrc/group_norm.cu",
                            replaces="suo_slam_tpu/models/hourglass.py:104",
                            max_abs_err=err["cluster"][key], ms=ms, plain_ms=plain_ms,
                            bound_ms=b[0], bound_by=b[1], library_ms=lib_ms))
    return entries


# the wrappers' route at its boundary: the widest pixel the cluster design
# takes (256 f32 vectors), one vector wider, and an unvectorized bf16 pixel
# of 300 values (600 bytes)
GN_BOUNDARY = (((N_OBJ, 1024, 32, 32), "f32"), ((N_OBJ, 1028, 32, 32), "f32"),
               ((N_OBJ, 300, 32, 32), "bf16"))


def gn_route_boundary(dev, rng):
    """K20 / K21 through the wrappers at GN_BOUNDARY: the design `plan_gn`
    picks (kernels a call by graph nodes: 1 and 1 for the cluster design, 3
    and 4 for the split), its outputs against the plain versions under
    GN_GATES, and L2-cold device us; where the cluster design takes the
    shape, the split design's too, in turns (split, cluster, cluster,
    split): a time on each side of the route's choice."""
    import torch

    from suo_slam_tpu_torch.models import hourglass as hg

    designs = gn_designs(hg)
    out = {}
    for shape, name in GN_BOUNDARY:
        dt = torch.float32 if name == "f32" else torch.bfloat16
        C = shape[1]
        G = hg.num_groups(C)
        cl = lambda a: torch.from_numpy(a).to(dev).to(dt).contiguous(
            memory_format=torch.channels_last)
        x = cl((rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32))
        dy = cl(rng.normal(size=shape).astype(np.float32))
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
        bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32)).to(dev)
        yp, mp, rp = hg.group_norm_relu_plain(x, scale, bias, G)
        p = hg.group_norm_relu_bwd_plain(x, dy, scale, bias, mp, rp)
        route = "cluster" if hg._gn_plan("fwd", x, G) is not None else "split"
        e, _, _ = gn_errors(*designs["cluster"], x, dy, scale, bias, G, ((yp, mp, rp), p))
        per_call = [launches_per_call(lambda: hg._group_norm_relu_cuda(x, scale, bias, G)),
                    launches_per_call(lambda: hg._group_norm_relu_bwd_cuda(x, dy, scale, bias,
                                                                          mp, rp))]
        fns = {d: (lambda f=f: f[0](x, scale, bias, G), lambda f=f: f[1](x, dy, scale, bias, mp, rp))
               for d, f in designs.items()}
        order = ("split", "cluster", "cluster", "split") if route == "cluster" else ("cluster",)
        cold = {}
        for i, kn in enumerate(("K20", "K21")):
            for d in order:
                cold.setdefault(f"{kn} {d if route == 'cluster' else 'route'}", []).append(
                    round(1e3 * cuda_ms_cold(fns[d][i]), 3))
        key = f"{'x'.join(map(str, shape))} {name}"
        out[key] = dict(route=route, kernels_a_call=per_call, cold_us=cold,
                        errors={k: f"{v:.3e}" for k, v in e.items()})
        if (any(v > GN_GATES[k] for k, v in e.items())
                or per_call != ([1, 1] if route == "cluster" else [3, 4])):
            raise AssertionError(f"K20 / K21 at the route's boundary, {key}: {out[key]}")
        del x, dy, yp, p
    log("[group] K20 / K21 through the wrappers at the route's boundary (the design plan_gn "
        "picks, kernels a call, L2-cold device us, errors against the plain versions): "
        + json.dumps(out))
    return out


def gn_clocks(label, x, dy, scale, bias, G, mean, rstd):
    """SM clock cycles by phase of one L2-cold call of each cluster-design
    kernel (`bn_clocks`, a row per CTA launched)."""
    from suo_slam_tpu_torch.models import hourglass as hg

    dt = hg._DTYPES[x.dtype]
    for kind, phases, fn, ts in (
            ("fwd", hg.GN_FWD_PHASES,
             lambda cyc: hg._group_norm_relu_cuda(x, scale, bias, G, cycles=cyc), (x,)),
            ("bwd", hg.GN_BWD_PHASES,
             lambda cyc: hg._group_norm_relu_bwd_cuda(x, dy, scale, bias, mean, rstd, cycles=cyc),
             (dy, x))):
        plan = hg._gn_plan(kind, x, G, *ts)
        rows = hg._gn_rows(x.device, kind, dt, plan)
        bn_clocks(f"{'K20' if kind == 'fwd' else 'K21'} cluster ({label}, k {plan.k}, spp "
                  f"{plan.spp}, {rows} CTA rows, keep {plan.keep} of {plan.iters}, slots "
                  f"{plan.slots})", fn, phases, plan.k * rows, tag="[group]")


def gn_step_shapes(dev, rng):
    """K20 and K21 at every norm shape of the GroupNorm train step (one
    train-mode forward of the full-width group net on TRAIN_N crops records
    them), bf16 as the step and f32 as a `--no_bf16` step: each design's
    outputs against the plain versions under GN_GATES (the worst error by
    plan class: every plan the step runs is held), one L2-cold call of each
    design per shape, the sums over the step's 180 calls of each — where a
    step's K20 / K21 time goes — and SM cycles by phase at three bf16 shapes
    (`gn_clocks`)."""
    import collections

    import torch

    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.models.pkpnet import PkpNet

    net = PkpNet(dtype=torch.bfloat16, norm="group").to(dev)
    shapes = collections.Counter()
    real = hg.group_norm_relu

    def spy(x, *a, **kw):
        shapes[tuple(x.shape)] += 1
        return real(x, *a, **kw)

    crops = torch.from_numpy(rng.uniform(0, 1, (TRAIN_N, 256, 256, 3)).astype(np.float32)).to(dev)
    hg.group_norm_relu = spy
    try:
        with torch.no_grad():
            net(crops, train=True)
    finally:
        hg.group_norm_relu = real
    if sum(shapes.values()) != NORMS_PER_FWD:
        raise AssertionError(f"the group net's forward made {sum(shapes.values())} norm calls")
    del net, crops
    designs = gn_designs(hg)
    totals = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cl = lambda a: torch.from_numpy(a).to(dev).to(dt).contiguous(
            memory_format=torch.channels_last)
        rows, tot = [], collections.Counter()
        worst = collections.defaultdict(lambda: collections.defaultdict(float))
        for shape, n in sorted(shapes.items(), key=lambda kv: -kv[0][2]):
            C = shape[1]
            G = hg.num_groups(C)
            x = cl((rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32))
            dy = cl(rng.normal(size=shape).astype(np.float32))
            scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
            bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32)).to(dev)
            yp, mp, rp = hg.group_norm_relu_plain(x, scale, bias, G)
            ref = ((yp, mp, rp), hg.group_norm_relu_bwd_plain(x, dy, scale, bias, mp, rp))
            plans = [hg._gn_plan("fwd", x, G), hg._gn_plan("bwd", x, G, dy)]
            if None in plans:
                raise AssertionError(f"K20 / K21: no cluster plan at {list(shape)} {name}")
            for d, (fw, bw) in designs.items():
                e, _, _ = gn_errors(fw, bw, x, dy, scale, bias, G, ref)
                for kn, plan, keys in (("K20", plans[0], ("stats", f"y {name}")),
                                       ("K21", plans[1], (f"dx {name}", "sums"))):
                    cls = f"{kn} " + (f"cluster {gn_plan_class(plan)}" if d == "cluster"
                                      else "split")
                    for key in keys:
                        worst[cls][key] = max(worst[cls][key], e[key])
            del yp, ref
            mean, rstd = mp, rp
            t = {f"{kn} {d}": (lambda f=f, kn=kn: f[0](x, scale, bias, G) if kn == "K20" else
                               f[1](x, dy, scale, bias, mean, rstd))
                 for kn in ("K20", "K21") for d, f in designs.items()}
            us = {k: 1e3 * cuda_ms_cold(f, n=7) for k, f in t.items()}
            for k, v in us.items():
                tot[k] += n * v
            bytes_ = x.numel() * x.element_size()
            tot["K20 bound"] += n * 2 * bytes_ / HBM_BYTES_PER_S * 1e6
            tot["K21 bound"] += n * 3 * bytes_ / HBM_BYTES_PER_S * 1e6
            rows.append([list(shape), n, gn_plan_class(plans[0]), gn_plan_class(plans[1])]
                        + [round(us[k], 2) for k in t])
            if name == "bf16" and shape in ((TRAIN_N, 256, 64, 64), (TRAIN_N, 128, 16, 16),
                                            (TRAIN_N, 128, 4, 4)):
                gn_clocks(str(list(shape)), x, dy, scale, bias, G, mean, rstd)
            del x, dy, mean, rstd
        log(f"[group] K20 / K21 against the plain versions at every norm shape of the GroupNorm "
            f"step, {name}, worst by design and plan class (gates: stats 1e-6, y / dx "
            f"{'1e-5' if name == 'f32' else '2^-8'} of max, sums 1e-5 of scale): "
            + json.dumps({c: {k: f"{v:.3e}" for k, v in e.items()}
                          for c, e in sorted(worst.items())}))
        bad = {c: e for c, e in worst.items() if any(v > GN_GATES[k] for k, v in e.items())}
        if bad:
            raise AssertionError(f"K20 / K21 disagree with their plain versions at the {name} "
                                 f"step's norm shapes: {bad}")
        log(f"[group] K20 / K21 by norm shape of the {name} GroupNorm step (shape, calls, K20's "
            f"and K21's plan class, L2-cold device us a call: " + ", ".join(t) + "): "
            + json.dumps(rows))
        log(f"[group] ... {name}, summed over the step's calls (ms; bounds: bytes at 3.35 "
            "TB/s): " + json.dumps({k: round(v / 1e3, 3) for k, v in tot.items()}))
        totals[name] = tot
    return totals


def phase_group(dev, seed, objs, scene):
    """The GroupNorm PkpNet (`norm="group"`, A18) at full width (the module
    docstring's phase 10, second half). Returns K20 / K21's JSON entries and
    the launches of the training CLI's run."""
    import io
    import os
    import re
    import shutil

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.evaluate import Evaluator
    from suo_slam_tpu_torch.slam.engine import ObjectSlam, SlamConfig
    from suo_slam_tpu_torch.train import __main__ as cli

    rng = np.random.default_rng(seed + 20)
    entries = check_k20_k21(dev, rng)
    gn_step_shapes(dev, rng)
    base, root = _eval_root()
    kp_root = os.path.join(root, "kp_configs")
    netg16 = full_width_net(seed, torch.bfloat16, norm="group").to(dev).eval().to(
        memory_format=torch.channels_last)
    # the evaluation entry point, single view, bf16
    kernels.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, "", nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=kp_root, device=dev, net=netg16)
        ev.model_path = os.path.join(base, "results_group")
        summary = ev.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = kernels.counts()
    if summary is None or c["group_norm_relu"] == 0 or c["norm_relu"]:
        raise AssertionError(f"Evaluator with the group net: K20 {c['group_norm_relu']}, K8 "
                             f"{c['norm_relu']}:\n{buf.getvalue()[-3000:]}")
    log(f"[group] Evaluator(nviews=1) with the full-width bf16 group net: {ev.method_name()} ran "
        f"to its end, {wall / EVAL_VIEWS * 1e3:.2f} ms per view over {EVAL_VIEWS} views; "
        f"launches " + json.dumps({k: v for k, v in c.items() if v}))
    # 3 SLAM frames (the ground-truth wrapper of phase 6 over the group net)
    engine = ObjectSlam(SlamConfig(), mesh_db=objs, net=netg16, device=dev)
    inf = GtPriorInfer(engine._infer, dev, seed)
    engine._infer = inf
    img = np.random.default_rng(seed + 21).uniform(0, 1, (H_IMG, W_IMG, 3)).astype(np.float32)
    ids = np.arange(1, N_OBJ + 1)
    times = []
    kernels.reset_counts()
    for i in range(3):
        T_OtoC, bboxes, uv_gt = scene.frame(i)
        inf.set_frame(bboxes, uv_gt)
        t1 = time.perf_counter()
        engine.process_view(i, img, YCBV_K, ids, bboxes, objs.model_kps, objs.masks, objs.masks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    results = engine.collect_results(final=True)
    c = kernels.counts()
    ok = [p is not None and np.isfinite(p).all() and _add_ok(p, scene.frame(i)[0][o], objs, o)
          for i in range(3) for o in range(N_OBJ)
          for p in [results[i]["poses"].get(o + 1, {}).get("T_OtoC")]]
    log(f"[group] SLAM, 3 frames with the group net: ms per frame "
        f"{[round(x, 2) for x in times]}; ADD < 0.1 d for {float(np.mean(ok)):.3f} of "
        f"{len(ok)} poses; launches " + json.dumps({k: v for k, v in c.items() if v}))
    if c["group_norm_relu"] == 0 or c["norm_relu"] or float(np.mean(ok)) < 0.9:
        raise AssertionError("group SLAM run: no K20 launch, a K8 launch or poses off")
    del engine, inf
    # one full-width train step with K20 / K21 against its plain run, then
    # the bf16 step's times, kernels and launches
    train_step_parity(dev, seed, root, norm="group")
    step_timing(dev, seed, root, norm="group")
    # the training CLI with --norm group, then its checkpoint through Evaluator
    work = os.path.join(base, "train_cli_group")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = ["--device", dev.type, "--dataset", "ycbv", "--data_split", "real", "--norm", "group",
            "--no_augmentations", "--steps_per_epoch", "4", "--val_steps", "2", "--epochs", "1",
            "--data_root", root, "--kp_config_root", kp_root]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        buf = io.StringIO()
        kernels.reset_counts()
        t1 = time.perf_counter()
        with plain_on_cuda_counter() as hits, contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = kernels.counts()
    finally:
        os.chdir(cwd)
    text = buf.getvalue()
    with open(os.path.join(work, "cli.log"), "w") as f:
        f.write(text)
    (outdir,) = [os.path.join(work, "results", d) for d in os.listdir(os.path.join(work, "results"))]
    losses = [float(x) for x in re.findall(r"train loss ([-\d.eE+naninf]+)", text)]
    steps, vals, dumps = 4, 2, 2  # a train and a test prediction dump
    want = {"group_norm_relu": NORMS_PER_FWD * (steps + vals + dumps),
            "group_norm_relu_bwd": NORMS_PER_FWD * steps, "norm_relu": 0, "bn_stats": 0,
            "norm_relu_bwd": 0, "upsample_add": JUNCTIONS_PER_FWD * (steps + vals + dumps),
            "upsample_add_bwd": JUNCTIONS_PER_FWD * steps}
    got = {k: counts[k] for k in want}
    log(f"[group] CLI --norm group, 1 epoch x 4 steps + 2 val batches, full width bf16: rc {rc}, "
        f"{wall:.2f} s; train losses {losses}; launches {json.dumps(got)} (want "
        f"{json.dumps(want)}); plain versions on CUDA tensors: {json.dumps(hits)}")
    if rc != 0 or len(losses) != 1 or not np.isfinite(losses).all() or got != want or hits:
        raise AssertionError(f"training CLI --norm group: rc {rc}, losses {losses}, launches "
                             f"{got}, plain on CUDA {hits}:\n{text[-3000:]}")
    ck = os.path.join(outdir, "checkpoint-latest")
    buf = io.StringIO()
    kernels.reset_counts()
    with contextlib.redirect_stdout(buf):
        ev = Evaluator("ycbv", root, ck, nviews=1, detection_type="gt", no_viz=True,
                       kp_config_root=kp_root, device=dev)
        ev.model_path = os.path.join(base, "results_group_trained")
        summary = ev.run()
    loaded = ev.object_slam._infer.net
    if (summary is None or ev.model_epoch != 0 or loaded.norm != "group"
            or kernels.counts()["group_norm_relu"] == 0):
        raise AssertionError(f"Evaluator on the group checkpoint:\n{buf.getvalue()[-3000:]}")
    log(f"[group] Evaluator(nviews=1) on {ck} (epoch {ev.model_epoch}, norm {loaded.norm}): "
        f"ran to its end, {ev.method_name()}")
    return entries, counts


# throughput evaluation phase ----------------------------------------------------
THROUGHPUT_SCENES, THROUGHPUT_VIEWS = 4, 16  # the phase's BOP tree (x 8 objects): a scene
# fills one window of the batched mode (its default, 16 views x 8 = 128 crops)
GUIDE_EPS, GUIDE_SIGMA = 0.02, 0.005  # GtGuided: uv = ground truth + eps x the net's uv


class GtGuided:
    """The throughput phase's network calls: every call the evaluation
    builds (`make_frame_inference`, `make_multi_frame_inference` and, through
    it, `make_batch_inference`) runs the full-width net, then returns each
    box's ground-truth keypoints (looked up by the box in the BOP tree) plus
    GUIDE_EPS x the net's own uv, covariance GUIDE_SIGMA^2 I and validity 1
    (padded boxes: zeros). Random weights would pose nothing; this way PnP,
    camera RANSAC, the priors and BA do real work, as in phase 6, and every
    bit of the net's uv still moves the poses. Records the multi-frame calls'
    (G, O, with prior) while installed."""

    def __init__(self, root, dev):
        import os

        import torch

        from suo_slam_tpu_torch.data.bop import BopDataset

        ds = BopDataset(root, "test", bop_dset="ycbv", ignore_symmetry=True,
                        kp_config_root=os.path.join(root, "kp_configs"), seed=666)
        self.table = {}
        for sc in ds.scene_ids():
            for v in ds.view_ids(sc):
                smp = ds.get_raw(sc, v, ds.obj_ids(sc, v), p_give_prior=0.0)
                for b, uv in zip(smp["bboxes"], smp["kp_uvs"]):
                    self.table[tuple(np.asarray(b, np.float32).tolist())] = uv
        self.cov = torch.eye(2, device=dev) * GUIDE_SIGMA ** 2
        self.multi_calls = []

    def wrap(self, fn, multi):
        import torch

        def guided(*a, **kw):
            uv, _, m = fn(*a, **kw)
            if multi:
                self.multi_calls.append((int(uv.shape[0]), int(uv.shape[1]),
                                         bool(kw.get("has_prior", True))))
            bx = torch.as_tensor(a[1]).cpu().numpy().astype(np.float32)
            gt = np.zeros(tuple(uv.shape), np.float32)
            for i in np.ndindex(bx.shape[:-1]):
                row = self.table.get(tuple(bx[i].tolist()))
                if row is not None:
                    gt[i] = row
            return (torch.from_numpy(gt).to(uv.device) + GUIDE_EPS * uv,
                    self.cov.expand(tuple(uv.shape[:-1]) + (2, 2)).clone(), torch.ones_like(m))

        for k in ("supports_no_prior", "int8_state", "net"):
            if hasattr(fn, k):
                setattr(guided, k, getattr(fn, k))
        return guided

    @contextlib.contextmanager
    def installed(self):
        from suo_slam_tpu_torch.slam import kernels as sk

        orig = sk.make_frame_inference, sk.make_multi_frame_inference
        sk.make_frame_inference = lambda *a, **kw: self.wrap(orig[0](*a, **kw), False)
        sk.make_multi_frame_inference = lambda *a, **kw: self.wrap(orig[1](*a, **kw), True)
        try:
            yield self
        finally:
            sk.make_frame_inference, sk.make_multi_frame_inference = orig


def _throughput_leg(label, root, base, dev, guide, n_items, **kw):
    """One `Evaluator` run of the throughput phase: its summary, CSV text,
    wall seconds, ms per view (per keyframe in SfM), launches and the
    multi-frame calls' shapes; every sampler's draws ranked in K15 (no K22)."""
    import io
    import os

    import torch

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.evaluate import Evaluator

    buf = io.StringIO()
    kernels.reset_counts()
    guide.multi_calls.clear()
    with contextlib.redirect_stdout(buf), PlainSamplerCalls() as plain:
        ev = Evaluator("ycbv", root, "", detection_type="gt", no_viz=True,
                       kp_config_root=os.path.join(root, "kp_configs"), device=dev, **kw)
        ev.model_path = os.path.join(base, "results", label)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = ev.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    text = buf.getvalue()
    if summary is None:
        raise AssertionError(f"throughput leg {label} failed:\n{text[-3000:]}")
    counts = {k: v for k, v in kernels.counts().items() if v}
    outdir = os.path.join(ev.model_path, ev.method_name())
    csv = open(os.path.join(outdir, ev.method_name() + ".csv")).read()
    shapes = {}
    for c in guide.multi_calls:
        shapes[str(c)] = shapes.get(str(c), 0) + 1
    auc = 100 * summary["ours"]["AUC of ADD(-S)"]
    log(f"[throughput] {label}: AUC of ADD(-S) {auc:.2f}, camera poses "
        f"{summary.get('cam_pose_pct')}%, {len(csv.splitlines())} CSV rows; {wall:.2f} s = "
        f"{wall / n_items * 1e3:.2f} ms per {'keyframe' if kw.get('nviews') == 2 else 'view'}; "
        f"multi-frame calls (G, O, with prior): {json.dumps(shapes)}; {plain.n} plain sampler "
        f"calls on the card; launches {json.dumps(counts)}")
    if plain.n or counts.get("pnp_sample") or not all(
            counts.get(k) for k in ("pnp_ransac", "roi_crop", "heatmap_readout")):
        raise AssertionError(f"throughput leg {label}: a kernel of the path did not launch, K22 "
                             f"launched, or {plain.n} plain sampler calls on the card: {counts}")
    if counts.get("add_dists") != THROUGHPUT_SCENES:  # one meter call per scored scene
        raise AssertionError(f"throughput leg {label}: {counts.get('add_dists')} K10 launches "
                             f"for {THROUGHPUT_SCENES} scenes")
    return dict(summary=summary, csv=csv, auc=auc, wall=wall, counts=counts, shapes=shapes)


def phase_throughput(dev, seed, net32, net16):
    """The throughput evaluation modes on the card (the module docstring's
    phase 11). Returns the batched dispatch's device numbers."""
    import os

    import torch

    from suo_slam_tpu_torch.models import int8_forward as i8
    from suo_slam_tpu_torch.slam import kernels as sk

    rng = np.random.default_rng(seed + 11)
    objs = EvalObjects(rng)
    scenes = []
    while len(scenes) < THROUGHPUT_SCENES:  # redraw a scene whose objects leave a frame
        try:
            scene = SlamScene(rng, objs, THROUGHPUT_VIEWS)
            [scene.frame(v) for v in range(THROUGHPUT_VIEWS)]
            scenes.append(scene)
        except AssertionError:
            continue
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_throughput")
    root = os.path.join(base, "bop_datasets", "ycbv")
    t0 = time.perf_counter()
    write_bop_tree(root, objs, scenes, THROUGHPUT_VIEWS)
    guide = GtGuided(root, dev)
    side = os.path.join(_eval_root()[0], "int8_scales.npz")  # phase 8's calibrate_int8 sidecar
    n_views = THROUGHPUT_SCENES * THROUGHPUT_VIEWS
    log(f"[throughput] BOP tree of {THROUGHPUT_SCENES} scenes x {THROUGHPUT_VIEWS} views x {N_OBJ} "
        f"objects written and its ground truth read in {time.perf_counter() - t0:.2f} s; int8 "
        f"sidecar {side}; {smi_line()}")

    # the batched dispatch alone: one window of 16 views x 8 objects = 128
    # crops against the per-frame program on each view's 8 crops
    imgs = torch.from_numpy(rng.uniform(0, 1, (16, H_IMG, W_IMG, 3)).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(np.stack([scenes[0].frame(v)[1] for v in range(16)])).to(dev)
    valid = torch.ones((16, N_OBJ), dtype=torch.bool, device=dev)
    scales = i8.load_scales(side)
    direct = {}
    for name, net, kw in (("bf16", net16, {}), ("int8", net16, dict(int8=True, int8_scales=scales)),
                          ("f32", net32, {})):
        tb = sk.make_batch_inference(net, device=dev, **kw)
        tf = sk.make_frame_inference(net, device=dev, **kw)
        ob = tb(imgs, boxes, valid)
        of = [tf(imgs[i], boxes[i], valid[i], has_prior=False) for i in range(16)]
        uv_f = torch.stack([o[0] for o in of])
        ms = cuda_ms(lambda: tb(imgs, boxes, valid), n=3, inner=2, warmup=1)
        direct[name] = dict(uv_b=ob[0], uv_f=uv_f, ms=ms,
                            equal=int((ob[0] == uv_f).all(-1).all(-1).sum()))
    torch.cuda.synchronize()
    gap = lambda a, b: (a - b).abs().max().item()
    bf16_gate = gap(direct["bf16"]["uv_f"], direct["f32"]["uv_f"])
    bf16_err = gap(direct["bf16"]["uv_b"], direct["bf16"]["uv_f"])
    log("[throughput] the 128-crop batched call (16 views x 8 objects, prior-free) against the "
        "per-frame call on each view's 8 crops: " + json.dumps({
            k: {"ms per call": round(v["ms"], 3), "crops/s": round(128 / v["ms"] * 1e3, 1),
                "crops with equal uv": f"{v['equal']} of 128",
                "max uv diff": gap(v["uv_b"], v["uv_f"])} for k, v in direct.items()})
        + f"; bf16 gate: the bf16 net's per-frame uv gap to the f32 net on the same crops, "
        f"{bf16_gate:.4f}")
    if direct["int8"]["equal"] != 128:
        raise AssertionError("int8: the 128-crop batched call's uv differs from the per-frame "
                             f"call's on {128 - direct['int8']['equal']} crops")
    if not bf16_err <= bf16_gate:
        raise AssertionError(f"bf16: batched uv {bf16_err:.4f} from the per-frame call's, "
                             f"beyond the bf16 error {bf16_gate:.4f}")
    del direct, imgs

    legs = {}
    with guide.installed():
        for label, n_items, kw in (
                ("single view bf16", n_views, dict(nviews=1, net=net16)),
                ("single view bf16 batched", n_views, dict(nviews=1, net=net16, batched=True)),
                ("single view int8", n_views, dict(nviews=1, net=net16, int8=True,
                                                   int8_scales=side)),
                ("single view int8 batched", n_views, dict(nviews=1, net=net16, int8=True,
                                                           int8_scales=side, batched=True)),
                ("SLAM int8", n_views, dict(nviews=-1, net=net16, int8=True, int8_scales=side)),
                ("SLAM int8 pipelined", n_views, dict(nviews=-1, net=net16, int8=True,
                                                      int8_scales=side,
                                                      pipeline_scenes=THROUGHPUT_SCENES)),
                ("SLAM bf16", n_views, dict(nviews=-1, net=net16)),
                ("SLAM bf16 pipelined", n_views, dict(nviews=-1, net=net16,
                                                      pipeline_scenes=THROUGHPUT_SCENES)),
                ("SfM int8", n_views, dict(nviews=2, net=net16, int8=True, int8_scales=side)),
                ("SfM int8 pipelined", n_views, dict(nviews=2, net=net16, int8=True,
                                                     int8_scales=side, pipeline_scenes=3))):
            legs[label] = _throughput_leg(label, root, base, dev, guide, n_items, **kw)

    fails = []
    for seq in ("single view int8", "SLAM int8", "SfM int8"):
        thr = seq + (" batched" if seq.startswith("single") else " pipelined")
        same = legs[seq]["csv"] == legs[thr]["csv"]
        log(f"[throughput] {thr} against {seq}: CSV equal byte for byte: {same}; "
            f"{legs[thr]['wall'] / n_views * 1e3:.2f} against {legs[seq]['wall'] / n_views * 1e3:.2f}"
            f" ms per {'keyframe' if seq.startswith('SfM') else 'view'}")
        if not same or not legs[seq]["csv"]:
            fails.append(f"{thr}: the CSV differs from the sequential sweep's (or is empty)")
    a, b = legs["single view bf16"], legs["single view bf16 batched"]
    keys = lambda csv: [ln.split(",")[:4] for ln in csv.splitlines()]
    log(f"[throughput] single view bf16 batched: AUC {b['auc']:.2f} against {a['auc']:.2f} "
        f"sequential (gate 1.0 point), equal CSV keys {keys(a['csv']) == keys(b['csv'])}; "
        f"{b['wall'] / n_views * 1e3:.2f} against {a['wall'] / n_views * 1e3:.2f} ms per view")
    if abs(a["auc"] - b["auc"]) > 1.0 or keys(a["csv"]) != keys(b["csv"]):
        fails.append("single view bf16 batched: AUC or CSV rows differ from the sequential sweep")
    for label in ("SLAM bf16", "SLAM bf16 pipelined", "SLAM int8", "SLAM int8 pipelined"):
        leg = legs[label]
        if not (leg["auc"] > 80.0 and leg["summary"].get("cam_pose_pct") == 100.0):
            fails.append(f"{label}: AUC {leg['auc']:.2f}, camera poses "
                         f"{leg['summary'].get('cam_pose_pct')}% (want > 80, 100)")
    for label in ("SLAM bf16 pipelined", "SLAM int8 pipelined"):
        shapes = legs[label]["shapes"]
        if not any(k.startswith(f"({THROUGHPUT_SCENES}, 8, ") for k in shapes) or not any(
                k.endswith("True)") for k in shapes) or not legs[label]["counts"].get("prior_render"):
            fails.append(f"{label}: no {THROUGHPUT_SCENES} x 8 round, no round with priors, or no K5")
    for label in ("single view bf16 batched", "single view int8 batched"):
        if legs[label]["shapes"].get("(16, 8, False)", 0) != n_views // 16:
            fails.append(f"{label}: not {n_views // 16} calls of 16 x 8 = 128 crops: "
                         f"{legs[label]['shapes']}")
    for label, leg in legs.items():
        need = INT8_KERNELS if "int8" in label else ("norm_relu", "upsample_add")
        if not all(leg["counts"].get(k) for k in need + ("ba_lm",)):
            fails.append(f"{label}: {need + ('ba_lm',)} not all launched: {leg['counts']}")
    if fails:
        raise AssertionError("throughput evaluation: " + "; ".join(fails))


# --------------------------------------------- phases 12-13: data parallel, compat --
DP_WORLD = 2
DP_FRAMES, DP_SLOTS = 4, 8  # the sharded step's global batch: 4 frames x 8 object slots
CROSS_KERNELS = ("bn_stats_partial", "bn_stats_finalize", "norm_relu_bwd_sums",
                 "norm_relu_bwd_dx")  # K16 / K17's cross-rank modes (phase 12's sharded step)
COMPAT_KERNELS = ("ba_edges", "ba_schur")  # K4, K7: `ba.lm_run`'s (phase 13's compat path)
# the sharded step against one process on the joined batch, cuDNN pinned on both sides
# (deterministic, no autotuning). f32, the parity check: JAX's own tolerances for its
# sharded step (`tests/test_parallel.py`: loss rtol 5e-4, parameters atol 3e-4 after one
# SGD step of lr 1e-2) and the running averages to K16's 1e-6 relative. bf16: the runs
# part at one convolution that cuDNN computes differently for a rank's 16 crops and the
# joined 32 on equal inputs (phase 12 traces every convolution and norm by row digests:
# one such call in each dtype, out [16, 128, 64, 64] in f32 and [16, 128, 32, 32] in bf16;
# no norm parts on equal inputs, so the cross-rank statistics add no difference). That
# moves uv by ~2e-6 of its scale in f32 and by 1-3e-2 in bf16 (2^-9 a rounding), and the
# train-mode step at random weights amplifies it. So bf16 holds limits about twice the
# worst reading of seeds 0, 1 and 2 (H100 80GB HBM3, 700 W): loss 1.4e-4 - 7.1e-4,
# parameters 7.9e-4 - 1.4e-3, running averages 3.1e-3 - 4.4e-3 of their scale, update
# cosine (the biases the norms remove left out, as `_step_record` does) 0.952 - 0.963.
DP_GATES = {"f32": dict(loss=5e-4, params=3e-4, stats=1e-6),
            "bf16": dict(loss=2e-3, params=3e-3, stats=1e-2, cos=0.9)}
DP_LR = 1e-2


def _dp_batch(root, dev, seed):
    """The sharded step's global batch: the CLI's loader over phase 9's
    `train_real` (4 frames, `gt+noise` boxes, priors), 8 object slots."""
    import os

    from suo_slam_tpu_torch.data.bop import BopDataset
    from suo_slam_tpu_torch.data.loader import ConcatLoader
    from suo_slam_tpu_torch.train import harness

    ds = BopDataset(root, "train_real", bop_dset="ycbv", ignore_symmetry=False, no_aug=True,
                    det_type="gt+noise", kp_config_root=os.path.join(root, "kp_configs"),
                    seed=seed)
    np_batch = next(iter(ConcatLoader([ds], DP_FRAMES, DP_SLOTS, seed=seed, workers=1).epoch()))
    return harness.to_batch(np_batch, dev, o_pad=DP_SLOTS)


def _dp_keep(dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((DP_FRAMES * DP_SLOTS, NK), generator=g, device=dev) < 0.5


def _dp_state(dt, seed, dev):
    """The full-width net in `dt` from seeded flax-style weights, SGD."""
    import torch

    from suo_slam_tpu_torch.models.pkpnet import PkpNet
    from suo_slam_tpu_torch.train import harness

    net = PkpNet(n_stack=2, n_modules=2, features=256, dtype=dt).to(dev)
    state = harness.init_state(net, seed=seed)
    state.optimizer = torch.optim.SGD(net.parameters(), lr=DP_LR)
    return state


def _dp_record(state, metrics):
    import torch

    torch.cuda.synchronize()
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                sd={k: v.detach().float().cpu().clone() for k, v in state.net.state_dict().items()})


def _row_digest(t):
    """A digest of each leading-axis row's bits (int64 [rows]): equal rows
    give equal digests; rows that differ in any value, almost surely not."""
    import torch

    t = t.detach().contiguous()
    bits = t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).reshape(t.shape[0], -1)
    w = torch.arange(bits.shape[1], device=t.device, dtype=torch.int64) % 1000003 + 1
    return (bits.to(torch.int64) * w).sum(1).cpu()


@contextlib.contextmanager
def _dp_trace(net):
    """Record, from the step run inside, the crops (the backbone's input) and
    the net's uv as CPU copies, and in call order every convolution's and
    every norm's input and output as row digests (`_row_digest`), in the
    yielded dict."""
    import torch.nn.functional as F

    from suo_slam_tpu_torch.models.hourglass import MaskedBatchNorm

    got = {"conv": [], "norm": []}
    cut = (lambda t: t.detach().cpu().clone())
    inner = F.conv2d

    def conv2d(x, *a, **kw):
        y = inner(x, *a, **kw)
        got["conv"].append((_row_digest(x), _row_digest(y), tuple(y.shape)))
        return y

    norms = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
    hooks = [net.backbone.register_forward_pre_hook(lambda m, a: got.update(crops=cut(a[0]))),
             net.register_forward_hook(lambda m, a, o: got.update(uv=cut(o.uv)))]
    hooks += [m.register_forward_hook(lambda m, a, o: got["norm"].append(
        (_row_digest(a[0]), _row_digest(o), tuple(o.shape)))) for m in norms]
    F.conv2d = conv2d
    try:
        yield got
    finally:
        F.conv2d = inner
        for h in hooks:
            h.remove()


def _where_runs_part(got, ref, rows):
    """Where a rank's run parts from the joined batch's (`ref`, its `rows`):
    the crops' and uv's largest difference over their largest magnitude;
    for the convolutions and the norms, in call order, how many outputs
    differ, how many of those had equal inputs (each one a source of the
    difference) and the first such call with its output's shape."""
    import torch

    out = {}
    for k in ("crops", "uv"):
        d = (got[k].float() - ref[k][rows].float()).abs()
        out[k] = d.max().item() / max(ref[k][rows].float().abs().max().item(), 1e-30)
    for k in ("conv", "norm"):
        if len(got[k]) != len(ref[k]):
            raise AssertionError(f"traced {k} calls: {len(got[k])} on a rank, "
                                 f"{len(ref[k])} in the joined step")
        src, differ = [], 0
        for i, ((gi, go, shape), (ri, ro, _)) in enumerate(zip(got[k], ref[k])):
            part = not torch.equal(go, ro[rows])
            differ += part
            if part and torch.equal(gi, ri[rows]):
                src.append([i, list(shape)])
        out[k] = dict(calls=len(got[k]), differ=differ, parted_on_equal_input=len(src),
                      first=src[0] if src else None)
    return out


def _timed_collectives():
    """Wrap `mesh.all_reduce_sum` to add each call's host seconds (the gloo
    collective on CUDA tensors copies through the host and returns when done)
    to the returned dict."""
    from suo_slam_tpu_torch.parallel import mesh as pm

    acc = {"s": 0.0, "n": 0}
    inner = pm.all_reduce_sum

    def timed(t, group=None):
        t0 = time.perf_counter()
        out = inner(t, group)
        acc["s"] += time.perf_counter() - t0
        acc["n"] += 1
        return out

    pm.all_reduce_sum = timed
    return acc


def _dp_rank(rank, world, init_file, cfg, q):
    """One rank of phase 12's sharded step on cuda:0 (gloo: the ranks share the
    card): the f32 and bf16 steps from the same seeded weights, each rank's
    launches and collectives, its step ms, and sharded inference."""
    import torch

    from suo_slam_tpu_torch import _device, kernels
    from suo_slam_tpu_torch.parallel import mesh as pm
    from suo_slam_tpu_torch.train import harness

    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        dev = _device.resolve_device("cuda:0")
        mesh = pm.data_parallel_mesh([dev] * world, rank=rank, init_method=f"file://{init_file}")
        out = {"rank": rank, "backend": mesh.backend}
        batch = _dp_batch(cfg["root"], dev, cfg["seed"])
        mine = pm.shard_batch(mesh, batch)
        keep = _dp_keep(dev, cfg["seed"])
        step = harness.make_sharded_train_step(mesh)
        acc = _timed_collectives()
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            state = _dp_state(dt, cfg["seed"], dev)
            kernels.reset_counts()
            pm.reset_counts()
            with _dp_trace(state.net) as trace:
                _, m = step(state, mine, 0.0, keep)
            rec = _dp_record(state, m)
            out[f"counts {name}"] = kernels.counts()
            out[f"collectives {name}"] = pm.counts()
            torch.save(dict(rec, trace=trace), f"{cfg['out']}.{name}.{rank}.pt")
            # step ms: host clock around synchronized steps, after the measured one
            ms = []
            for _ in range(4):
                mesh.barrier()
                torch.cuda.synchronize()
                acc["s"], acc["n"] = 0.0, 0
                t0 = time.perf_counter()
                step(state, mine, 0.0, keep)
                torch.cuda.synchronize()
                ms.append((1e3 * (time.perf_counter() - t0), 1e3 * acc["s"], acc["n"]))
            out[f"step ms {name}"] = ms[1:]
        net = full_width_net(cfg["seed"]).to(dev).to(memory_format=torch.channels_last)
        crops = torch.from_numpy(np.random.default_rng(cfg["seed"] + 12).uniform(
            0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
        kernels.reset_counts()
        uv, cov, kp = pm.make_sharded_inference(net, mesh)(crops)
        out["infer counts"] = {k: v for k, v in kernels.counts().items() if v}
        torch.save({"uv": uv.cpu(), "cov": cov.cpu(), "kp_mask": kp.cpu()},
                   f"{cfg['out']}.infer.{rank}.pt")
        mesh.barrier()
        mesh.close()
        q.put(out)
    except BaseException as e:
        import traceback

        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _dp_distance(got, ref, init):
    """Loss (relative), parameters (absolute), running averages (against
    their scale) and the cosine of the two parameter updates from `init`."""
    import torch

    loss = abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) / abs(ref["metrics"]["loss"])
    sd = ref["sd"]
    norm_fed = {k for k in sd if k.endswith(".bias") and k[:-5] + ".weight" in sd
                and k not in ("classifier.bias", "backbone.heads.1.bias")}
    params, stats, ug, ur, uga, ura = 0.0, 0.0, [], [], [], []
    for k, v in sd.items():
        d = (got["sd"][k] - v).abs().max().item()
        if k.endswith((".mean", ".var")):
            stats = max(stats, d / max(v.abs().max().item(), 1.0))
        else:
            params = max(params, d)
            a, b = (got["sd"][k] - init[k]).reshape(-1).double(), (v - init[k]).reshape(-1).double()
            uga.append(a)
            ura.append(b)
            if k not in norm_fed:
                ug.append(a)
                ur.append(b)
    cos = lambda x, y: (torch.cat(x) @ torch.cat(y) / torch.cat(x).norm()
                        / torch.cat(y).norm()).item()
    return dict(loss=loss, params=params, stats=stats, cos=cos(ug, ur), cos_all=cos(uga, ura))


def check_k16_k17_cross(dev, rng):
    """K16 / K17's cross-rank modes on one card through a group of one rank:
    at the train step's norm shapes (phase 9's five, 8 of 32 rows padded; f32
    and bf16) K16's partial sums against the plain partial sums (1e-12
    relative: f64 sums in another order), its finalize bit-equal to the
    plain finalize on the same sums, K17's sums against the plain sums
    (1e-12) and its dx against the plain dx on the same sums (1e-5 of max
    f32, 2^-8 bf16); with one rank the two pairs bit-equal to the fused
    kernels (the same partial rows, in the same order). One kernel a call;
    device times (warm and L2-cold) at the largest shape beside the plain
    versions and bounds; an all-reduce of the [2C + 1] f64 sums over gloo
    and over NCCL (host and device ms). Returns the four modes' entries."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from suo_slam_tpu_torch.models import hourglass as hg
    from suo_slam_tpu_torch.parallel import mesh as pm

    tmp = tempfile.mkdtemp(prefix="suo_pg_")
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'init')}", rank=0,
                            world_size=1)
    group = dist.group.WORLD
    try:
        mask = _row_mask(dev).to(torch.uint8)
        shapes = [(TRAIN_N, 64, 128, 128), (TRAIN_N, 256, 64, 64), (TRAIN_N, 128, 64, 64),
                  (TRAIN_N, 256, 8, 8), (TRAIN_N, 128, 4, 4)]
        err = {"partial": 0.0, "finalize": 0.0, "sums": 0.0, "dx f32": 0.0, "dx bf16": 0.0}
        equal_fused = True
        cl = lambda a: torch.from_numpy(a).to(dev).contiguous(memory_format=torch.channels_last)
        rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        for shape in shapes:
            C = shape[1]
            x32 = cl((rng.normal(size=shape) * 1.5 + rng.normal(size=(1, C, 1, 1)))
                     .astype(np.float32))
            dy32 = cl(rng.normal(size=shape).astype(np.float32))
            scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
            bias = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev) * 0.3
            for dt in (torch.float32, torch.bfloat16):
                x, dy = x32.to(dt), dy32.to(dt)
                rm = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev)
                rv = torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)).to(dev)
                sums = hg._bn_stats_partial_cuda(x, mask)
                err["partial"] = max(err["partial"], rel(sums, hg.bn_stats_partial_plain(x, mask)))
                rk, vk, rp, vp = rm.clone(), rv.clone(), rm.clone(), rv.clone()
                k = hg._bn_stats_finalize_cuda(sums, scale, bias, 1e-5, rk, vk, 0.9)
                p = hg.bn_stats_finalize_plain(sums, scale, bias, 1e-5, rp, vp, 0.9)
                exact = all(torch.equal(a, b) for a, b in zip(k + (rk, vk), p + (rp, vp)))
                err["finalize"] = max(err["finalize"], 0.0 if exact else max(
                    rel(a, b) for a, b in zip(k + (rk, vk), p + (rp, vp))))
                rf, vf = rm.clone(), rv.clone()
                fused = hg._bn_train_stats_cuda(x, mask, scale, bias, 1e-5, rf, vf, 0.9)
                rc, vc = rm.clone(), rv.clone()
                cross = hg.bn_train_stats_cross(x, mask, scale, bias, 1e-5, rc, vc, 0.9, group)
                equal_fused &= all(torch.equal(a, b) for a, b in zip(fused + (rf, vf),
                                                                      cross + (rc, vc)))
                mean, _, rstd, inv, shift = fused
                s17, sg, sgc, dsc = hg._norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, mask)
                ps = hg.norm_relu_bwd_sums_plain(x, dy, inv, shift, mean, rstd, mask)
                err["sums"] = max(err["sums"], rel(s17, ps[0]))
                dx = hg._norm_relu_bwd_dx_cuda(x, dy, inv, shift, mean, rstd, mask, s17)
                pdx = hg.norm_relu_bwd_dx_plain(x, dy, inv, shift, mean, rstd, mask, s17)
                key = "dx f32" if dt == torch.float32 else "dx bf16"
                err[key] = max(err[key], rel(dx.float(), pdx.float()))
                f17 = hg._norm_relu_bwd_cuda(x, dy, inv, shift, mean, rstd, mask)
                c17 = hg.norm_relu_bwd_cross(x, dy, inv, shift, mean, rstd, mask, group)
                equal_fused &= all(torch.equal(a, b) for a, b in zip(f17, c17))
        torch.cuda.synchronize()
        log(f"[parallel] K16 / K17 cross-rank modes over {len(shapes)} shapes, f32 and bf16, "
            f"8 of 32 rows padded: " + json.dumps({k: f"{v:.3e}" for k, v in err.items()})
            + " (tol: partial and sums 1e-12 relative, finalize 0, dx f32 1e-5 of max, "
            f"bf16 2^-8); one rank's result bit-equal to the fused kernels: {equal_fused}")
        if not (err["partial"] <= 1e-12 and err["sums"] <= 1e-12 and err["finalize"] == 0.0
                and err["dx f32"] <= 1e-5 and err["dx bf16"] <= 2.0 ** -8 and equal_fused):
            raise AssertionError(f"K16 / K17 cross-rank modes: {err}, equal to fused "
                                 f"{equal_fused}")

        big = shapes[1]
        C = big[1]
        one, zero = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        entries = []
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = cl((rng.normal(size=big) * 1.5).astype(np.float32)).to(dt)
            dy = cl(rng.normal(size=big).astype(np.float32)).to(dt)
            rm, rv = zero.clone(), one.clone()
            mean, _, rstd, inv, shift = hg._bn_train_stats_cuda(x, mask, one, zero, 1e-5, rm, rv)
            s16 = hg._bn_stats_partial_cuda(x, mask)
            s17 = hg._norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, mask)[0]
            fns = {
                "bn_stats_partial": (lambda: hg._bn_stats_partial_cuda(x, mask),
                                     lambda: hg.bn_stats_partial_plain(x, mask)),
                "bn_stats_finalize": (
                    lambda: hg._bn_stats_finalize_cuda(s16, one, zero, 1e-5, rm, rv, 0.9),
                    lambda: hg.bn_stats_finalize_plain(s16, one, zero, 1e-5, rm, rv, 0.9)),
                "norm_relu_bwd_sums": (
                    lambda: hg._norm_relu_bwd_sums_cuda(x, dy, inv, shift, mean, rstd, mask),
                    lambda: hg.norm_relu_bwd_sums_plain(x, dy, inv, shift, mean, rstd, mask)),
                "norm_relu_bwd_dx": (
                    lambda: hg._norm_relu_bwd_dx_cuda(x, dy, inv, shift, mean, rstd, mask, s17),
                    lambda: hg.norm_relu_bwd_dx_plain(x, dy, inv, shift, mean, rstd, mask,
                                                      s17))}
            n, es = x.numel(), x.element_size()
            real = int(mask.sum().item()) * n // big[0]
            sums_b = (2 * C + 1) * 8
            cost = {"bn_stats_partial": (real * es + sums_b, 3 * real),
                    "bn_stats_finalize": (sums_b + 11 * C * 4, 12 * C),
                    "norm_relu_bwd_sums": (2 * n * es + 7 * C * 4 + sums_b, 8 * n),
                    "norm_relu_bwd_dx": (3 * n * es + 4 * C * 4 + sums_b, 10 * n)}
            per_call = {k: launches_per_call(f) for k, (f, _) in fns.items()}
            if any(v != 1 for v in per_call.values()):
                raise AssertionError(f"cross-rank modes: kernels a call {per_call}")
            for kname, (fn, plain) in fns.items():
                ms, plain_ms = cuda_ms(fn), cuda_ms(plain, n=5, inner=2)
                cold = 1e3 * cuda_ms_cold(fn)
                b = bound(*cost[kname])
                e = (err["partial"] if kname == "bn_stats_partial" else err["finalize"]
                     if kname == "bn_stats_finalize" else err["sums"]
                     if kname == "norm_relu_bwd_sums" else err[f"dx {name}"])
                _report(f"{kname} ({name}, {list(big)}, 8 of 32 rows padded; L2-cold device "
                        f"{cold:.3f} us)", e, "see above", ms, plain_ms, None, b)
                if name == "bf16":
                    entries.append(dict(name=kname, route="cuda",
                                        source="suo_slam_tpu_torch/csrc/bn_train.cu",
                                        replaces="suo_slam_tpu/models/hourglass.py:69"
                                        if kname.startswith("bn_stats")
                                        else "suo_slam_tpu/models/hourglass.py:88",
                                        max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                                        bound_by=b[1], library_ms=None, cold_us=cold))
        log(f"[parallel] cross-rank modes, kernels a call (captured graph): "
            + json.dumps(per_call))

        # the all-reduce of one norm's sums: gloo (a world of one here) and NCCL
        t = torch.zeros(2 * 256 + 1, dtype=torch.float64, device=dev)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on loopback
        nccl = dist.new_group([0], backend="nccl")
        for label, g in (("gloo", group), ("nccl", nccl)):
            for _ in range(3):
                pm.all_reduce_sum(t, g)
            torch.cuda.synchronize()
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                pm.all_reduce_sum(t, g)
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
            dev_ms = cuda_ms(lambda: pm.all_reduce_sum(t, g), n=10, inner=10)
            log(f"[parallel] all-reduce of [{t.numel()}] f64 sums over {label} (one rank): "
                f"host {statistics.median(host):.4f} ms synchronized (median of 20), "
                f"{dev_ms:.4f} ms a call between CUDA events")
        return entries
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, seed):
    """Phase 12 (the module docstring's): data parallelism."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.train import harness

    base, root = _eval_root()
    rng = np.random.default_rng(seed + 12)
    entries = check_k16_k17_cross(dev, rng)

    # the sharded step: two ranks on this card over gloo against one process
    t0 = time.perf_counter()
    work = os.path.join(base, "parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = {"root": root, "seed": seed, "out": os.path.join(work, "dp")}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(tempfile.mkdtemp(prefix="suo_pg_"), "init")
    procs = [ctx.Process(target=_dp_rank, args=(r, DP_WORLD, init, cfg, q))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    try:
        ranks = sorted((q.get(timeout=600) for _ in procs), key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError("sharded step ranks failed:\n" + "\n".join(errors))
    log(f"[parallel] {DP_WORLD} ranks on {dev} ({ranks[0]['backend']}): "
        f"{time.perf_counter() - t0:.1f} s, their start included")
    batch, keep = _dp_batch(root, dev, seed), _dp_keep(dev, seed)
    step = harness.make_train_step()
    n_rank = DP_FRAMES * DP_SLOTS // DP_WORLD  # a rank's crops
    gates_ok, rank_counts, timing = True, {}, {}
    with _pinned_cudnn():  # as on the ranks
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            state = _dp_state(dt, seed, dev)
            init = {k: v.detach().float().cpu().clone()
                    for k, v in state.net.state_dict().items()}
            kernels.reset_counts()
            with _dp_trace(state.net) as ref_trace:
                _, m = step(state, batch, 0.0, keep)
            ref = _dp_record(state, m)
            one_counts = kernels.counts()
            ms = []
            for _ in range(4):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(state, batch, 0.0, keep)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t1))
            got = [torch.load(f"{cfg['out']}.{name}.{r}.pt") for r in range(DP_WORLD)]
            same = all(torch.equal(got[0]["sd"][k], g["sd"][k])
                       for g in got[1:] for k in ref["sd"])
            d = _dp_distance(got[0], ref, init)
            for r, g in enumerate(got):
                part = _where_runs_part(g["trace"], ref_trace,
                                        slice(r * n_rank, (r + 1) * n_rank))
                log(f"[parallel]   where rank {r}'s run parts from the joined batch's ({name}, "
                    f"cuDNN deterministic, no autotuning): " + json.dumps(part))
                if part["crops"]:
                    raise AssertionError(f"sharded step ({name}): rank {r}'s crops differ from "
                                         f"the joined batch's ({part['crops']})")
            gate = DP_GATES[name]
            ok = (d["loss"] <= gate["loss"] and d["params"] <= gate["params"]
                  and d["stats"] <= gate["stats"] and d["cos"] >= gate.get("cos", -1.0) and same)
            gates_ok &= ok
            log(f"[parallel] sharded step ({name}, {DP_WORLD} ranks x {DP_FRAMES // DP_WORLD} "
                f"frames x {DP_SLOTS} slots, SGD lr {DP_LR}) against one process on the joined "
                f"batch: "
                + json.dumps({k: f"{v:.3e}" for k, v in d.items()})
                + f" (gates {json.dumps(gate)}); loss {got[0]['metrics']['loss']:.6f} "
                f"(one process {ref['metrics']['loss']:.6f}); ranks' parameters and running "
                f"averages equal: {same}")
            for r in ranks:
                c = r[f"counts {name}"]
                rank_counts[(name, r["rank"])] = c
                log(f"[parallel]   rank {r['rank']} ({name}): launches "
                    + json.dumps({k: c[k] for k in CROSS_KERNELS + (
                        "bn_stats", "norm_relu_bwd", "norm_relu", "upsample_add_bwd")})
                    + f"; collectives {json.dumps(r[f'collectives {name}'])}; step ms (host, "
                    f"synchronized), collectives' host ms, calls: {r[f'step ms {name}']}")
            log(f"[parallel]   one process ({name}): step ms {[round(v, 3) for v in ms[1:]]}; "
                f"launches " + json.dumps({k: one_counts[k] for k in CROSS_KERNELS + (
                    "bn_stats", "norm_relu_bwd")}))
            timing[name] = (statistics.median([v[0] for v in ranks[0][f"step ms {name}"]]),
                            statistics.median(ms[1:]))
    want = {k: NORMS_PER_FWD for k in CROSS_KERNELS}
    for (name, r), c in rank_counts.items():
        if {k: c[k] for k in CROSS_KERNELS} != want or c["bn_stats"] or c["norm_relu_bwd"]:
            raise AssertionError(f"rank {r} ({name}): cross-rank launches "
                                 f"{ {k: c[k] for k in CROSS_KERNELS} } (want {want}), fused "
                                 f"{c['bn_stats']} / {c['norm_relu_bwd']} (want 0)")
    coll = ranks[0]["collectives bf16"]["all_reduce"]
    if coll != 2 * NORMS_PER_FWD + 3:
        raise AssertionError(f"sharded step: {coll} all-reduces, want {2 * NORMS_PER_FWD + 3}")
    if not gates_ok:
        raise AssertionError("the sharded step disagrees with one process on the joined batch")
    log(f"[parallel] step ms, 2 ranks on one card vs one process (median): "
        + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in timing.items()}))

    # sharded inference against the local forward
    net = full_width_net(seed).to(dev).to(memory_format=torch.channels_last).eval()
    crops = torch.from_numpy(np.random.default_rng(seed + 12).uniform(
        0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        out = net(crops)
    worst = 0.0
    for r in range(DP_WORLD):
        got = torch.load(f"{cfg['out']}.infer.{r}.pt")
        for k in ("uv", "cov", "kp_mask"):
            worst = max(worst, (got[k] - getattr(out, k).cpu()).abs().max().item())
    log(f"[parallel] sharded inference ({DP_WORLD} ranks x {N_OBJ // DP_WORLD} crops, f32 net) "
        f"against the local forward: max abs {worst:.3e} (tol 1e-3); rank 0's launches "
        f"{json.dumps(ranks[0]['infer counts'])}")
    if worst > 1e-3:
        raise AssertionError(f"sharded inference differs from the local forward by {worst}")
    cli_counts = train_cli_torchrun(dev, base, root)
    return entries, rank_counts[("bf16", 0)], cli_counts


def train_cli_torchrun(dev, base, root):
    """`python -m torch.distributed.run --nproc_per_node 1 -m
    suo_slam_tpu_torch.train` (NCCL, one rank: the group's start, rank 0's
    writes, the cross-rank modes) against the plain start on the same flags,
    one step each: the checkpoints' running averages within K16's 1e-6
    relative. Returns the plain run's launches."""
    import os
    import shutil
    import signal

    from suo_slam_tpu_torch.train import checkpoint as ck

    argv = ["--dataset", "ycbv", "--data_split", "real", "--no_augmentations",
            "--steps_per_epoch", "1", "--epochs", "1", "--val_steps", "1", "--no_resume",
            "--data_root", root, "--kp_config_root", os.path.join(root, "kp_configs")]
    runs = {}
    for name in ("plain", "torchrun"):
        work = os.path.join(base, f"train_cli_{name}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        t0 = time.perf_counter()
        if name == "plain":
            rc, text, _, counts, hits, _ = _cli_run(argv, work)
        else:
            repo = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, PYTHONPATH=repo + (
                os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""))
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: NCCL's bootstrap on loopback
            proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                                     "--standalone", "--nproc_per_node", "1", "-m",
                                     "suo_slam_tpu_torch.train"] + argv, cwd=work, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            try:
                text, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise AssertionError("the torchrun training CLI ran past 600 s")
            rc, counts, hits = proc.returncode, None, {}
        wall = time.perf_counter() - t0
        res = os.path.join(work, "results")
        dirs = os.listdir(res) if os.path.isdir(res) else []
        if rc != 0 or len(dirs) != 1 or hits:
            raise AssertionError(f"training CLI ({name}): rc {rc}, {dirs}, plain on CUDA "
                                 f"{hits}:\n{text[-4000:]}")
        outdir = os.path.join(res, dirs[0])
        runs[name] = ck._payload(os.path.join(outdir, "checkpoint-latest"))
        dp = [line for line in text.splitlines() if line.startswith(("Data parallel", "Epoch"))]
        log(f"[parallel] training CLI, {name}: rc {rc}, {wall:.1f} s; files "
            f"{sorted(os.listdir(outdir))}; " + " | ".join(dp))
        if name == "torchrun" and "Data parallel: 1 ranks (nccl)" not in text:
            raise AssertionError(f"torchrun CLI did not join an NCCL group:\n{text[-4000:]}")
        if name == "plain":
            plain_counts = counts

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{p}/{k}")
        else:
            yield p, np.asarray(t, np.float64)

    a, b = dict(leaves(runs["plain"]["batch_stats"])), dict(leaves(runs["torchrun"]["batch_stats"]))
    worst = max(np.abs(b[k] - a[k]).max() / max(np.abs(a[k]).max(), 1e-30) for k in a)
    log(f"[parallel] running averages after one step, torchrun (one NCCL rank, cross-rank "
        f"modes) against the plain start (fused): {worst:.3e} relative (tol 1e-6)")
    if worst > 1e-6:
        raise AssertionError(f"torchrun CLI statistics {worst} from the plain start's")
    return plain_counts


def _g2o_graph(g2o, device):
    """`tests/test_compat_g2o.py`'s graph: 2 cameras x 2 objects x 12 points,
    the second camera perturbed, through the public g2o API."""
    rng = np.random.default_rng(0)
    k4 = np.array([1.2, 1.2, 0.0, 0.0])
    opt = g2o.SparseOptimizer(device=device)
    opt.set_algorithm(g2o.OptimizationAlgorithmLevenberg(
        g2o.BlockSolverSE3(g2o.LinearSolverDenseSE3())))
    objs, obj_gt, cams, cam_gt = [], [], [], []
    for j in range(2):
        T = np.eye(4)
        T[:3, 3] = [60.0 * j - 30.0, 0.0, 600.0]
        v = g2o.VertexSE3Expmap()
        v.set_id(j)
        v.set_estimate(g2o.SE3Quat(T[:3, :3], T[:3, 3]))
        opt.add_vertex(v)
        objs.append(v)
        obj_gt.append(T)
    for i in range(2):
        T = np.eye(4)
        T[:3, 3] = [5.0 * i, 0.0, 0.0]
        T0 = T.copy()
        if i == 1:
            T0[:3, 3] += [3.0, -2.0, 4.0]
        v = g2o.VertexSE3Expmap()
        v.set_id(2 + i)
        v.set_estimate(g2o.SE3Quat(T0[:3, :3], T0[:3, 3]))
        v.set_fixed(i == 0)
        opt.add_vertex(v)
        cams.append(v)
        cam_gt.append(T)
    pts = rng.uniform(-40, 40, (2, 12, 3))
    for j in range(2):
        for i in range(2):
            for p in pts[j]:
                pc = cam_gt[i][:3, :3] @ (obj_gt[j][:3, :3] @ p + obj_gt[j][:3, 3]) \
                    + cam_gt[i][:3, 3]
                e = g2o.EdgeSE3ProjectFromObject(k4, p)
                e.set_vertex(0, objs[j])
                e.set_vertex(1, cams[i])
                e.set_measurement(1.2 * pc[:2] / pc[2] + rng.normal(0, 1e-3, 2))
                e.set_information(np.eye(2) * 1e4)
                e.set_robust_kernel(g2o.RobustKernelHuber(np.sqrt(5.991)))
                opt.add_edge(e)
    return opt, objs + cams


def phase_compat(dev, seed):
    """Phase 13 (the module docstring's): the compat shims on the card."""
    from suo_slam_tpu_torch import kernels
    from suo_slam_tpu_torch.compat import g2o, lambdatwist

    out, ms = {}, {}
    for d in ("cpu", dev):
        opt, verts = _g2o_graph(g2o, d)
        opt.initialize_optimization(0)
        kernels.reset_counts()
        t0 = time.perf_counter()
        opt.optimize(20)
        ms[str(d)] = 1e3 * (time.perf_counter() - t0)
        counts = kernels.counts()
        out[str(d)] = [v.estimate().matrix() for v in verts]
    worst = 0.0
    for a, b in zip(out["cpu"], out[str(dev)]):
        worst = max(worst, np.abs(a[:3, :3] - b[:3, :3]).max(),
                    np.abs(a[:3, 3] - b[:3, 3]).max() / 600.0)
    k = {n: counts[n] for n in COMPAT_KERNELS + ("ba_lm",)}
    log(f"[compat] g2o graph (2 cameras x 2 objects x 12 points, Huber, 20 LM iterations) on "
        f"the card against the CPU: {worst:.3e} (tol 1e-4: rotations, translations over the "
        f"scene's depth 600); optimize ms card {ms[str(dev)]:.2f}, CPU {ms['cpu']:.2f}; "
        f"launches {json.dumps(k)}")
    if worst > 1e-4 or not (k["ba_edges"] > 0 and k["ba_schur"] > 0) or k["ba_lm"]:
        raise AssertionError(f"compat g2o on the card: {worst}, launches {k}")
    compat_counts = dict(counts)
    rng = np.random.default_rng(seed + 13)
    R = random_rotation(rng)
    t = np.array([0.1, -0.05, 2.0])
    x = rng.uniform(-0.5, 0.5, (NK, 3))
    pc = x @ R.T + t
    y = pc[:, :2] / pc[:, 2:3]
    kernels.reset_counts()
    T_card = lambdatwist.pnp(x, y, device=dev)
    k15 = kernels.counts()["pnp_ransac"]
    T_cpu = lambdatwist.pnp(x, y, device="cpu")
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = R, t
    e_card = max(np.abs(T_card - gt)[:3, :3].max(), np.abs(T_card - gt)[:3, 3].max() / 2.0)
    e_cpu = max(np.abs(T_cpu - gt)[:3, :3].max(), np.abs(T_cpu - gt)[:3, 3].max() / 2.0)
    log(f"[compat] lambdatwist.pnp on {NK} clean points: card {e_card:.3e}, CPU {e_cpu:.3e} "
        f"from the true pose (tol 1e-4); K15 launches {k15}")
    if e_card > 1e-4 or e_cpu > 1e-4 or k15 != 1:
        raise AssertionError(f"compat lambdatwist: {e_card} / {e_cpu}, K15 {k15}")
    compat_counts["pnp_ransac"] = k15
    return compat_counts


# ------------------------------------------------------- phase 14: the tools --
TOOLS_FOLD = 16  # the tools mesh's rotational symmetry about z: 16 candidates


def tools_mesh(n_u=256, n_v=64, R=35.0, r=14.0, fold=TOOLS_FOLD):
    """A closed torus of 2 n_u n_v triangles about z (mm; 32,768 at the
    defaults, T-LESS CAD scale), its radius modulated `fold` times around,
    so that a turn of 360 / fold degrees about z maps it onto itself vertex
    for vertex (n_u a multiple of fold)."""
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = R * (1.0 + 0.15 * np.cos(fold * uu)) + r * np.cos(vv)
    verts = np.stack([ring * np.cos(uu), ring * np.sin(uu), r * np.sin(vv)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
    c, d = ((i + 1) % n_u) * n_v + (j + 1) % n_v, i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int32)


def write_tools_tree(root, seed, n_u=256):
    """Phase 7's BOP tree (its objects and scene, from the same seed; 2 of its
    views) with object 1 made `tools_mesh` (a binary PLY with faces) and given
    the mesh's 15 turns about z as its discrete symmetries. Returns the
    mesh's (verts, faces)."""
    import os

    rng = np.random.default_rng(seed + 2)
    objs = EvalObjects(rng)
    write_bop_tree(root, objs, [SlamScene(rng, objs, EVAL_VIEWS)], n_views=2)
    verts, faces = tools_mesh(n_u)
    models = os.path.join(root, "models_bop-compat")
    with open(os.path.join(models, "obj_000001.ply"), "wb") as f:
        f.write(f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
                "end_header\n".encode())
        f.write(verts.astype("<f4").tobytes())
        rec = np.zeros(len(faces), [("n", "u1"), ("v", "<i4", (3,))])
        rec["n"], rec["v"] = 3, faces
        f.write(rec.tobytes())
    with open(os.path.join(models, "models_info.json")) as f:
        info = json.load(f)
    syms = []
    for k in range(1, TOOLS_FOLD):
        a = 2 * math.pi * k / TOOLS_FOLD
        T = np.eye(4)
        T[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
        syms.append(T.reshape(-1).tolist())
    info["1"] = {"diameter": float(2.0 * np.linalg.norm(verts, axis=1).max()),
                 "symmetries_discrete": syms}
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    return verts, faces


def _quiet(fn, *a):
    """fn(*a) with its standard output captured: (result, text, wall ms)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = fn(*a)
    return r, buf.getvalue(), 1e3 * (time.perf_counter() - t0)


def tools_leg(root, seed, out):
    """One pass of the tools over `root` into `out`: a scripted labeling
    session on object 1 (clicks on every view, an inspection refused and
    one accepted after a view-pose adjustment, a save into the tree's
    kp_info), `manual_keypoints --viz` over the tree, `view_sym_choice` of
    object 1 in view 0. Returns ({output: sha256}, host ms, the printed
    symmetry line)."""
    import hashlib
    import os

    from suo_slam_tpu_torch import manual_keypoints as mk
    from suo_slam_tpu_torch import view_sym_choice as vs
    from suo_slam_tpu_torch.data.mesh import load_mesh_db
    from suo_slam_tpu_torch.kp import config as kp_config
    from suo_slam_tpu_torch.tools.labeling import KeypointLabeler

    ms = {}
    db = load_mesh_db(os.path.join(root, "models_bop-compat"))
    t0 = time.perf_counter()
    lab = KeypointLabeler(db.verts_full[1], db.faces[1], mk.K_LABEL,
                          diameter=float(db.diameter[0]))
    ms["labeler"] = 1e3 * (time.perf_counter() - t0)
    names = kp_config.load_kp_config("ycbv", os.path.join(root, "kp_configs")).kp_names[0]
    kp_json = os.path.join(root, "kp_info", "obj_000001_kp_info.json")
    s = mk.LabelSession(lab, names, kp_json)
    h, w = lab.hw
    rng = np.random.default_rng(seed + 14)
    for k in range(len(names)):  # keypoint k on views 2k .. 2k + 3: every view clicked
        for vi in ((2 * k + j) % 8 for j in range(4)):
            ys, xs = np.nonzero(lab.depths[vi] > 0)
            p = int(rng.integers(len(xs)))
            _quiet(s.click, (vi % 4) * w + int(xs[p]), (vi // 4) * h + int(ys[p]))
        if k == 0:  # an inspection with a keypoint short of samples is not accepted
            _quiet(s.key, "n")
            ys, xs = np.nonzero(lab.depths[0] > 0)
            _quiet(s.click, int(xs[0]), int(ys[0]))
            _quiet(s.key, "v")
            _, text, _ = _quiet(s.key, "\r")
            if s.inspection is None or "ERROR" not in text:
                raise AssertionError(f"tools: an inspection short of samples was accepted: {text}")
            _quiet(s.key, "\x1b")
            _quiet(s.key, "p")
            _, text, _ = _quiet(s.click, 2, 2)  # off the surface
            if "MISSED" not in text:
                raise AssertionError(f"tools: a click off the surface was taken: {text}")
        _quiet(s.key, "n")
    _quiet(s.key, "v")
    for key in "wwaaio":
        _quiet(s.key, key)
    t0 = time.perf_counter()
    img, ok = lab.render_inspection()
    ms["render_inspection"] = 1e3 * (time.perf_counter() - t0)
    _, text, _ = _quiet(s.key, "\r")
    if s.inspection is not None or "Accepted view_pose" not in text:
        raise AssertionError(f"tools: the adjusted view pose was not accepted: {text}")
    _, text, _ = _quiet(s.key, "s")
    _quiet(s.key, "q")
    if not (s.done and "Saved" in text and os.path.isfile(kp_json)):
        raise AssertionError(f"tools: the session did not save: {text}")
    saved = json.load(open(kp_json))
    if sorted(saved["keypoints"]) != sorted(names) or \
            not np.allclose(np.reshape(saved["view_pose"], (4, 4)), lab.view_pose):
        raise AssertionError("tools: the saved kp_info lacks a keypoint or the view pose")
    viz_dir = os.path.join(out, "kp_info_viz")
    rc, text, ms["manual_keypoints_viz"] = _quiet(mk.main, [
        "--dataset", "ycbv", "--viz", "--data_root", root, "--out", viz_dir,
        "--kp_config_root", os.path.join(root, "kp_configs")])
    if rc or text.count("Wrote") != N_OBJ:
        raise AssertionError(f"manual_keypoints --viz: rc {rc}\n{text}")
    sym_png = os.path.join(out, "sym_choice.png")
    rc, text, ms["view_sym_choice"] = _quiet(vs.main, [
        "--dataset", "ycbv", "--data_root", root, "--obj_id", "1", "--out", sym_png,
        "--kp_config_root", os.path.join(root, "kp_configs")])
    line = text.strip().splitlines()[-1] if text.strip() else ""
    if rc or not line.startswith("Best symmetry index: ") or f"/{TOOLS_FOLD};" not in line:
        raise AssertionError(f"view_sym_choice: rc {rc}\n{text}")
    files = {"kp_info.json": kp_json, "sym_choice.png": sym_png}
    files.update({f"kp_info_viz/{f}": os.path.join(viz_dir, f) for f in os.listdir(viz_dir)})
    digests = {k: hashlib.sha256(open(f, "rb").read()).hexdigest() for k, f in files.items()}
    return digests, ms, line


def phase_tools(seed):
    """Phase 14 (the module docstring's): the labeling and symmetry-choice
    tools, host numpy, on the card's machine. Returns the figures printed."""
    import os

    from suo_slam_tpu_torch.data import png
    from suo_slam_tpu_torch.eval.render import render_shaded
    from suo_slam_tpu_torch.manual_keypoints import K_LABEL
    from suo_slam_tpu_torch.tools.labeling import canonical_view_poses

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tools")
    root = os.path.join(base, "bop_datasets", "ycbv")
    t0 = time.perf_counter()
    verts, faces = write_tools_tree(root, seed)
    log(f"[tools] phase 7's BOP tree (2 views) with object 1 a closed mesh of {len(faces)} "
        f"triangles and {TOOLS_FOLD} symmetry candidates written in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"triangles": int(len(faces))}
    T = canonical_view_poses(float(2.0 * np.linalg.norm(verts, axis=1).max()))[1]
    for hw, K in (((240, 320), K_LABEL), ((H_IMG, W_IMG), YCBV_K)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rgb, depth = render_shaded(verts, faces, K, T, hw)
            times.append(1e3 * (time.perf_counter() - t0))
        cover = float((depth > 0).mean())
        if not (0.02 < cover < 0.9 and rgb[depth > 0].min() > 0):
            raise AssertionError(f"render_shaded at {hw}: covers {cover:.3f} of the image")
        out[f"render_shaded_ms_{hw[0]}x{hw[1]}"] = statistics.median(times)
    # the tools twice on the same inputs: every output must repeat bit for bit
    kp_json = os.path.join(root, "kp_info", "obj_000001_kp_info.json")
    written = open(kp_json, "rb").read()  # the session overwrites it
    legs = []
    for rep in range(2):
        with open(kp_json, "wb") as f:
            f.write(written)
        legs.append(tools_leg(root, seed, os.path.join(base, f"out{rep}")))
    (d0, ms0, line0), (d1, ms1, line1) = legs
    if d0 != d1 or line0.split(";")[0] != line1.split(";")[0]:
        diff = sorted(k for k in set(d0) | set(d1) if d0.get(k) != d1.get(k))
        raise AssertionError(f"tools: the second pass differs from the first: {diff}, "
                             f"{line0!r} / {line1!r}")
    grid = png.imread(os.path.join(base, "out0", "sym_choice.png"))
    if grid.shape != (4 * H_IMG, 4 * W_IMG, 3):
        raise AssertionError(f"view_sym_choice grid {grid.shape}, not 4 x 4 tiles of 480x640")
    for k in ms0:
        out[f"{k}_ms"] = [ms0[k], ms1[k]]
    out["symmetry"] = line0.split(";")[0]
    out["outputs"] = len(d0)
    log(f"[tools] host ms (two passes): render_shaded 240x320 "
        f"{out['render_shaded_ms_240x320']:.1f}, 480x640 {out['render_shaded_ms_480x640']:.1f} "
        f"(median of 5, {len(faces)} triangles); labeler (8 views at 240x320) "
        f"{ms0['labeler']:.1f} / {ms1['labeler']:.1f}; render_inspection "
        f"{ms0['render_inspection']:.1f} / {ms1['render_inspection']:.1f}; manual_keypoints "
        f"--viz ({N_OBJ} objects) {ms0['manual_keypoints_viz']:.1f} / "
        f"{ms1['manual_keypoints_viz']:.1f}; view_sym_choice (480x640, {TOOLS_FOLD} "
        f"candidates) {ms0['view_sym_choice']:.1f} / {ms1['view_sym_choice']:.1f}; "
        f"{line0}; {len(d0)} outputs equal in both passes (sha256); {smi_line()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--frames", type=int, default=22)
    ap.add_argument("--step-only", action="store_true",
                    help="build, then time the full-width bf16 train step only")
    ap.add_argument("--norm", choices=("batch", "group"), default="batch",
                    help="the net --step-only times (BatchNorm or GroupNorm)")
    ap.add_argument("--int8-only", action="store_true",
                    help="build, then time the full-width int8 forward at 128 crops only")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, write the training split, then phases 12 and 13 only")
    ap.add_argument("--tools-only", action="store_true",
                    help="the labeling and symmetry-choice tools (phase 14) only")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    dev = phase_card()
    if args.tools_only:
        r = phase_tools(args.seed)
        log(smi_line())
        log(json.dumps({"tools": r}))
        return 0
    phase_build()
    if args.step_only:
        r = phase_step_only(dev, args.seed, args.norm)
        log(smi_line())
        log(json.dumps({"step": r}))
        return 0
    if args.int8_only:
        r = phase_int8_only(dev, args.seed)
        log(smi_line())
        log(json.dumps({"int8_128": r}))
        return 0
    if args.parallel_only:
        base, root = _eval_root()
        rng = np.random.default_rng(args.seed + 2)
        objs = EvalObjects(rng)
        write_bop_tree(root, objs, [SlamScene(rng, objs, EVAL_VIEWS)])
        write_train_split(root, EvalObjects(np.random.default_rng(args.seed + 2)),
                          np.random.default_rng(args.seed + 9))
        entries, counts, _ = phase_parallel(dev, args.seed)
        compat = phase_compat(dev, args.seed)
        log(smi_line())
        log(json.dumps({"kernels": [dict(e, launches=counts[e["name"]]) for e in entries],
                        "compat": {k: compat[k] for k in COMPAT_KERNELS + ("pnp_ransac",)}}))
        return 0
    rng = np.random.default_rng(args.seed)
    objs = Objects(rng)
    net = full_width_net(args.seed)
    from suo_slam_tpu_torch.slam import kernels as sk

    net = sk.make_frame_inference(net, device=dev).net  # on the card, eval, channels_last
    net16 = sk.make_frame_inference(full_width_net(args.seed, torch.bfloat16), device=dev).net
    crops = torch.from_numpy(rng.uniform(0, 1, (N_OBJ, 256, 256, 3)).astype(np.float32)).to(dev)
    scene = SlamScene(np.random.default_rng(args.seed + 1), objs, args.frames + 1)
    entries = [check_k1(dev, rng, objs), check_k2(dev, rng, net), check_k3(dev, rng, objs),
               check_k4(dev, rng, objs), check_k5(dev, rng, net16), check_k6(dev, rng, objs),
               check_k7(dev, scene), check_k8(dev, rng, net, net16, crops), check_k9(dev, rng),
               check_k10(dev, rng), check_k14(dev, np.random.default_rng(args.seed + 14), objs),
               check_k15(dev, np.random.default_rng(args.seed + 15)),
               check_k22(dev, np.random.default_rng(args.seed + 22))]
    phase_bf16_net(dev, rng, args.seed, net, net16, crops)
    phase_main_path(dev, rng, objs, net, args.seed, args.views)
    phase_solver_check(dev, rng, objs, args.seed, args.views)
    counts = phase_slam(dev, rng, objs, net, args.seed, scene)
    eval_counts = phase_evaluate(dev, args.seed, net16)
    int8_entries, int8_counts, k2_bf16_err = phase_int8(dev, rng, args.seed, net, net16, crops,
                                                        objs, scene)
    entries[1]["max_abs_err"] = max(entries[1]["max_abs_err"], k2_bf16_err)
    train_entries, train_counts, u_counts = phase_train(dev, args.seed)
    quant_entries, quant_counts = phase_quant(dev, args.seed, net, net16, crops)
    group_entries, group_counts = phase_group(dev, args.seed, objs, scene)
    phase_throughput(dev, args.seed, net, net16)
    parallel_entries, parallel_counts, _ = phase_parallel(dev, args.seed)
    compat_counts = phase_compat(dev, args.seed)
    log(json.dumps({"tools": phase_tools(args.seed)}))
    entries += int8_entries + train_entries + quant_entries + group_entries + parallel_entries
    for e in entries:
        e["launches"] = (eval_counts if e["name"] in EVAL_KERNELS else int8_counts
                         if e["name"] in INT8_KERNELS + ("int8_pool_junction",) else train_counts
                         if e["name"] in TRAIN_KERNELS else quant_counts
                         if e["name"] in QUANT_KERNELS else group_counts
                         if e["name"] in GROUP_KERNELS else parallel_counts
                         if e["name"] in CROSS_KERNELS else compat_counts
                         if e["name"] in COMPAT_KERNELS else counts)[e["name"]]
    for e in entries:  # K2 / K19 in phase 9's -u training run (4 steps + 2 val batches)
        if e["name"] in ("heatmap_readout", "heatmap_readout_bwd"):
            e["launches_u_run"] = u_counts[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    extra = ["launches_u_run"]
    log(json.dumps({"kernels": [{k: e[k] for k in keys + [x for x in extra if x in e]}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
