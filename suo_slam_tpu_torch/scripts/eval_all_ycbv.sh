#!/bin/bash
# Reproduce-paper sweep for YCB-Video on the PyTorch port: the runs of the
# JAX package's scripts/eval_all_ycbv.sh (single-view, SLAM, and the
# ablations: no prior, no covariance, ground-truth camera pose) through
# `python -m suo_slam_tpu_torch.evaluate`, then the per-method summary.txt
# files gathered into table.txt beside the checkpoint.
#
#   suo_slam_tpu_torch/scripts/eval_all_ycbv.sh <checkpoint> [evaluate args...]
#
# Arguments after the checkpoint go to every run unchanged (e.g.
# `--data_root <root> --device cpu`). Visualization is on, as in the JAX
# sweep: each run writes viz_images/ (`--no_viz` turns it off).
set -e

REPO_DIR=$(cd "$(dirname "$0")/../.." && pwd)
CKPT=${1:-results/latest/model_best}
EXTRA=${@:2}
export PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}"

run() {
    echo "=============================================================="
    echo "RUN: $@"
    python -m suo_slam_tpu_torch.evaluate --dataset ycbv -c "$CKPT" $@ $EXTRA
}

# single view
run --nviews 1
# full SLAM
run --nviews -1
# ablations
run --nviews -1 --no_prior_det
run --nviews -1 --no_network_cov
run --nviews -1 --gt_cam_pose

# aggregate
OUT_DIR=$(dirname "$CKPT")
TABLE="$OUT_DIR/table.txt"
rm -f "$TABLE"
for summ in "$OUT_DIR"/pkpnet-*ycbv*/summary.txt; do
    echo "==== $summ ====" >> "$TABLE"
    cat "$summ" >> "$TABLE"
    echo "" >> "$TABLE"
done
echo "Wrote $TABLE"
