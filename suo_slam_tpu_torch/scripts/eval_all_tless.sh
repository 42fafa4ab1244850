#!/bin/bash
# Reproduce-paper sweep for T-LESS on the PyTorch port: the runs of the JAX
# package's scripts/eval_all_tless.sh (single-view, SLAM and the ablations,
# with VSD scoring) through `python -m suo_slam_tpu_torch.evaluate`, then
# the summary.txt and vsd_summary.txt files gathered into table_tless.txt
# beside the checkpoint.
#
#   suo_slam_tpu_torch/scripts/eval_all_tless.sh <checkpoint> [evaluate args...]
#
# Arguments after the checkpoint go to every run unchanged (e.g.
# `--data_root <root> --device cpu`).
set -e

REPO_DIR=$(cd "$(dirname "$0")/../.." && pwd)
CKPT=${1:-results/latest/model_best}
EXTRA=${@:2}
export PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}"

run() {
    echo "=============================================================="
    echo "RUN: $@"
    python -m suo_slam_tpu_torch.evaluate --dataset tless -c "$CKPT" $@ $EXTRA
}

run --nviews 1
run --nviews -1
run --nviews -1 --no_prior_det
run --nviews -1 --no_network_cov

OUT_DIR=$(dirname "$CKPT")
TABLE="$OUT_DIR/table_tless.txt"
rm -f "$TABLE"
for summ in "$OUT_DIR"/pkpnet-*tless*/summary.txt "$OUT_DIR"/pkpnet-*tless*/vsd_summary.txt; do
    [ -f "$summ" ] || continue
    echo "==== $summ ====" >> "$TABLE"
    cat "$summ" >> "$TABLE"
    echo "" >> "$TABLE"
done
echo "Wrote $TABLE"
