#!/usr/bin/env bash
# Per-category MID-FC feature extraction with the port (the port's form of
# scripts/extract_features_all.sh, the launcher analogue of
# `MID-FC/ocnn_extraction/run_seg_partnet_test_cmd.py`, which emitted one
# SLURM job per category over finetuned checkpoints): trains the sparse
# HRNetSeg extractor per category and dumps fc_1 features for the
# SSA -> kNN -> CSA pipeline (csn_tpu_torch/midfc/run_training.py).
#
# Usage:
#   DATAPATH=/data/partnet OUT=outputs/midfc_features \
#       bash csn_tpu_torch/scripts/extract_features_all.sh
# Env overrides: MODEL (HRNetSeg3S), MAX_EPOCH (200), BATCH_SIZE (8),
# D_MODEL (256), DEVICE (cuda; cpu runs on the CPU), WEIGHTS_DIR (load
# per-category checkpoints instead of training: expects $WEIGHTS_DIR/$CAT/
# as a --resume dir). One card: `tasks.extract_features` trains and writes
# on one device, so this script is not run under torchrun (every rank would
# write the same files).
set -eo pipefail

DATAPATH=${DATAPATH:?set DATAPATH to the PartNet root}
OUT=${OUT:-outputs/midfc_features}
MODEL=${MODEL:-HRNetSeg3S}
MAX_EPOCH=${MAX_EPOCH:-200}
BATCH_SIZE=${BATCH_SIZE:-8}
D_MODEL=${D_MODEL:-256}
LOG_ROOT=${LOG_ROOT:-outputs/extract}
DEVICE=${DEVICE:-cuda}

source "$(dirname "$0")/partnet_categories.sh"

for CAT in "${CATEGORIES[@]}"; do
  echo "=== extracting ${CAT} -> ${OUT}/{train,test}/${CAT}"
  ARGS=(--partnet_path "$DATAPATH" --partnet_category "$CAT"
        --model "$MODEL" --d_model "$D_MODEL" --batch_size "$BATCH_SIZE"
        --save_pred_dir "$OUT" --log_dir "$LOG_ROOT/$CAT"
        --distort_partnet True --device "$DEVICE")
  if [ -n "$WEIGHTS_DIR" ]; then
    ARGS+=(--is_train False --resume "$WEIGHTS_DIR/$CAT")
  else
    ARGS+=(--is_train True --max_epoch "$MAX_EPOCH")
  fi
  python -m csn_tpu_torch.tasks.extract_features "${ARGS[@]}"
done
