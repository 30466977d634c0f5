#!/usr/bin/env bash
# Evaluate one trained CSN run of the port (the port's form of
# `MinkowskiNet/scripts/test_csn.sh`): resume the run's checkpoint and
# config, build the test split's shape graph against the train set, write
# the predictions and results_log.txt.
#
#   bash csn_tpu_torch/scripts/test_csn.sh <Category> <log_dir> [K] [extra flags...]
#
# DEVICE (default cuda) goes to --device (DEVICE=cpu: the CPU). On N cards,
# the same command under `torchrun --nproc_per_node N -m
# csn_tpu_torch.tasks.main_csn --data_parallel N ...` (rank 0 writes).
set -eo pipefail

PARTNET_CATEGORY=$1
LOG_DIR=$2          # directory holding weights.pt + config.json
K_NEIGHBORS=${3:-1}
DATAPATH=${DATAPATH:-"./data/partnet"}
SAVE_PRED_DIR=${SAVE_PRED_DIR:-"$LOG_DIR/results"}
DEVICE=${DEVICE:-cuda}

python -m csn_tpu_torch.tasks.main_csn \
  --is_train False \
  --resume "$LOG_DIR" \
  --partnet_path "$DATAPATH" \
  --partnet_category "$PARTNET_CATEGORY" \
  --k_neighbors "$K_NEIGHBORS" \
  --save_pred_dir "$SAVE_PRED_DIR" \
  --device "$DEVICE" \
  "${@:4}"
