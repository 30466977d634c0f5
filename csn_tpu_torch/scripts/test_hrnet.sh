#!/usr/bin/env bash
# Evaluate one trained HRNetSeg run of the port (the port's form of
# `MinkowskiNet/scripts/test_hrnet.sh`).
#
#   bash csn_tpu_torch/scripts/test_hrnet.sh <Category> <log_dir> [extra flags...]
#
# DEVICE (default cuda) goes to --device (DEVICE=cpu: the CPU). On N cards:
# `torchrun --nproc_per_node N -m csn_tpu_torch.tasks.main_seg
# --data_parallel N <the flags below>`.
set -eo pipefail
PARTNET_CATEGORY=$1
LOG_DIR=$2
DATAPATH=${DATAPATH:-"./data/partnet"}
DEVICE=${DEVICE:-cuda}
python -m csn_tpu_torch.tasks.main_seg \
  --is_train False \
  --resume "$LOG_DIR" \
  --partnet_path "$DATAPATH" \
  --partnet_category "$PARTNET_CATEGORY" \
  --save_pred_dir "${SAVE_PRED_DIR:-$LOG_DIR/results}" \
  --device "$DEVICE" \
  "${@:3}"
