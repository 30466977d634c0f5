#!/usr/bin/env bash
# Train the port's plain HRNetSeg model on one PartNet category (the port's
# form of `MinkowskiNet/scripts/train_hrnet.sh`): the trainer
# `csn_tpu_torch.tasks.main_seg`.
#
#   bash csn_tpu_torch/scripts/train_hrnet.sh <Category> [extra flags...]
#
# DEVICE (default cuda) goes to --device (DEVICE=cpu: the CPU). On N cards
# of one host: `torchrun --nproc_per_node N -m csn_tpu_torch.tasks.main_seg
# --data_parallel N <the flags below>`.
set -eo pipefail

export PARTNET_CATEGORY=$1
export TIME=$(date +"%Y-%m-%d_%H-%M-%S")
export DATAPATH=${DATAPATH:-"./data/partnet"}
export MODEL=${MODEL:-HRNetSeg3S}
export DATASET=${DATASET:-PartnetVoxelization0_05Dataset}
export OPTIMIZER=${OPTIMIZER:-SGD}
export LR=${LR:-0.05}
export SCHEDULER=${SCHEDULER:-ReduceLROnPlateau}
export BATCH_SIZE=${BATCH_SIZE:-8}
export MAX_EPOCH=${MAX_EPOCH:-200}
export DEVICE=${DEVICE:-cuda}
export LOG_DIR=${LOG_DIR:-outputs/${DATASET}/${PARTNET_CATEGORY}/${MODEL}/b${BATCH_SIZE}-${OPTIMIZER}-lr${LR}-e${MAX_EPOCH}-${SCHEDULER}/${TIME}}

mkdir -p "$LOG_DIR"
python -m csn_tpu_torch.tasks.main_seg \
  --model "$MODEL" \
  --dataset "$DATASET" \
  --partnet_path "$DATAPATH" \
  --partnet_category "$PARTNET_CATEGORY" \
  --k_neighbors 0 \
  --optimizer "$OPTIMIZER" \
  --lr "$LR" \
  --scheduler "$SCHEDULER" \
  --batch_size "$BATCH_SIZE" \
  --max_epoch "$MAX_EPOCH" \
  --normalize_coords True \
  --distort_partnet True \
  --device "$DEVICE" \
  --log_dir "$LOG_DIR" \
  "${@:2}" 2>&1 | tee -a "$LOG_DIR/$TIME.txt"
