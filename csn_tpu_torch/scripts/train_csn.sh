#!/usr/bin/env bash
# Train the port's CSN model on one PartNet category (the port's form of
# `MinkowskiNet/scripts/train_csn.sh`): env-overridable defaults, log dir
# naming, git-diff logging, then the trainer `csn_tpu_torch.tasks.main_csn`.
#
#   bash csn_tpu_torch/scripts/train_csn.sh <Category> [K] [extra flags...]
#
# DEVICE (default cuda) goes to --device; DEVICE=cpu runs the plain
# versions of the kernels on the CPU. Extra flags follow the script's own
# and win over them. On N cards of one host, run the same command under
# torchrun, one process per card: `torchrun --nproc_per_node N -m
# csn_tpu_torch.tasks.main_csn --data_parallel N <the flags below>`.
set -eo pipefail

export PARTNET_CATEGORY=$1
export K_NEIGHBORS=${2:-1}
export TIME=$(date +"%Y-%m-%d_%H-%M-%S")

export DATAPATH=${DATAPATH:-"./data/partnet"}
export MODEL=${MODEL:-HRNetSimCSN3S}
export DATASET=${DATASET:-PartnetVoxelization0_05Dataset}
export OPTIMIZER=${OPTIMIZER:-SGD}
export LR=${LR:-0.05}
export SCHEDULER=${SCHEDULER:-ReduceLROnPlateau}
export BATCH_SIZE=${BATCH_SIZE:-8}
export ITER_SIZE=${ITER_SIZE:-1}
export MAX_EPOCH=${MAX_EPOCH:-200}
export STAT_FREQ=${STAT_FREQ:-40}
export INPUT_FEAT=${INPUT_FEAT:-xyz}
export DEVICE=${DEVICE:-cuda}
export LOG_DIR=${LOG_DIR:-outputs/${DATASET}/${PARTNET_CATEGORY}/${MODEL}-K${K_NEIGHBORS}/b${BATCH_SIZE}-i${ITER_SIZE}-${OPTIMIZER}-lr${LR}-e${MAX_EPOCH}-${SCHEDULER}/${TIME}}

mkdir -p "$LOG_DIR"
LOG="$LOG_DIR/$TIME.txt"
git diff > "$LOG_DIR/git_diff.txt" 2>/dev/null || true
git rev-parse HEAD > "$LOG_DIR/git_commit.txt" 2>/dev/null || true

python -m csn_tpu_torch.tasks.main_csn \
  --model "$MODEL" \
  --dataset "$DATASET" \
  --partnet_path "$DATAPATH" \
  --partnet_category "$PARTNET_CATEGORY" \
  --k_neighbors "$K_NEIGHBORS" \
  --optimizer "$OPTIMIZER" \
  --lr "$LR" \
  --scheduler "$SCHEDULER" \
  --batch_size "$BATCH_SIZE" \
  --iter_size "$ITER_SIZE" \
  --max_epoch "$MAX_EPOCH" \
  --stat_freq "$STAT_FREQ" \
  --input_feat "$INPUT_FEAT" \
  --normalize_coords True \
  --distort_partnet True \
  --device "$DEVICE" \
  --log_dir "$LOG_DIR" \
  "${@:3}" 2>&1 | tee -a "$LOG"
