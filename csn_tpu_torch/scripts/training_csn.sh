#!/usr/bin/env bash
# Train the port's CSN model on all 17 PartNet categories (the port's form
# of `MinkowskiNet/scripts/training_csn.sh`): derive each category's
# STAT_FREQ from its training-set size and run train_csn.sh for it.
#
#   bash csn_tpu_torch/scripts/training_csn.sh [K]
#
# DEVICE, DATAPATH, MODEL, BATCH_SIZE, ... as in train_csn.sh. On N cards,
# run train_csn.sh's command under torchrun per category (see its header).
set -eo pipefail

K_NEIGHBORS=${1:-1}

source "$(dirname "$0")/partnet_categories.sh"
BATCH_SIZE=${BATCH_SIZE:-8}

for i in "${!CATEGORIES[@]}"; do
  CAT=${CATEGORIES[$i]}
  N=${TRAIN_COUNTS[$i]}
  # print ~4 times per epoch
  STAT_FREQ=$(( (N / BATCH_SIZE) / 4 ))
  if [ "$STAT_FREQ" -lt 1 ]; then STAT_FREQ=1; fi
  echo "=== ${CAT}: n_train=${N} stat_freq=${STAT_FREQ} K=${K_NEIGHBORS}"
  STAT_FREQ=$STAT_FREQ bash "$(dirname "$0")/train_csn.sh" "$CAT" "$K_NEIGHBORS"
done
