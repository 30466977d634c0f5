#!/usr/bin/env bash
# Train the port's HRNetSeg model on all 17 PartNet categories (the port's
# form of `MinkowskiNet/scripts/training_hrnet.sh`), train_hrnet.sh for
# each; DEVICE, DATAPATH, MODEL, ... as there. On N cards, run
# train_hrnet.sh's command under torchrun per category (see its header).
set -eo pipefail
source "$(dirname "$0")/partnet_categories.sh"
for CAT in "${CATEGORIES[@]}"; do
  bash "$(dirname "$0")/train_hrnet.sh" "$CAT"
done
