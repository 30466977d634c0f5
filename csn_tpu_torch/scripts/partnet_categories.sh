# The 17 PartNet categories with level-3 annotations, shared by the port's
# training, testing and extraction loop scripts (source this file; do not
# copy the lists). The table they mirror is the port's own,
# `csn_tpu_torch/data/partnet.py` (CATEGORIES, TRAIN_COUNTS);
# tests/test_torch_scripts.py holds the two equal. TRAIN_COUNTS stays
# index-aligned with CATEGORIES (training_csn.sh derives STAT_FREQ from it).
CATEGORIES=(Bed Bottle Chair Clock Dishwasher Display Door Earphone Faucet \
            Knife Lamp Microwave Refrigerator StorageFurniture Table \
            TrashCan Vase)
TRAIN_COUNTS=(133 315 4489 406 111 633 149 147 435 221 1554 133 136 1588 \
              5707 221 741)
