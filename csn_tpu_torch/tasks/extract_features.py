"""MID-FC feature-extraction entry point.

Counterpart of `csn_tpu/tasks/extract_features.py` (the analogue of the
reference's O-CNN extraction launcher and solver, `MID-FC/ocnn_extraction/
run_seg_partnet.py`, `run_seg_partnet_test_cmd.py`, `tfsolver.py:206-268`):
trains the sparse HRNetSeg extractor on a PartNet category (ordinary
segmentation objective) and dumps per-point `fc_1` features for every split
in the MID-FC on-disk format, ready for the SSA -> kNN -> CSA pipeline
(`python -m csn_tpu_torch.midfc.run_training`).

Train + extract:
    python -m csn_tpu_torch.tasks.extract_features --partnet_path <root> \
        --partnet_category Chair --model HRNetSeg3S --max_epoch 50 \
        --save_pred_dir outputs/midfc_features

Extract from an existing checkpoint (no training):
    python -m csn_tpu_torch.tasks.extract_features --is_train False \
        --resume <log_dir> --partnet_path <root> --partnet_category Chair

Runs on the first CUDA device; `--device cpu` runs the plain versions of the
kernels on the CPU.
"""

from __future__ import annotations

import logging
import os.path as osp

from csn_tpu_torch.config import get_config
from csn_tpu_torch.data.partnet import make_partnet_dataset
from csn_tpu_torch.midfc.extraction import extract_split
from csn_tpu_torch.models.hrnet import HRNetSeg
from csn_tpu_torch.tasks.main_seg import build_trainer
from csn_tpu_torch.utils.logging import setup_logging

EXTRACT_SPLITS = ("train", "test")


def main(argv=None):
    config = get_config(argv)
    setup_logging()
    logging.info("===> Configurations: %s", config)

    trainer = build_trainer(config)
    if not isinstance(trainer.model, HRNetSeg):
        raise ValueError(
            f"feature extraction needs an HRNetSeg-family model exposing "
            f"fc_1, got {config.model}")
    if config.is_train:
        trainer.train()
    else:
        trainer.initialize()
        if config.resume:
            trainer.resume()

    counts = {}
    for split in EXTRACT_SPLITS:
        ds = make_partnet_dataset(
            config.partnet_path, config.partnet_category, split,
            normalize=config.normalize_coords,
            normalize_method=config.normalize_method)
        out_root = osp.join(config.save_pred_dir, split,
                            config.partnet_category)
        n = extract_split(trainer.model, ds, trainer.spec, out_root,
                          batch_size=max(config.test_batch_size, 1))
        counts[split] = n
        logging.info("===> extracted %d shapes -> %s", n, out_root)
    return counts


if __name__ == "__main__":
    main()
