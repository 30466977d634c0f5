"""Plain segmentation entry point (counterpart of
`csn_tpu/tasks/main_seg.py`, port of `MinkowskiNet/tasks/main_seg.py`).

Train:  python -m csn_tpu_torch.tasks.main_seg --is_train True \
            --partnet_path ... --partnet_category Chair --model HRNetSeg3S
Eval:   python -m csn_tpu_torch.tasks.main_seg --is_train False \
            --resume <log_dir>

Runs on the first CUDA device; `--device cpu` runs the plain versions of the
kernels on the CPU.
"""

from __future__ import annotations

import logging

from csn_tpu_torch.config import Config, get_config
from csn_tpu_torch.data.partnet import NUM_SEG
from csn_tpu_torch.models.hrnet import HRNetSeg
from csn_tpu_torch.tasks.main_csn import (
    build_model_and_spec, make_datasets, run_eval,
)
from csn_tpu_torch.train.trainer import SegTrainer
from csn_tpu_torch.utils.logging import setup_logging


def build_trainer(config: Config, phases=None, datasets=None) -> SegTrainer:
    if phases is None:
        phases = (config.train_phase, config.val_phase)
    num_labels = NUM_SEG[config.partnet_category.split("-")[0]]
    model, spec = build_model_and_spec(config, num_labels)
    if not isinstance(model, HRNetSeg):
        raise ValueError(
            f"{config.model} is no plain segmentation model; main_seg takes "
            f"HRNetSeg2S/3S/4S (the CSN models run under main_csn)")
    train_ds, val_ds = datasets or make_datasets(config, phases)
    return SegTrainer(model, config, spec, train_ds, val_ds, num_labels)


def main(argv=None):
    config = get_config(argv)
    setup_logging()
    logging.info("===> Configurations: %s", config)
    trainer = build_trainer(config)
    if config.is_train:
        return trainer.train()
    return run_eval(trainer, config)


if __name__ == "__main__":
    main()
