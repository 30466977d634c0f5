"""Plain segmentation entry point (counterpart of
`csn_tpu/tasks/main_seg.py`, port of `MinkowskiNet/tasks/main_seg.py`).

Train:  python -m csn_tpu_torch.tasks.main_seg --is_train True \
            --partnet_path ... --partnet_category Chair --model HRNetSeg3S
        (or any Res16UNet* / ResUNet* model, e.g. --model Res16UNet34C)
Eval:   python -m csn_tpu_torch.tasks.main_seg --is_train False \
            --resume <log_dir>

Runs on the first CUDA device; `--device cpu` runs the plain versions of the
kernels on the CPU.
"""

from __future__ import annotations

import logging

from csn_tpu_torch.config import Config, get_config
from csn_tpu_torch.data.partnet import NUM_SEG
from csn_tpu_torch.models import load_model
from csn_tpu_torch.models.hrnet import HRNetSimCSN
from csn_tpu_torch.tasks.main_csn import (
    build_model_and_spec, make_datasets, run_eval,
)
from csn_tpu_torch.train.trainer import SegTrainer
from csn_tpu_torch.utils.logging import setup_logging


def build_trainer(config: Config, phases=None, datasets=None) -> SegTrainer:
    if phases is None:
        phases = (config.train_phase, config.val_phase)
    num_labels = NUM_SEG[config.partnet_category.split("-")[0]]
    model_cls = load_model(config.model)
    out_level = getattr(model_cls, "output_level", None)
    if out_level is not None and out_level() != 0:
        raise ValueError(
            f"{config.model} outputs voxel logits at level "
            f"{model_cls.output_level()}, but the segmentation readout "
            f"(trilinear voxel->point interpolation) requires a level-0 "
            f"output. The reference never registers this family for seg "
            f"either (`MinkowskiNet/models/__init__.py` omits "
            f"`add_models(resnet)`); use ResUNet*/Res16UNet*/HRNet*.")
    if issubclass(model_cls, HRNetSimCSN):
        raise ValueError(
            f"{config.model} is no plain segmentation model (the CSN models "
            f"run under main_csn)")
    model, spec = build_model_and_spec(config, num_labels)
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
