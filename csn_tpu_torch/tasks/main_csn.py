"""CSN entry point (counterpart of `csn_tpu/tasks/main_csn.py`, port of
`MinkowskiNet/tasks/main_csn.py`).

Train:  python -m csn_tpu_torch.tasks.main_csn --is_train True \
            --partnet_path ... --partnet_category Chair \
            --model HRNetSimCSN3S --k_neighbors 1
Eval:   python -m csn_tpu_torch.tasks.main_csn --is_train False \
            --resume <log_dir>

Runs on the first CUDA device; `--device cpu` runs the plain versions of the
kernels on the CPU. `CSN_DYNG=2` (or 3) in the environment selects the
im2col sparse-conv kernels (core/window_conv.py).

Data-parallel over N ranks, one process per rank (NCCL, one card each; or
gloo with `--device cpu`):
        torchrun --nproc_per_node N -m csn_tpu_torch.tasks.main_csn \
            --data_parallel N [--collection_parallel True] ...
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch.distributed as dist

from csn_tpu_torch.config import Config, get_config
from csn_tpu_torch.data.partnet import NUM_SEG, make_partnet_dataset
from csn_tpu_torch.data.pipeline import pyramid_spec_for_model
from csn_tpu_torch.models import load_model
from csn_tpu_torch.parallel.collectives import join_world
from csn_tpu_torch.train.trainer import CSNTrainer
from csn_tpu_torch.utils.logging import setup_logging


def build_model_and_spec(config: Config, num_labels: int, **model_kw):
    """The model `config` names, with its BatchNorm momentum set, and the
    pyramid signature of its batches."""
    model_cls = load_model(config.model)
    if "HRNet" in config.model:  # fc_1 head width (256 in the reference)
        model_kw["d_model"] = config.d_model
    model = model_cls(
        out_channels=num_labels,
        conv1_kernel_size=config.conv1_kernel_size,
        compute_dtype=config.resolved_compute_dtype(), **model_kw)
    model.set_bn_momentum(config.bn_momentum)
    spec = pyramid_spec_for_model(
        model_cls, num_points=config.num_points,
        voxel_size=config.voxel_size(),
        conv1_kernel_size=config.conv1_kernel_size,
        level0_cap=config.level0_cap or None,
        qmode=config.qmode(), shrink=config.level_shrink)
    return model, spec


def make_datasets(config: Config, phases):
    """The (train, val) datasets of `phases`; only the first is distorted."""
    train_ds = make_partnet_dataset(
        config.partnet_path, config.partnet_category, phases[0],
        distort=config.distort_partnet, normalize=config.normalize_coords,
        normalize_method=config.normalize_method)
    val_ds = make_partnet_dataset(
        config.partnet_path, config.partnet_category, phases[1],
        normalize=config.normalize_coords,
        normalize_method=config.normalize_method)
    return train_ds, val_ds


def build_trainer(config: Config, phases=None, datasets=None) -> CSNTrainer:
    """`datasets`: a (train, val) pair with the PartNet dataset's interface
    (`get`, `__len__`, `coords`, `neighbors`) to use in place of the h5
    files under `config.partnet_path`."""
    # default: the reference's --train_phase/--val_phase flags
    # (`lib/config.py`), so e.g. --val_phase test validates on the test
    # split; callers may still pass explicit phases.
    if phases is None:
        phases = (config.train_phase, config.val_phase)
    num_labels = NUM_SEG[config.partnet_category.split("-")[0]]
    model, spec = build_model_and_spec(
        config, num_labels, n_head=config.n_head,
        k_neighbors=config.k_neighbors)
    train_ds, val_ds = datasets or make_datasets(config, phases)
    return CSNTrainer(model, config, spec, train_ds, val_ds, num_labels)


def run_eval(trainer, config: Config):
    """The eval CLI's path: initialize, resume, (CSN) retrieve the test
    shapes' neighbors from the train collection, `test_on`."""
    trainer.initialize()
    if config.resume:
        trainer.resume()
    test_ds = make_partnet_dataset(
        config.partnet_path, config.partnet_category, config.test_phase,
        normalize=config.normalize_coords,
        normalize_method=config.normalize_method)
    if config.k_neighbors > 0 and hasattr(trainer, "construct_test_graph"):
        trainer.construct_test_graph(test_ds)
    res = trainer.test_on(test_ds, save_pred_dir=config.save_pred_dir)
    logging.info("Test: loss %.4f score %.3f PartIoU %.2f ShapeIoU %.2f",
                 *res)
    return res


@contextlib.contextmanager
def rank_process(config: Config):
    """With `--data_parallel N` (or under torchrun), join the world the
    environment describes, this rank on `cuda:LOCAL_RANK` or the CPU, and
    leave it at the end; rank 0 alone logs below WARNING."""
    joined = config.data_parallel > 1 or "WORLD_SIZE" in os.environ
    if joined:
        config.device = join_world(config.device)
    setup_logging("INFO" if not joined or dist.get_rank() == 0
                  else "WARNING")
    try:
        yield config
    finally:
        if joined:
            dist.destroy_process_group()


def main(argv=None):
    with rank_process(get_config(argv)) as config:
        logging.info("===> Configurations: %s", config)
        if config.is_train:
            trainer = build_trainer(config)
            return trainer.train()
        trainer = build_trainer(config, phases=("train", "val"))
        return run_eval(trainer, config)


if __name__ == "__main__":
    main()
