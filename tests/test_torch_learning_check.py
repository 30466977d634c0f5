"""Port: the learning check (`csn_tpu_torch.tasks.learning_check`) and the
in-memory synthetic PartNet category it trains on
(`csn_tpu_torch.data.synthetic`).

* the in-memory splits against what the JAX package's
  `write_synthetic_partnet` writes and its `PartnetDataset` reads back:
  bit for bit (points, labels, normalized coordinates);
* the configurations against the JAX script's (`scripts/learning_check.py`,
  its flags' defaults and its `Config` / `MidfcConfig` arguments): equal
  field by field, but for the paths and the port's `device`;
* each task at `--device cpu` and tiny sizes runs to its end and prints the
  script's `RESULT` line (the loss need not fall in so few steps).
"""

import dataclasses
import math

import h5py
import numpy as np
import pytest
import torch

from csn_tpu.config import Config as JConfig
from csn_tpu.data.partnet import PartnetDataset as JPartnetDataset
from csn_tpu.data.partnet import write_synthetic_partnet
from csn_tpu.midfc.training import MidfcConfig as JMidfcConfig
from csn_tpu_torch.data.synthetic import (
    synthetic_partnet_arrays, synthetic_partnet_splits,
)
from csn_tpu_torch.tasks import learning_check

torch.set_num_threads(1)


@pytest.mark.parametrize("category,n,points,seed", [
    ("Display", (4, 2, 2), 128, 0), ("Chair", (3, 1, 2), 64, 5)])
def test_synthetic_splits_equal_the_jax_h5_files(tmp_path, category, n,
                                                 points, seed):
    write_synthetic_partnet(str(tmp_path), category, *n, num_points=points,
                            seed=seed)
    arrays = synthetic_partnet_arrays(category, *n, num_points=points,
                                      seed=seed)
    splits = synthetic_partnet_splits(category, *n, num_points=points,
                                      seed=seed)
    for phase in ("train", "val", "test"):
        with h5py.File(tmp_path / category / f"{phase}-00.h5", "r") as f:
            data, labs = f["data"][:], f["label_seg"][:]
        np.testing.assert_array_equal(arrays[phase][0], data)
        np.testing.assert_array_equal(arrays[phase][1], labs)
        assert arrays[phase][0].dtype == data.dtype
        ref = JPartnetDataset(str(tmp_path), category, phase)
        got = splits[phase]
        assert len(got) == len(ref) and got.num_labels == ref.num_labels
        assert got.neighbors == ref.neighbors
        for i in range(len(ref)):
            for a, b in zip(got.get(i), ref.get(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _jax_trainer_config(task, tmp):
    """The JAX script's `Config` (`scripts/learning_check.py:62-71`) at its
    flags' defaults."""
    model, k = ("HRNetSeg2S", 0) if task == "seg" else ("HRNetSimCSN2S", 1)
    return JConfig(
        model=model, partnet_path=tmp,
        partnet_category="Display", batch_size=4, val_batch_size=4,
        test_batch_size=4, k_neighbors=k, conv1_kernel_size=5,
        d_model=64, n_head=2, max_epoch=40, stat_freq=1000,
        num_points=2048, level_shrink=2.0, seed=0,
        compute_dtype="auto", use_flash="auto",
        use_windows="auto", log_dir=tmp + "/logs",
    ).normalized()


@pytest.mark.parametrize("task", ["csn", "seg"])
def test_trainer_configs_equal_the_jax_scripts(task):
    args = learning_check.build_parser().parse_args(["--task", task])
    assert (args.epochs, args.dtype, args.use_flash, args.use_windows,
            args.num_points, args.shapes, args.steps, args.device) == (
        40, "auto", "auto", "auto", 2048, 16, 150, "cuda")
    got = dataclasses.asdict(learning_check.trainer_config(args, "/x/logs"))
    ref = dataclasses.asdict(_jax_trainer_config(task, "/x"))
    for name in ("partnet_path", "log_dir"):
        got.pop(name), ref.pop(name)
    assert got.pop("device") == "cuda"
    assert got == ref


@pytest.mark.parametrize("dtype", ["auto", "bfloat16"])
def test_midfc_config_equals_the_jax_scripts(dtype):
    args = learning_check.build_parser().parse_args(
        ["--task", "midfc", "--dtype", dtype])
    dt = JMidfcConfig.compute_dtype if dtype == "auto" else dtype
    ref = JMidfcConfig(num_classes=15, n_heads=8, K=4, batch_size=4,
                       num_points=10000, seed=0, compute_dtype=dt)
    got = dataclasses.asdict(learning_check.midfc_config(args))
    ref = {k: v for k, v in dataclasses.asdict(ref).items() if k in got}
    assert got == ref and got["compute_dtype"] == dt
    assert learning_check.MIDFC_SHAPE == (4, 10000, 256, 4)


@pytest.mark.parametrize("task", ["csn", "seg", "midfc"])
def test_learning_check_runs_to_its_end_on_cpu(task, monkeypatch, capsys):
    monkeypatch.setattr(learning_check, "MIDFC_SHAPE", (2, 1000, 32, 2))
    args = learning_check.build_parser().parse_args(
        ["--task", task, "--device", "cpu", "--epochs", "2",
         "--num_points", "256", "--shapes", "4", "--steps", "3"])
    seen = []
    res = learning_check.run(args, inspect=seen.append)
    assert res["task"] == task and len(seen) == 1
    assert math.isfinite(res["first"]) and math.isfinite(res["last"])
    assert res["passed"] == (res["last"] < 0.8 * res["first"])
    out = capsys.readouterr().out
    assert (f"RESULT task={task} dtype={res['dtype']} first_loss="
            f"{res['first']:.4f} last_loss={res['last']:.4f}") in out
