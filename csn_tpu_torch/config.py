"""Configuration: one dataclass tree with CLI overrides and resume-reload.

The port's own copy of `csn_tpu/config.py`, every field kept, so that a
`config.json` written by either package loads in the other (`from_dict`
drops keys it does not know). Flag-for-flag port of the reference's argparse
groups (`MinkowskiNet/lib/config.py:40-170`) plus the static-shape knobs.
`--distort_partnet` expands to rot+jitter+scale exactly as `get_config()`
does (`config.py:147-152`); the ME quantization enums map to `qmode`
(`--avg_feat`).

What differs from the JAX package: one new field, `device` ('cuda' | 'cpu');
'auto' for `use_flash` and `compute_dtype` resolves from that device (a CUDA
device: the kernels and bfloat16; the CPU: the plain versions and float32);
`use_windows` selects nothing here (the CUDA conv kernels read the kernel
maps directly) and is only carried through; `data_parallel` counts the
ranks of a `torch.distributed` world (one process per rank), which
`check_supported` holds to the world that is initialised.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from csn_tpu_torch.core.pyramid import QMode
from csn_tpu_torch.parallel.collectives import world_size


@dataclasses.dataclass
class Config:
    # Network (`config.py:44-49`)
    model: str = "HRNetSimCSN3S"
    conv1_kernel_size: int = 5
    weights: str = "None"
    n_head: int = 4
    d_model: int = 256

    # Optimizer (`config.py:52-63`)
    optimizer: str = "SGD"
    lr: float = 1e-2
    sgd_momentum: float = 0.9
    sgd_dampening: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    weight_decay: float = 1e-4
    param_histogram_freq: int = 5
    save_param_histogram: bool = False
    iter_size: int = 1
    bn_momentum: float = 0.02

    # Scheduler (`config.py:66-73`)
    scheduler: str = "StepLR"
    max_iter: int = 60000
    max_epoch: int = 200
    step_size: int = 10000
    step_gamma: float = 0.5
    poly_power: float = 0.9
    exp_gamma: float = 0.99
    exp_step_size: int = 445

    # Directories (`config.py:77`)
    log_dir: str = "outputs/default"

    # Data (`config.py:80-97`)
    dataset: str = "PartnetVoxelization0_05Dataset"
    batch_size: int = 16
    val_batch_size: int = 1
    test_batch_size: int = 1
    ignore_label: int = 255
    train_limit_numpoints: int = 0
    k_neighbors: int = 1
    partnet_path: str = ""
    partnet_category: str = ""

    # Training / test (`config.py:100-115`)
    is_train: bool = True
    stat_freq: int = 40
    test_stat_freq: int = 100
    train_phase: str = "train"
    val_phase: str = "val"
    overwrite_weights: bool = True
    resume: Optional[str] = None
    resume_optimizer: bool = True
    input_feat: str = "xyz"
    normalize_coords: bool = True
    normalize_method: str = "sphere"

    # Data augmentation (`config.py:118-126`)
    shift: bool = False
    jitter: bool = False
    scale: bool = False
    rot_aug: bool = False
    random_rotation: bool = False
    distort_partnet: bool = False

    # Test (`config.py:129-131`)
    test_phase: str = "test"
    save_pred_dir: str = "outputs/pred"

    # Misc (`config.py:134-142`)
    seed: int = 123
    avg_feat: bool = False

    # --- static-shape settings (no reference analogue) ---
    num_points: int = 10000          # per-shape point capacity
    level0_cap: int = 0              # voxel capacity at stride 1 (0 = auto)
    level_shrink: float = 3.0        # capacity decay per level
    use_flash: str = "auto"          # flash attention kernels for SSA/CSA:
                                     # 'auto' = on for a CUDA device, the
                                     # plain version on the CPU
    use_windows: str = "auto"        # carried through for config.json
                                     # compatibility; selects nothing here
    compute_dtype: str = "auto"      # activation dtype: 'float32' |
                                     # 'bfloat16' | 'auto' (= bf16 on a
                                     # CUDA device, f32 on the CPU);
                                     # parameters, optimizer state, BN
                                     # statistics and loss stay f32
    data_parallel: int = 1           # ranks of the torch.distributed
                                     # world (parallel/dp.py); one per
                                     # process, = the world's size
    collection_parallel: bool = False  # the train step on a ('data',
                                     # 'col') grid of those ranks, one
                                     # [self]+K member per rank
                                     # (parallel/cp.py); requires
                                     # (k_neighbors+1) | data_parallel
    cached_eval: bool = False        # CSN eval: precompute per-key backbone
                                     # features once over the train collection
                                     # (HRNetSimCSN.cache_features) and feed
                                     # csa_from_cache, instead of re-forwarding
                                     # K neighbor backbones per query batch
                                     # (the reference re-forwards every
                                     # neighbor, `lib/trainer_csn.py:442-454`)
    device: str = "cuda"             # 'cuda' | 'cuda:N' | 'cpu'

    def voxel_size(self) -> float:
        """Derived from the dataset name (PartnetVoxelization0_05Dataset...)"""
        name = self.dataset
        if "Voxelization" in name:
            tag = name.split("Voxelization")[1].replace("Dataset", "")
            return float(tag.replace("_", "."))
        return 0.05

    def qmode(self) -> QMode:
        return QMode.UNWEIGHTED_AVERAGE if self.avg_feat else \
            QMode.RANDOM_SUBSAMPLE

    def on_card(self) -> bool:
        return str(self.device).lower().startswith("cuda")

    def _resolve_kernel_flag(self, v) -> bool:
        v = str(v).lower()
        if v in ("true", "1"):
            return True
        if v in ("false", "0"):
            return False
        return self.on_card()   # 'auto': the kernels run on the card only

    def resolved_use_flash(self) -> bool:
        """The flash attention kernels on a CUDA device, the plain
        attention on the CPU."""
        return self._resolve_kernel_flag(self.use_flash)

    def resolved_use_windows(self) -> bool:
        """Carried through; the conv kernels are chosen by the tensors'
        device and `CSN_DYNG`."""
        return self._resolve_kernel_flag(self.use_windows)

    def resolved_compute_dtype(self) -> str:
        """Activation dtype for the backbone ('float32' | 'bfloat16';
        'auto' = bfloat16 on a CUDA device). Params, optimizer state, BN
        statistics, layer/batch-norm math, pooled descriptors and the loss
        stay f32."""
        return resolve_compute_dtype(self.compute_dtype, self.device)

    def check_supported(self) -> None:
        """Raise for the settings the port cannot run: a data-parallel
        size that is not the size of the initialised world (none: one
        rank), or a kernel flag against the device."""
        world = world_size()
        if max(self.data_parallel, 1) != max(world, 1):
            raise ValueError(
                f"--data_parallel {self.data_parallel}, but the "
                f"torch.distributed world has {world} ranks: start one "
                f"process per rank (torchrun --nproc_per_node "
                f"{self.data_parallel}), each joining the world")
        if self.resolved_use_flash() != self.on_card():
            raise ValueError(
                f"use_flash={self.use_flash!r} on device {self.device!r}: "
                f"the attention follows the device (the flash kernels for "
                f"CUDA tensors, the plain version for CPU tensors)")

    def normalized(self) -> "Config":
        """Apply the derived-flag expansion of `get_config()`
        (`config.py:145-155`)."""
        c = dataclasses.replace(self)
        if c.distort_partnet:
            c.rot_aug = True
            c.random_rotation = True
            c.jitter = True
            c.scale = True
            c.shift = False
        return c

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _add_args(parser: argparse.ArgumentParser):
    def str2bool(v):
        return str(v).lower() in ("true", "1")

    for f in dataclasses.fields(Config):
        t = f.type
        if t == "bool" or t is bool:
            parser.add_argument(f"--{f.name}", type=str2bool, default=f.default)
        elif t in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=f.default)
        elif t in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=f.default)
    return parser


def get_config(argv=None) -> Config:
    """Parse CLI into a Config (+ `--distort_partnet` expansion). If
    `--resume DIR` is given, reload DIR/config.json first and let explicit CLI
    flags override it (`tasks/main_csn.py:32-35` semantics)."""
    import sys

    parser = _add_args(argparse.ArgumentParser())
    args = parser.parse_args(argv)
    cfg = Config(**vars(args))
    if cfg.resume:
        import os

        cfg_path = os.path.join(cfg.resume, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as fh:
                saved = json.load(fh)
            # flags given explicitly on this command line win over the saved
            # config (resume/is_train always come from the CLI)
            given = {a.lstrip("-").split("=")[0]
                     for a in (argv if argv is not None else sys.argv[1:])
                     if a.startswith("--")}
            given |= {"resume", "is_train"}
            merged = cfg.to_dict()
            for k, v in saved.items():
                if k not in given:
                    merged[k] = v
            cfg = Config.from_dict(merged)
    return cfg.normalized()



def resolve_compute_dtype(v: str, device: str = "cuda") -> str:
    """'auto' -> bfloat16 on a CUDA device, float32 on the CPU."""
    v = str(v).lower()
    if v == "auto":
        return "bfloat16" if str(device).lower().startswith("cuda") \
            else "float32"
    return v
