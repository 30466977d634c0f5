"""csn-tpu-torch: the PyTorch + CUDA port of csn_tpu for one NVIDIA H100.

The JAX package `csn_tpu` is the reference; this package mirrors its layout
so each module's counterpart sits under the same relative path:

  config.py  the Config dataclass, its CLI and resume-reload (plus `device`)
  tasks/     the CLIs: main_csn (CSN train / eval), main_seg
  core/      host batch construction (numpy + the C++ engine, the port's own
             copy), voxel batches on the device, sparse conv, voxel -> point
             readout
  data/      PartNet reader, augmentations, sampler, prefetch thread, batch
             assembly for a model, seeded synthetic shapes
  ops/       attention: the flash kernels, their per-key-block forms for
             ring attention, and the plain versions
  models/    HRNet CSN models and the flax -> torch weight converter
  midfc/     the MID-FC branch: CrossShapeAt heads, runner, datasets,
             converters, launcher
  retrieval/ the retrieval measure and the kNN graphs
  parallel/  data-parallel x point-sharded MID-FC steps (torch.distributed)
  train/     losses, metrics, optimizers, the HRNet eval and train steps,
             the trainers (SegTrainer, CSNTrainer) and their checkpoints
  utils/     logging / metrics writer, timers
  csrc/      the hand-written CUDA kernels (sm_90a) and the C++ host engine
  kernels.py the one build-and-load of those kernels

The package imports torch and numpy, never jax, and nothing of `csn_tpu`.
Every kernel has a plain PyTorch version beside it; a wrapper takes the plain
version only for tensors on the CPU and launches its kernel for CUDA
tensors.
"""

__version__ = "0.1.0"
