"""csn-tpu-torch: the PyTorch + CUDA port of csn_tpu for one NVIDIA H100.

The JAX package `csn_tpu` is the reference; this package mirrors its layout
so each module's counterpart sits under the same relative path:

  core/      voxel batches on the device, sparse conv, voxel -> point readout
  ops/       attention (flash kernel and its plain version)
  models/    HRNet CSN models and the flax -> torch weight converter
  train/     losses and the eval step
  csrc/      the hand-written CUDA kernels (sm_90a)
  kernels.py the one build-and-load of those kernels
  host.py    the way into csn_tpu's framework-neutral host code

Every kernel has a plain PyTorch version beside it; a wrapper takes the plain
version only for tensors on the CPU and launches its kernel for CUDA
tensors.
"""

__version__ = "0.1.0"
