"""Kernel K3: the voxel -> point interpolation forward on the H100.

Counterpart of `csn_tpu/core/interp_window.py`, whose `_fwd_impl` ran the
readout as a Pallas TPU kernel of one-hot matmuls over voxel windows,
because row gathers were slow on the TPU. The CUDA kernel
(`csn_tpu_torch/csrc/interp.cu`) gathers the 8 corner rows directly, one
thread per (point, channel), in f32. Its plain version is
`csn_tpu_torch.core.interp.interpolate_to_points`.
"""

from __future__ import annotations

import torch

from csn_tpu_torch import kernels


def interp_fwd(flat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Launch K3: flat [N_vox, C] (f32 or bf16), idx [P, 8] int32 (sentinel
    N_vox), w [P, 8] f32 -> [P, C] in flat's dtype."""
    what = "interp_fwd"
    kernels.require_cuda(what, flat, idx, w)
    if flat.dim() != 2 or idx.dim() != 2 or idx.shape[1] != 8 \
            or w.shape != idx.shape:
        raise ValueError(f"{what}: want flat [N, C], idx and w [P, 8]; got "
                         f"{tuple(flat.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{what}: want int32 idx and f32 w, got {idx.dtype} "
                        f"and {w.dtype}")
    n_vox, c = flat.shape
    n_pts = idx.shape[0]
    out = torch.empty((n_pts, c), dtype=flat.dtype, device=flat.device)
    code = kernels.library().csn_interp_fwd(
        kernels.dtype_code(flat), flat.data_ptr(), idx.data_ptr(),
        w.data_ptr(), out.data_ptr(), n_vox, n_pts, c, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out
