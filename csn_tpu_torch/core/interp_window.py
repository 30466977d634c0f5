"""Kernel K3 and its backward: the voxel -> point interpolation on the H100.

Counterpart of `csn_tpu/core/interp_window.py`, whose `_fwd_impl` and
`_bwd_impl` ran the readout and its gradient as Pallas TPU kernels of
one-hot matmuls over voxel windows, because row gathers were slow on the
TPU.

* K3 (`csn_tpu_torch/csrc/interp.cu`) gathers the 8 corner rows directly,
  one thread per (point, channel), in f32. Plain version:
  `csn_tpu_torch.core.interp.interpolate_to_points`.
* `interp_bwd` (`csn_tpu_torch/csrc/interp_bwd.cu`) sums each voxel's
  (point, corner) entries from the voxel-major CSR table of the batch, one
  thread per (voxel, channel): no scatter, no atomics. Plain version:
  `csn_tpu_torch.core.interp.interp_bwd_plain`.
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


def interp_bwd(g: torch.Tensor, ptr: torch.Tensor, ent: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Launch the K3 backward: g [P, C] (f32 or bf16), the CSR table ptr
    [N_vox + 1] and ent (entries p * 8 + corner) int32, w [P, 8] f32 ->
    dflat [N_vox, C] in g's dtype."""
    what = "interp_bwd"
    kernels.require_cuda(what, g, ptr, ent, w)
    if g.dim() != 2 or ptr.dim() != 1 or ent.dim() != 1 \
            or w.shape != (g.shape[0], 8):
        raise ValueError(f"{what}: want g [P, C], ptr [N_vox + 1], ent [E], "
                         f"w [P, 8]; got {tuple(g.shape)}, "
                         f"{tuple(ptr.shape)}, {tuple(ent.shape)}, "
                         f"{tuple(w.shape)}")
    if ptr.dtype != torch.int32 or ent.dtype != torch.int32 \
            or w.dtype != torch.float32:
        raise TypeError(f"{what}: want int32 ptr and ent and f32 w, got "
                        f"{ptr.dtype}, {ent.dtype}, {w.dtype}")
    n_vox, c = ptr.shape[0] - 1, g.shape[1]
    dflat = torch.empty((n_vox, c), dtype=g.dtype, device=g.device)
    code = kernels.library().csn_interp_bwd(
        kernels.dtype_code(g), g.data_ptr(), ptr.data_ptr(), ent.data_ptr(),
        w.data_ptr(), dflat.data_ptr(), n_vox, c, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return dflat
