"""Kernel K3 and its backward: the voxel -> point interpolation on the H100.

Counterpart of `csn_tpu/core/interp_window.py`, whose `_fwd_impl` and
`_bwd_impl` ran the readout and its gradient as Pallas TPU kernels of
one-hot matmuls over voxel windows, because row gathers were slow on the
TPU.

* K3 (`csn_tpu_torch/csrc/interp.cu`) gathers the 8 corner rows directly in
  f32. Plain version: `csn_tpu_torch.core.interp.interpolate_to_points`.
* `interp_bwd` (`csn_tpu_torch/csrc/interp_bwd.cu`) sums each voxel's
  (point, corner) entries from the voxel-major CSR table of the batch: no
  scatter, no atomics. Plain version:
  `csn_tpu_torch.core.interp.interp_bwd_plain`.

Each kernel has two bodies, and the wrappers pick one from the row before
the launch (`row_vector`): where a row is 32 to 64 pieces of 16 bytes and
starts on a 16-byte boundary (the extraction chain's 256 channels), a warp
takes 4 points or a run of voxels and moves rows 16 bytes a lane, one or
two pieces per lane; otherwise (the heads' 39 classes, every width under
128 or over 256 f32 channels) one thread takes two output channels of a
point or voxel. Both bodies give the same bits: each output element is one
f32 FMA chain in a fixed order. The kernels index in 32 bits, so the
wrappers refuse tables of 2^31 elements or more. K3 reads each point's
corner table (idx and w) 16 bytes at a time, so `interp_fwd` refuses
tables that do not start on a 16-byte boundary (a whole batch's always
do); no feature row is refused, since the scalar bodies take any.
"""

from __future__ import annotations

import torch

from csn_tpu_torch import kernels

LIMIT_32 = 2 ** 31


def row_vector(c: int, *rows: torch.Tensor) -> int:
    """Channels per piece of a lane: 16 bytes of them (4 f32, 8 bf16) when
    `c` is a multiple of that, a row holds one or two pieces per lane of a
    warp (32 to 64), and every row tensor starts on a 16-byte boundary (so
    every row does): the wide bodies. Else 1: the scalar bodies, which were
    faster at 39 classes on the H100 and take any row."""
    vec = 16 // rows[0].element_size()
    if c % vec == 0 and 32 <= c // vec <= 64 \
            and all(t.data_ptr() % 16 == 0 for t in rows):
        return vec
    return 1


def _require_32bit(what: str, **sizes: int) -> None:
    for name, n in sizes.items():
        if n >= LIMIT_32:
            raise ValueError(f"{what}: {name} = {n} does not fit the "
                             f"kernel's 32-bit indices (< 2^31)")


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
    _require_32bit(what, n_vox_x_c=n_vox * c, n_pts_x_c=n_pts * c,
                   n_pts_x_8=n_pts * 8)
    if idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: idx and w must start on a 16-byte "
                         f"boundary (the kernel reads a point's 8 corners "
                         f"16 bytes at a time)")
    out = torch.empty((n_pts, c), dtype=flat.dtype, device=flat.device)
    vec = row_vector(c, flat, out)
    code = kernels.library().csn_interp_fwd(
        kernels.dtype_code(flat), flat.data_ptr(), idx.data_ptr(),
        w.data_ptr(), out.data_ptr(), n_vox, n_pts, c, vec, kernels.stream())
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
    n_vox, (n_pts, c) = ptr.shape[0] - 1, g.shape
    _require_32bit(what, n_vox_x_c=n_vox * c, n_pts_x_c=n_pts * c,
                   n_pts_x_8=n_pts * 8)
    dflat = torch.empty((n_vox, c), dtype=g.dtype, device=g.device)
    vec = row_vector(c, g, dflat)
    code = kernels.library().csn_interp_bwd(
        kernels.dtype_code(g), g.data_ptr(), ptr.data_ptr(), ent.data_ptr(),
        w.data_ptr(), dflat.data_ptr(), n_vox, c, vec, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return dflat
