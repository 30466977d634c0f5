"""Voxel -> point readout (trilinear interpolation).

Counterpart of `csn_tpu/core/interp.py`: the network output lives on the
level-0 voxels; loss and predictions are taken at the points. The corner
indices and weights come precomputed from the host batch builder.

`interp_batch` launches the CUDA kernel (core/interp_window.py) for CUDA
tensors and runs the plain version `interpolate_to_points` for CPU tensors.
"""

from __future__ import annotations

import torch

from csn_tpu_torch.core import interp_window
from csn_tpu_torch.core.conv import gather_rows


def interpolate_to_points(vox_feats: torch.Tensor, interp_idx: torch.Tensor,
                          interp_w: torch.Tensor) -> torch.Tensor:
    """Plain version. vox_feats [B, L0, C] (or flattened [B*L0, C]),
    interp_idx [B, P, 8] int32 into the flattened voxels (sentinel B*L0),
    interp_w [B, P, 8] -> [B, P, C] in the features' dtype."""
    flat = vox_feats.reshape(-1, vox_feats.shape[-1])
    g = gather_rows(flat, interp_idx)                 # [B, P, 8, C]
    return torch.einsum("bpkc,bpk->bpc", g, interp_w.to(g.dtype))


def interp_batch(vox_feats: torch.Tensor, batch) -> torch.Tensor:
    """[B, L0, C] voxel features -> [B, P, C] point features of `batch`."""
    if vox_feats.device.type == "cpu":
        return interpolate_to_points(vox_feats, batch.interp_idx,
                                     batch.interp_w)
    B, L0, C = vox_feats.shape
    P = batch.interp_idx.shape[1]
    out = interp_window.interp_fwd(vox_feats.reshape(B * L0, C),
                                   batch.interp_idx.reshape(B * P, 8),
                                   batch.interp_w.reshape(B * P, 8))
    return out.reshape(B, P, C)


def nearest_voxel_to_points(vox_feats: torch.Tensor,
                            point_to_voxel: torch.Tensor) -> torch.Tensor:
    """Containing-voxel readout (ME `slice()`): [B, L0, C] x [B, P] -> [B, P,
    C], zeros for the sentinel."""
    flat = vox_feats.reshape(-1, vox_feats.shape[-1])
    return gather_rows(flat, point_to_voxel)
