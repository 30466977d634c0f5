"""Voxel -> point readout (trilinear interpolation).

Counterpart of `csn_tpu/core/interp.py`: the network output lives on the
level-0 voxels; loss and predictions are taken at the points. The corner
indices and weights come precomputed from the host batch builder.

`InterpFn` (through `interp_batch`) launches the CUDA kernels
(core/interp_window.py: K3 and `interp_bwd`) for CUDA tensors and runs the
plain versions `interpolate_to_points` / `interp_bwd_plain` for CPU tensors.
The backward is the gradient of the voxel table only: corner indices and
weights are data.
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


def interp_bwd_plain(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     n_vox: int) -> torch.Tensor:
    """Plain version of the backward: g [P, C], idx and w [P, 8] ->
    dflat [n_vox, C] in g's dtype, the `index_add_` in f32 of w * g over the
    corner indices (the sentinel adds nothing)."""
    valid = (idx >= 0) & (idx < n_vox)
    contrib = w[..., None].float() * g[:, None, :].float()   # [P, 8, C]
    dflat = torch.zeros((n_vox, g.shape[1]), dtype=torch.float32,
                        device=g.device)
    dflat.index_add_(0, idx[valid].long(), contrib[valid])
    return dflat.to(g.dtype)


class InterpFn(torch.autograd.Function):
    """flat [N_vox, C] -> [P, C] point features, differentiable in `flat`
    (the custom VJP `interp_window_apply` of the JAX package). idx and w
    are [P, 8]; ptr and ent the batch's voxel-major CSR table, which the
    CUDA backward needs."""

    @staticmethod
    def forward(ctx, flat, idx, w, ptr, ent):
        if flat.device.type == "cpu":
            out = interpolate_to_points(flat, idx[None], w[None])[0]
        else:
            out = interp_window.interp_fwd(flat, idx, w)
        ctx.save_for_backward(idx, w, ptr, ent)
        ctx.n_vox = flat.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, ptr, ent = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            dflat = interp_bwd_plain(g, idx, w, ctx.n_vox)
        else:
            if ptr is None:
                raise RuntimeError("interp backward on the GPU needs the "
                                   "batch's CSR table (to_torch builds it)")
            dflat = interp_window.interp_bwd(g, ptr, ent, w)
        return dflat, None, None, None, None


def interp_batch(vox_feats: torch.Tensor, batch) -> torch.Tensor:
    """[B, L0, C] voxel features -> [B, P, C] point features of `batch`."""
    B, L0, C = vox_feats.shape
    P = batch.interp_idx.shape[1]
    out = InterpFn.apply(vox_feats.reshape(B * L0, C),
                         batch.interp_idx.reshape(B * P, 8),
                         batch.interp_w.reshape(B * P, 8),
                         batch.interp_ptr, batch.interp_ent)
    return out.reshape(B, P, C)


def nearest_voxel_to_points(vox_feats: torch.Tensor,
                            point_to_voxel: torch.Tensor) -> torch.Tensor:
    """Containing-voxel readout (ME `slice()`): [B, L0, C] x [B, P] -> [B, P,
    C], zeros for the sentinel."""
    flat = vox_feats.reshape(-1, vox_feats.shape[-1])
    return gather_rows(flat, point_to_voxel)
