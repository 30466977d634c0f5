"""Voxel batches on the device: the torch side of csn_tpu's batch builder.

The host builder is reused as it is (`csn_tpu/core/pyramid.py`, through
`csn_tpu_torch.host`); this module moves its `VoxelBatch` onto a torch
device and concatenates batches for the combined (K+1)*B backbone pass.

Layouts are the JAX package's: per-level features `[B, L_l, C]` with
`[B, L_l]` bool masks; kernel maps `[K_off, B*L_dst]` int32 addressing the
flattened source level, with sentinel `B*L_src`; trilinear tables
`[B, P, 8]` into the flattened `B*L_0` voxels, sentinel `B*L_0`, and
their voxel-major transpose in CSR form for the readout's backward.

The port ships the absolute int32 tables (`VoxelBatch.to_jax(compact=False)`
form): no int16 wire, no window worklists (`win!*` entries) and no dense
stem cells — those serve the TPU kernels, and the port's kernels read the
kernel maps directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from csn_tpu_torch.host import pyramid as _host_pyramid

map_levels = _host_pyramid._map_levels


@dataclasses.dataclass
class TorchVoxelBatch:
    """Device mirror of `VoxelBatch` (`JaxVoxelBatch` in the JAX package)."""

    points: Optional[torch.Tensor]          # [B, P, 3] f32
    point_feats: torch.Tensor               # [B, P, Cf] f32
    labels: torch.Tensor                    # [B, P] int32
    point_mask: torch.Tensor                # [B, P] bool
    coords: Optional[Tuple[torch.Tensor, ...]]  # level l: [B, L_l, 3] int32
    masks: Tuple[torch.Tensor, ...]         # level l: [B, L_l] bool
    vox_feats: torch.Tensor                 # [B, L_0, Cf] f32
    kmaps: Dict[str, torch.Tensor]          # name -> [K, B*L_dst] int32
    interp_idx: torch.Tensor                # [B, P, 8] int32
    interp_w: torch.Tensor                  # [B, P, 8] f32
    point_to_voxel: torch.Tensor            # [B, P] int32
    # voxel-major transpose of interp_idx in CSR form, for the readout's
    # backward kernel (`interp_csr`); None after concat_batches
    interp_ptr: Optional[torch.Tensor] = None   # [B*L0 + 1] int32
    interp_ent: Optional[torch.Tensor] = None   # [nnz] int32: p * 8 + corner

    @property
    def batch_size(self) -> int:
        return self.point_mask.shape[0]

    def to(self, device) -> "TorchVoxelBatch":
        """The batch with every tensor on `device`."""
        def mv(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, tuple):
                return tuple(t.to(device) for t in x)
            if isinstance(x, dict):
                return {k: t.to(device) for k, t in x.items()}
            return x

        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def interp_csr(interp_idx: np.ndarray, n_vox: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel-major transpose of the corner table interp_idx [B, P, 8]
    (sentinel n_vox) in CSR form: voxel v's entries are
    ent[ptr[v]:ptr[v + 1]], each the flat (point, corner) index p * 8 + j,
    ascending (a stable argsort). The port's counterpart of the JAX host's
    `win!interp_b` worklist."""
    flat = interp_idx.reshape(-1)
    valid = (flat >= 0) & (flat < n_vox)
    ptr = np.zeros(n_vox + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat[valid], minlength=n_vox), out=ptr[1:])
    order = np.flatnonzero(valid)
    order = order[np.argsort(flat[order], kind="stable")]
    return ptr.astype(np.int32), order.astype(np.int32)


def to_torch(vb, device) -> TorchVoxelBatch:
    """`VoxelBatch` (host numpy) -> `TorchVoxelBatch` on `device`: int32
    tables and f32 floats, as `VoxelBatch.to_jax(compact=False)`, plus the
    readout's CSR table (`interp_csr`)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    interp_idx = vb.interp_idx.astype(np.int32)
    ptr, ent = interp_csr(interp_idx, vb.masks[0].size)

    return TorchVoxelBatch(
        points=t(vb.points.astype(np.float32)),
        point_feats=t(vb.point_feats.astype(np.float32)),
        labels=t(vb.labels.astype(np.int32)),
        point_mask=t(vb.point_mask),
        coords=tuple(t(c.astype(np.int32)) for c in vb.coords),
        masks=tuple(t(m) for m in vb.masks),
        vox_feats=t(vb.vox_feats.astype(np.float32)),
        kmaps={k: t(v.astype(np.int32)) for k, v in vb.kmaps.items()
               if not k.startswith("win!")},
        interp_idx=t(interp_idx),
        interp_w=t(vb.interp_w.astype(np.float32)),
        point_to_voxel=t(vb.point_to_voxel.astype(np.int32)),
        interp_ptr=t(ptr),
        interp_ent=t(ent),
    )


def concat_batches(batches: Sequence[TorchVoxelBatch]) -> TorchVoxelBatch:
    """Concatenate batches built from one PyramidSpec along the batch axis
    (`concat_jax_batches`). Each batch's kernel-map, interp and
    point->voxel indices are offset into the combined flattened index space,
    and each sentinel `B_g * L_src` becomes the combined sentinel
    `total * L_src`. The readout's CSR table is dropped: the readout runs
    on the query batch alone."""
    if len(batches) == 1:
        return batches[0]
    b0 = batches[0]
    nl = len(b0.masks)
    caps = [m.shape[1] for m in b0.masks]
    bs = [b.masks[0].shape[0] for b in batches]
    cum = np.cumsum([0] + bs)
    total = int(cum[-1])

    def cat(get):
        return torch.cat([get(b) for b in batches], dim=0)

    def remap_cat(tables, src_l, dim):
        parts = []
        for g, t in enumerate(tables):
            sent_old = bs[g] * caps[src_l]
            off = int(cum[g]) * caps[src_l]
            parts.append(torch.where(t >= sent_old,
                                     torch.full_like(t, total * caps[src_l]),
                                     t + off))
        return torch.cat(parts, dim=dim)

    names = set.intersection(*(set(b.kmaps) for b in batches))
    kmaps = {name: remap_cat([b.kmaps[name] for b in batches],
                             map_levels(name)[0], dim=1)
             for name in b0.kmaps if name in names}

    return TorchVoxelBatch(
        points=None if b0.points is None else cat(lambda b: b.points),
        point_feats=cat(lambda b: b.point_feats),
        labels=cat(lambda b: b.labels),
        point_mask=cat(lambda b: b.point_mask),
        coords=None if b0.coords is None else tuple(
            torch.cat([b.coords[l] for b in batches], dim=0)
            for l in range(nl)),
        masks=tuple(torch.cat([b.masks[l] for b in batches], dim=0)
                    for l in range(nl)),
        vox_feats=cat(lambda b: b.vox_feats),
        kmaps=kmaps,
        interp_idx=remap_cat([b.interp_idx for b in batches], 0, dim=0),
        interp_w=cat(lambda b: b.interp_w),
        point_to_voxel=remap_cat([b.point_to_voxel for b in batches], 0,
                                 dim=0),
    )
