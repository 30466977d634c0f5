"""Numpy reference of MinkowskiEngine 0.5.4 sparse-conv semantics (the port's
own copy of `csn_tpu/models/me_reference.py`; numpy only).

Purpose: the reference's released checkpoints store conv kernels as
`[kernel_volume, Cin, Cout]` rows enumerated by ME's kernel-region iterator.
Loading them correctly requires knowing that enumeration. This module encodes
it EXPLICITLY, so the converter's `offset_order='xyz'` default is pinned by a
deterministic unit test (tests/test_torch_convert.py) instead of a first-run
A/B guess: the test drives random kernels through (a) this numpy forward and
(b) our pyramid/kmap/sparse_conv pipeline after `_kernel_perm`, and demands
exact equality.

ME 0.5.4 conventions encoded here (derived from the engine's kernel-region
iterator, `MinkowskiEngine/src/kernel_region.hpp` `RegionIterator::
operator++`, HYPER_CUBE case):

* Offsets enumerate the FIRST spatial coordinate fastest (coordinates are
  [batch, x, y, z]; the iterator bumps dim 1 = x first, carrying into y then
  z). Row index of offset (ox, oy, oz) with radius r and tensor stride s:
  `(ox/s + r) + k*(oy/s + r) + k^2*(oz/s + r)`.
* Odd kernels are centered: offsets in {-r..r} * s per dim (region lower
  bound = c - r*s). Even kernels are forward: offsets in {0..k-1} * s
  (ME convention, mirrored by `core/pyramid.py MapSpec.offsets`).
* A regular conv pairs (input at c + o) -> (output at c) with kernel row
  idx(o). A transposed conv is the ADJOINT with the SAME per-row pairing:
  (input at c) -> (output at c + o) with row idx(o); equivalently output c'
  reads input c' - o with row idx(o).
* Stride-2 output coordinates live on the 2s grid via floor division
  (matches `core/pyramid.py` `floor_divide`; observable difference vs
  truncation only for negative coords — covered by the same test geometry,
  which includes negatives).
"""

from __future__ import annotations

import numpy as np


def me_offsets(ksize: int, tensor_stride: int) -> np.ndarray:
    """[k^3, 3] offsets in ME row order (x fastest)."""
    s = tensor_stride
    if ksize % 2 == 1:
        r = ksize // 2
        rng = np.arange(-r, r + 1) * s
    else:
        rng = np.arange(ksize) * s
    return np.array([(x, y, z) for z in rng for y in rng for x in rng],
                    dtype=np.int64)


def me_sparse_conv(in_coords: np.ndarray, in_feats: np.ndarray,
                   out_coords: np.ndarray, kernel: np.ndarray,
                   ksize: int, tensor_stride: int,
                   transpose: bool = False) -> np.ndarray:
    """Dense-loop ME-semantics sparse conv.

    in_coords [N, 3] int, in_feats [N, Cin], out_coords [M, 3] int,
    kernel [k^3, Cin, Cout] in ME row order. `tensor_stride` is the stride
    of the REGION (the input tensor's stride for a regular conv; the
    OUTPUT tensor's stride for a transposed conv, whose region is expressed
    on the finer grid).
    """
    offs = me_offsets(ksize, tensor_stride)
    lut = {tuple(c): i for i, c in enumerate(np.asarray(in_coords))}
    cout = kernel.shape[-1]
    out = np.zeros((out_coords.shape[0], cout), dtype=np.float64)
    for k, o in enumerate(offs):
        w = kernel[k].astype(np.float64)
        for j, c in enumerate(np.asarray(out_coords)):
            src = tuple(c - o) if transpose else tuple(c + o)
            i = lut.get(src)
            if i is not None:
                out[j] += in_feats[i].astype(np.float64) @ w
    return out
