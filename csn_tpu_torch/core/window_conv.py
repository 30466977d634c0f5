"""The sparse conv kernels on the H100: K1 (forward, and the backward's
d_feats over the transpose map), `sparse_conv_dw` (the weight gradient), and
the im2col pair that `CSN_DYNG=2/3` selects.

Counterpart of `csn_tpu/core/window_conv.py`, whose `window_conv_fwd` and
`window_conv_bwd` ran the forward and the fused backward as Pallas TPU
kernels over windowed one-hot gathers and job worklists. The TPU needed
those because its row gathers were slow; the CUDA kernels gather rows
straight from the kernel map:

* K1 (`csn_tpu_torch/csrc/sparse_conv.cu`): one block per tile of output
  rows x output channels, f32 accumulation over all offsets in registers,
  one store in the activation dtype. By `k1_tensor_cores` it runs on the
  tensor cores (`mma.sync`) at Cout % 8 == 0: bf16, and f32 in split TF32
  (three TF32 products per f32 product). Where Cin % 16 == 0 it walks rows
  gathered by `cp.async` per (offset, 64 bf16 or 32 f32 input channels);
  at other Cin (the k5 stems' Cin 3) the im2col forward's flattened steps
  of K*Cin (64 or 32 columns), gathered element by element, so that K1's
  bf16 stem output is the im2col forward's bit for bit. Cout % 8 != 0
  runs f32 FMAs on the CUDA cores. Plain version:
  `csn_tpu_torch.core.conv.conv_plain`.
* `sparse_conv_dw` (`csn_tpu_torch/csrc/sparse_conv_bwd.cu`): one block per
  (channel tile, offset, row split), f32 partials per split summed by a
  second kernel in a fixed order. By K1's rule (`dw_tensor_cores`) it runs
  on the tensor cores (`mma.sync` over the split's live rows only,
  compacted into a list by warp ballots, rows gathered by `cp.async`), bf16
  or f32 in split TF32: in 64-channel tiles where Cin % 16 == 0, in
  16-channel tiles elsewhere (the narrow body at the stems: each lane loads
  its A fragment of 6- or 12-byte feats rows element by element). Cout % 8
  != 0 runs f32 FMAs on the CUDA cores. Plain version: the dW half of
  `csn_tpu_torch.core.conv.conv_bwd_plain`.
* `sparse_conv_im2col_fwd` (`csn_tpu_torch/csrc/sparse_conv_im2col.cu`): the
  forward as one product per output tile over the flattened axis K*Cin,
  walked in steps of 128 bytes of a row. By K1's rule (bf16, or f32 in
  split TF32, at Cout % 8 == 0) it runs K1's tensor-core body
  (`csrc/sparse_conv_tc.cuh`, K1's bits at every Cin in both types).
  Cout % 8 != 0 runs f32 FMAs on the CUDA cores. Plain version:
  `csn_tpu_torch.core.conv.conv_im2col_plain`.
* `sparse_conv_im2col_bwd` (`csn_tpu_torch/csrc/sparse_conv_im2col_bwd.cu`):
  the fused backward, one gather of the output gradient per (row tile,
  chunk of K*Cout) feeding d_feats and the whole dW. By the same rule it
  runs on the tensor cores (`mma.sync`, bf16 or f32 in split TF32;
  super-tiles of 256 rows keep d_feats in registers over all chunks, and
  dW goes to the split's partial once per super-tile and chunk, stored
  first and added after, so the partials need no zero fill); Cout % 8 != 0
  runs f32 FMAs on the CUDA cores. Plain version:
  `csn_tpu_torch.core.conv.conv_im2col_bwd_plain`.

`dyng_mode()` reads `CSN_DYNG` at call time, as the JAX package's function
does: `0` and `1` take K1 + `sparse_conv_dw` (mode 1's per-offset row gather
in fast memory is what K1 does on this card), `2` and `3` the im2col pair
(mode 3 differs from 2 only in how the TPU compiler addresses its scratch).
There is no fast-memory guard that demotes a wide map to another mode: every
conv runs the selected kernels, or the wrapper raises.
"""

from __future__ import annotations

import contextlib
import os

import torch

from csn_tpu_torch import kernels


def dyng_mode() -> int:
    """The conv kernels `CSN_DYNG` selects: 0 when unset or not one of
    "0".."3"."""
    v = os.environ.get("CSN_DYNG", "0")
    return int(v) if v in ("0", "1", "2", "3") else 0


@contextlib.contextmanager
def dyng(mode):
    """Within: `CSN_DYNG` is `mode` (None: unset); restored on exit."""
    saved = os.environ.get("CSN_DYNG")
    if mode is None:
        os.environ.pop("CSN_DYNG", None)
    else:
        os.environ["CSN_DYNG"] = str(mode)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CSN_DYNG", None)
        else:
            os.environ["CSN_DYNG"] = saved


def k1_tensor_cores(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether K1 and `sparse_conv_dw` run their tensor-core bodies: bf16,
    or f32 in split TF32, with Cout a multiple of 8, whatever Cin (every
    conv of the HRNet and U-Net families, the k5 stems' Cin 3 included: K1's
    flattened steps and dW's narrow body where Cin % 16 != 0). The C
    entries `csn_sparse_conv_fwd` and `csn_sparse_conv_dw` choose by this
    rule; other convs run the CUDA-core bodies."""
    return cout % 8 == 0 and dtype in (torch.bfloat16, torch.float32)


def k1_split_tf32(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether K1, `sparse_conv_dw` and the im2col pair run their split-TF32
    bodies (f32 on the tensor cores), whose launches count apart
    (`kernels.LAUNCHES` `sparse_conv_fwd_tf32`, `sparse_conv_dw_tf32`,
    `sparse_conv_im2col_fwd_tf32`, `sparse_conv_im2col_bwd_tf32`)."""
    return dtype == torch.float32 and k1_tensor_cores(dtype, cin, cout)


# dW and the im2col pair (`csn_sparse_conv_im2col_fwd`, `_bwd`) take their
# tensor-core bodies by K1's rule
dw_tensor_cores = k1_tensor_cores
im2col_tensor_cores = k1_tensor_cores


def _conv_fwd(what: str, entry: str, tensor_cores, feats: torch.Tensor,
              kmap: torch.Tensor, weights: torch.Tensor,
              max_offsets=None) -> torch.Tensor:
    """Check the arguments of a forward conv launcher and launch C entry
    `entry` (`csn_sparse_conv_fwd` or `csn_sparse_conv_im2col_fwd`, one
    contract), whose tensor-core bodies run where `tensor_cores(dtype, Cin,
    Cout)` holds. They copy the weights, and feats where Cin % 16 == 0, 16
    bytes at a time: they take only such views that start on a 16-byte
    boundary (the f32 stems' weights too). The launch counts under `what`,
    or `what + "_tf32"` where the split-TF32 bodies run."""
    kernels.require_cuda(what, feats, kmap, weights)
    if feats.dim() != 2 or kmap.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"{what}: want feats [N, Cin], kmap [K, N_out], "
                         f"weights [K, Cin, Cout]; got {tuple(feats.shape)}, "
                         f"{tuple(kmap.shape)}, {tuple(weights.shape)}")
    n_in, cin = feats.shape
    n_off, n_out = kmap.shape
    if weights.shape[:2] != (n_off, cin):
        raise ValueError(f"{what}: weights {tuple(weights.shape)} do not fit "
                         f"{n_off} offsets x Cin {cin}")
    if kmap.dtype != torch.int32:
        raise TypeError(f"{what}: kmap must be int32, got {kmap.dtype}")
    if weights.dtype != feats.dtype:
        raise TypeError(f"{what}: weights {weights.dtype} != feats "
                        f"{feats.dtype}")
    if max_offsets is not None and n_off > max_offsets:
        raise ValueError(f"{what}: {n_off} offsets; the kernel stages at "
                         f"most {max_offsets}")
    cout = weights.shape[2]
    if tensor_cores(feats.dtype, cin, cout) and (
            weights.data_ptr() % 16 or (cin % 16 == 0
                                        and feats.data_ptr() % 16)):
        raise ValueError(f"{what}: on the tensor cores (bf16, or f32 in "
                         f"split TF32) the weights, and feats where Cin % 16 "
                         f"== 0, must start on a 16-byte boundary (cp.async "
                         f"copies)")
    out = torch.empty((n_out, cout), dtype=feats.dtype, device=feats.device)
    code = getattr(kernels.library(), entry)(
        kernels.dtype_code(feats), feats.data_ptr(), kmap.data_ptr(),
        weights.data_ptr(), out.data_ptr(), n_in, n_out, n_off, cin, cout,
        kernels.stream())
    kernels.check(code, what)
    tf32 = k1_split_tf32(feats.dtype, cin, cout)
    kernels.LAUNCHES[what + "_tf32" if tf32 else what] += 1
    return out


def sparse_conv_fwd(feats: torch.Tensor, kmap: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Launch K1: feats [N_in, Cin], kmap [K, N_out] int32 (sentinel N_in),
    weights [K, Cin, Cout] of the feats' dtype -> [N_out, Cout]. The
    tensor-core bodies (`k1_tensor_cores`) take only weights, and feats
    where Cin % 16 == 0, that start on a 16-byte boundary (`_conv_fwd`)."""
    return _conv_fwd("sparse_conv_fwd", "csn_sparse_conv_fwd",
                     k1_tensor_cores, feats, kmap, weights)


SMS = 132            # streaming multiprocessors of the H100 SXM
MIN_SPLIT_ROWS = 1024
# the dW tensor-core bodies (csrc/sparse_conv_bwd.cu): map entries compacted
# per refill of the list; the wide body's (Cin % 16 == 0) live rows per
# product step and warps per SM it aims at, in bf16 and in f32 (split TF32:
# its tiles take twice the shared memory, so an SM holds half the warps,
# 2 blocks of 8 at Cout 256); the narrow body's (other Cin, bf16 or f32)
# warps per block, input channels per tile, live rows gathered at once and
# warps of its grid per SM (several waves: its blocks wait on latency, so
# more and shorter splits keep the card busier; this gives the 26 splits
# that measured best at both stems, in bf16 and in f32:
# tools/stem_splits.py)
DW_TC_CHUNK = 1024
DW_TC_STEP = 32
DW_TC_WARPS_PER_SM = 32
DW_TF32_WARPS_PER_SM = 16
DW_NARROW_WARPS = 4
DW_NARROW_CHANNELS = 16
DW_NARROW_TILE = 256
DW_NARROW_WARPS_PER_SM = 96


def col_tiles(cout: int):
    """(tiles, WN) of the tensor-core conv bodies: Cout in tiles of BN =
    64 WN channels, one tile up to Cout 256, else ceil(Cout / 256) tiles of
    equal width (Cout 384: two of 192)."""
    n64 = -(-cout // 64)
    tiles = -(-n64 // 4)
    return tiles, -(-n64 // tiles)


def dw_narrow_tiles(cin: int, cout: int) -> int:
    """Channel tiles of the narrow dW body: 16 input channels by 32 output
    channels up to Cout 32 (the stems), else by 64."""
    bn = 32 if cout <= 32 else 64
    return -(-cin // DW_NARROW_CHANNELS) * -(-cout // bn)


def dw_splits(n_in: int, n_off: int, cin: int, cout: int,
              tensor_cores: bool = False,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """Row splits S of the dW kernel, with at least MIN_SPLIT_ROWS rows per
    split and at most 64 splits. The CUDA-core body: enough that the grid of
    (channel tiles x offsets x S) blocks puts about two on each SM. The
    tensor-core bodies (`tensor_cores`): the wide one (Cin % 16 == 0), whose
    blocks are 2 WN warps (input channels in tiles of 64, output channels in
    `col_tiles`), about DW_TC_WARPS_PER_SM warps on each SM in bf16 and
    DW_TF32_WARPS_PER_SM in f32 (`dtype`); the narrow one (other Cin, bf16
    or f32: one tile of live pairs in both), blocks of DW_NARROW_WARPS
    warps per `dw_narrow_tiles` tile, about DW_NARROW_WARPS_PER_SM."""
    if tensor_cores and cin % 16 == 0:
        tiles, wn = col_tiles(cout)
        warps = -(-cin // 64) * tiles * n_off * 2 * wn
        per_sm = (DW_TF32_WARPS_PER_SM if dtype == torch.float32
                  else DW_TC_WARPS_PER_SM)
        want = -(-per_sm * SMS // warps)
    elif tensor_cores:
        warps = dw_narrow_tiles(cin, cout) * n_off * DW_NARROW_WARPS
        want = -(-DW_NARROW_WARPS_PER_SM * SMS // warps)
    else:
        tm = 16 if cin <= 16 else 64          # the kernel's channel tile
        blocks = -(-cin // tm) * -(-cout // 64) * n_off
        want = -(-2 * SMS // blocks)
    return max(1, min(want, 64, n_in // MIN_SPLIT_ROWS))


def sparse_conv_dw(feats: torch.Tensor, g: torch.Tensor,
                   kmap_t: torch.Tensor) -> torch.Tensor:
    """Launch the dW kernel: feats [N_in, Cin] and g [N_g, Cout] of one
    dtype, kmap_t [K, N_in] int32 (sentinel N_g) -> dW_t [K, Cin, Cout] f32,
    dW_t[k] = feats^T . gather(g, kmap_t[k]). The tensor-core bodies copy
    g rows, and feats rows where Cin % 16 == 0, 16 bytes at a time: they
    take only such views that start on a 16-byte boundary (the f32 stems'
    g too). The launch counts under `sparse_conv_dw`, or
    `sparse_conv_dw_tf32` where the split-TF32 bodies run."""
    what = "sparse_conv_dw"
    kernels.require_cuda(what, feats, g, kmap_t)
    if feats.dim() != 2 or g.dim() != 2 or kmap_t.dim() != 2 \
            or kmap_t.shape[1] != feats.shape[0]:
        raise ValueError(f"{what}: want feats [N_in, Cin], g [N_g, Cout], "
                         f"kmap_t [K, N_in]; got {tuple(feats.shape)}, "
                         f"{tuple(g.shape)}, {tuple(kmap_t.shape)}")
    if kmap_t.dtype != torch.int32:
        raise TypeError(f"{what}: kmap_t must be int32, got {kmap_t.dtype}")
    if g.dtype != feats.dtype:
        raise TypeError(f"{what}: g {g.dtype} != feats {feats.dtype}")
    n_in, cin = feats.shape
    n_g, cout = g.shape
    n_off = kmap_t.shape[0]
    tc = dw_tensor_cores(feats.dtype, cin, cout)
    if tc and (g.data_ptr() % 16 or cin % 16 == 0 and feats.data_ptr() % 16):
        raise ValueError(f"{what}: on the tensor cores (bf16, or f32 in split "
                         f"TF32) g, and feats where Cin % 16 == 0, must start "
                         f"on a 16-byte boundary (cp.async copies)")
    n_split = dw_splits(n_in, n_off, cin, cout, tc, feats.dtype)
    out = torch.empty((n_off, cin, cout), dtype=torch.float32,
                      device=feats.device)
    part = (torch.empty((n_split, n_off, cin, cout), dtype=torch.float32,
                        device=feats.device) if n_split > 1 else out)
    code = kernels.library().csn_sparse_conv_dw(
        kernels.dtype_code(feats), feats.data_ptr(), g.data_ptr(),
        kmap_t.data_ptr(), part.data_ptr(), out.data_ptr(), n_in, n_g, n_off,
        cin, cout, n_split, kernels.stream())
    kernels.check(code, what)
    tf32 = k1_split_tf32(feats.dtype, cin, cout)
    kernels.LAUNCHES[what + "_tf32" if tf32 else what] += 1
    return out


# the im2col forward stages a tile's map columns in shared memory (the
# CUDA-core body 65 int32 per offset beside 8 KB of operand tiles, the
# tensor-core body fewer rows per tile where many offsets need it), of 227
# KB a block can use
IM2COL_MAX_OFFSETS = 640
# device memory the backward's per-split dW partials may take
IM2COL_PART_BYTES = 512 * 2 ** 20
IM2COL_TILE = 64


def sparse_conv_im2col_fwd(feats: torch.Tensor, kmap: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Launch the im2col forward: feats [N_in, Cin], kmap [K, N_out] int32
    (sentinel N_in), weights [K, Cin, Cout] of the feats' dtype ->
    [N_out, Cout] = IC @ weights.reshape(K * Cin, Cout), at most
    IM2COL_MAX_OFFSETS offsets. Its tensor-core bodies are K1's (bf16, and
    f32 in split TF32), with K1's alignment rule (`_conv_fwd`); the launch
    counts under `sparse_conv_im2col_fwd_tf32` where the split-TF32 body
    runs."""
    return _conv_fwd("sparse_conv_im2col_fwd", "csn_sparse_conv_im2col_fwd",
                     im2col_tensor_cores, feats, kmap, weights,
                     IM2COL_MAX_OFFSETS)


def im2col_bwd_splits(n_in: int, n_off: int, cin: int, cout: int) -> int:
    """Row splits S of the im2col backward: about four blocks of (split x
    tile of input channels) on each SM (a block waits on its gathers, so
    the SM needs several to stay busy), at most one split per row tile, and
    partials [S, Cin, K * Cout] f32 within IM2COL_PART_BYTES."""
    bc = 16 if cin <= 16 else 64              # the kernel's channel tile
    want = -(-4 * SMS // -(-cin // bc))
    n_tiles = max(1, -(-n_in // IM2COL_TILE))
    fit = IM2COL_PART_BYTES // (4 * cin * n_off * cout)
    per_split = -(-n_tiles // max(1, min(want, n_tiles, fit)))
    return -(-n_tiles // per_split)   # no split without a tile


def im2col_bwd_tc_splits(n_in: int, n_off: int, cin: int, cout: int,
                         rows: int, bc: int) -> int:
    """Row splits S of the tensor-core im2col backward (bf16, and f32 in
    split TF32: one set of tiles), whose blocks of 8 warps (split x tile of
    `bc` input channels) fill an SM each: about one
    block per SM, whole super-tiles of `rows` rows per split spread evenly
    (no split without one), and partials [S, Cin, K * Cout] f32 within
    IM2COL_PART_BYTES. The partial traffic is one write of dW per
    super-tile whatever S is, so S only has to fill the card. The kernel
    gives its tiles: `csn_sparse_conv_im2col_bwd_tc_rows()` and
    `csn_sparse_conv_im2col_bwd_tc_channels(cin)`."""
    want = -(-SMS // -(-cin // bc))
    n_st = max(1, -(-n_in // rows))
    fit = IM2COL_PART_BYTES // (4 * cin * n_off * cout)
    per_split = -(-n_st // max(1, min(want, n_st, fit)))
    return -(-n_st // per_split)


def sparse_conv_im2col_bwd(feats: torch.Tensor, g: torch.Tensor,
                           kmap_t: torch.Tensor, wt_flat,
                           dw_only: bool = False):
    """Launch the fused im2col backward: feats [N_in, Cin] and g [N_g, Cout]
    of one dtype, kmap_t [K, N_in] int32 (sentinel N_g), wt_flat
    [K * Cout, Cin] of that dtype (the paired weights transposed and
    stacked; None with `dw_only`) -> (d_feats [N_in, Cin] in that dtype, or
    None with `dw_only`; dW_flat [Cin, K * Cout] f32 = feats^T @ GG). The
    tensor-core bodies (`im2col_tensor_cores`: bf16, or f32 in split TF32)
    copy g, and feats and wt_flat where their rows are 16-byte pieces (Cin %
    8 == 0 in bf16, Cin % 4 == 0 in f32), 16 bytes at a time: they take only
    such views that start on a 16-byte boundary. The launch counts under
    `sparse_conv_im2col_bwd_tf32` where the split-TF32 body runs."""
    what = "sparse_conv_im2col_bwd"
    tensors = (feats, g, kmap_t) if dw_only else (feats, g, kmap_t, wt_flat)
    kernels.require_cuda(what, *tensors)
    if feats.dim() != 2 or g.dim() != 2 or kmap_t.dim() != 2 \
            or kmap_t.shape[1] != feats.shape[0]:
        raise ValueError(f"{what}: want feats [N_in, Cin], g [N_g, Cout], "
                         f"kmap_t [K, N_in]; got {tuple(feats.shape)}, "
                         f"{tuple(g.shape)}, {tuple(kmap_t.shape)}")
    if kmap_t.dtype != torch.int32:
        raise TypeError(f"{what}: kmap_t must be int32, got {kmap_t.dtype}")
    if g.dtype != feats.dtype:
        raise TypeError(f"{what}: g {g.dtype} != feats {feats.dtype}")
    n_in, cin = feats.shape
    n_g, cout = g.shape
    n_off = kmap_t.shape[0]
    if n_off > IM2COL_MAX_OFFSETS:
        raise ValueError(f"{what}: {n_off} offsets; the kernel stages at "
                         f"most {IM2COL_MAX_OFFSETS}")
    d_feats = None
    if not dw_only:
        if wt_flat.shape != (n_off * cout, cin) or wt_flat.dtype != g.dtype:
            raise ValueError(f"{what}: want wt_flat [{n_off * cout}, {cin}] "
                             f"{g.dtype}; got {tuple(wt_flat.shape)} "
                             f"{wt_flat.dtype}")
        d_feats = torch.empty_like(feats)
    tc = im2col_tensor_cores(feats.dtype, cin, cout)
    pieces = cin % (16 // feats.element_size()) == 0
    if tc and (g.data_ptr() % 16 or pieces and (
            feats.data_ptr() % 16
            or not dw_only and wt_flat.data_ptr() % 16)):
        raise ValueError(f"{what}: on the tensor cores (bf16, or f32 in split "
                         f"TF32) g, and feats and wt_flat where their rows "
                         f"are 16-byte pieces (Cin % 8 == 0 in bf16, Cin % 4 "
                         f"== 0 in f32), must start on a 16-byte boundary "
                         f"(cp.async copies)")
    lib = kernels.library()
    n_split = im2col_bwd_tc_splits(
        n_in, n_off, cin, cout, lib.csn_sparse_conv_im2col_bwd_tc_rows(),
        lib.csn_sparse_conv_im2col_bwd_tc_channels(cin)) if tc \
        else im2col_bwd_splits(n_in, n_off, cin, cout)
    # the tensor-core blocks store their slices of the partials before they
    # add to them; the CUDA-core blocks only add, so theirs start at zero
    part = (torch.empty if tc else torch.zeros)(
        (n_split, cin, n_off * cout), dtype=torch.float32, device=feats.device)
    out = part[0] if n_split == 1 else torch.empty_like(part[0])
    code = lib.csn_sparse_conv_im2col_bwd(
        kernels.dtype_code(feats), feats.data_ptr(), g.data_ptr(),
        kmap_t.data_ptr(), 0 if dw_only else wt_flat.data_ptr(),
        0 if dw_only else d_feats.data_ptr(), part.data_ptr(),
        out.data_ptr(), n_in, n_g, n_off, cin, cout, n_split, int(dw_only),
        kernels.stream())
    kernels.check(code, what)
    tf32 = k1_split_tf32(feats.dtype, cin, cout)
    kernels.LAUNCHES[what + "_tf32" if tf32 else what] += 1
    return d_feats, out
