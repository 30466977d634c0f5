"""Voxel batches: their construction on the host and their device mirror.

The port's own copy of the JAX package's batch construction
(`csn_tpu/core/pyramid.py`), numpy and the C++ engine only, and the torch
side that moves a built `VoxelBatch` onto a device and concatenates batches
for the combined (K+1)*B backbone pass.

`build_voxel_batch` precomputes on the host, per batch, a voxel pyramid: one
padded, masked, fixed-capacity coordinate array per stride level, plus
integer kernel maps (per-offset neighbor index tables) for every (level,
kernel) combination a model needs, so that the device runs static-shape
gather / product / scatter compute. It gives bit for bit the tables of the
JAX package's code, through the C++ engine (`core/native.py`) or in
numpy. Left out, because only the TPU kernels read them: the int16 wire
coders, the window worklists (`win!*` entries) and the dense stem cells.

Layouts are the JAX package's: per-point data `[B, P, ...]` with
`point_mask`; per-level features `[B, L_l, C]` with `[B, L_l]` bool masks;
kernel maps `[K_off, B*L_dst]` int32 addressing the flattened source level,
with sentinel `B*L_src`; trilinear tables `[B, P, 8]` into the flattened
`B*L_0` voxels, sentinel `B*L_0`, and their voxel-major transpose in CSR
form for the readout's backward. Level-0 voxel coordinates are
`floor(point / voxel)`; level `l+1` coordinates are
`floor(c / (2*s)) * (2*s)` of level-`l` coordinates (world-voxel units).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


_POOL = None
_POOL_INIT_LOCK = threading.Lock()


def _host_pool():
    """Shared thread pool for host-side batch builds: one persistent pool
    instead of fresh executors per batch. The C++ engine releases the GIL,
    so its calls overlap. Sized at 8: the per-shape builds submit at most
    that many jobs, and none of the submitted functions submit nested pool
    work (deadlock-free)."""
    global _POOL
    if _POOL is None:
        with _POOL_INIT_LOCK:
            if _POOL is None:  # double-checked: callers may build
                # query and neighbor batches concurrently; without
                # the lock each racer creates a pool and one leaks its 8
                # threads
                from concurrent.futures import ThreadPoolExecutor

                _POOL = ThreadPoolExecutor(max_workers=8,
                                           thread_name_prefix="csn-host")
    return _POOL


class QMode(enum.Enum):
    """Quantization mode for point->voxel feature reduction.

    Mirrors ME quantization enums selected in the reference's
    `lib/config.py:156-168` (`--avg_feat` flag).
    """

    RANDOM_SUBSAMPLE = 0
    UNWEIGHTED_AVERAGE = 1


@dataclasses.dataclass(frozen=True)
class MapSpec:
    """One kernel map to build.

    kind:  'same' (stride-1 conv at `level`),
           'down' (stride-2 conv from `level` to `level+1`),
           'up'   (stride-2 transpose conv from `level+1` to `level`).
    ksize: cubic kernel size. Odd kernels use offsets {-(k//2)..k//2}^3 * s,
           even kernels use {0..k-1}^3 * s (ME convention).
    """

    kind: str
    level: int
    ksize: int

    @property
    def name(self) -> str:
        return f"{self.kind}{self.level}k{self.ksize}"

    def offsets(self) -> np.ndarray:
        s = 2 ** self.level
        if self.ksize % 2 == 1:
            r = self.ksize // 2
            rng = np.arange(-r, r + 1) * s
        else:
            rng = np.arange(self.ksize) * s
        offs = np.array(list(itertools.product(rng, rng, rng)), dtype=np.int64)
        return offs  # [ksize**3, 3]

    @property
    def num_offsets(self) -> int:
        return self.ksize ** 3


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static-shape description of a voxel batch (compilation signature)."""

    voxel_size: float
    num_points: int                   # P: per-shape point capacity
    level_caps: Tuple[int, ...]       # L_l: per-shape voxel capacity per level
    maps: Tuple[MapSpec, ...]
    qmode: QMode = QMode.RANDOM_SUBSAMPLE
    # Sort each shape's points by containing level-0 voxel at batch build.
    # Semantically free: per-point arrays permute together, and loss and
    # metrics are permutation-invariant.
    sort_points: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.level_caps)

    def map_names(self) -> List[str]:
        return [m.name for m in self.maps]


def default_level_caps(num_points: int, num_levels: int,
                       shrink: float = 3.0, floor: int = 64) -> Tuple[int, ...]:
    """Heuristic per-level voxel capacities: each stride-2 level of a 3D sparse
    shape typically shrinks the voxel count by ~4-8x; we budget conservatively
    with `shrink` (default 3x) and round up to a multiple of 32, as the JAX
    package does (the two packages give the same tables)."""
    caps = []
    cap = float(num_points)
    for _ in range(num_levels):
        c = max(int(np.ceil(cap)), floor)
        caps.append(int(-(-c // 32) * 32))
        cap = cap / shrink
    return tuple(caps)


@dataclasses.dataclass
class VoxelBatch:
    """A fully materialized, static-shape batch (host numpy arrays).

    `to_torch` (below) moves it onto a torch device.
    """

    # Per-point data (level 0 frame): float voxel coords, input features,
    # labels, validity.
    points: np.ndarray         # [B, P, 3] float32  (coords / voxel_size)
    point_feats: np.ndarray    # [B, P, Cf] float32
    labels: np.ndarray         # [B, P] int32 (ignore label kept as-is)
    point_mask: np.ndarray     # [B, P] bool

    # Per-level voxel data.
    coords: List[np.ndarray]   # level l: [B, L_l, 3] int32 (world-voxel units)
    masks: List[np.ndarray]    # level l: [B, L_l] bool
    vox_feats: np.ndarray      # [B, L_0, Cf] float32 (quantized input features)

    # Kernel maps: name -> [K_off, B*L_target] int32 (sentinel = B*L_source).
    kmaps: Dict[str, np.ndarray]

    # Trilinear point readout at level 0.
    interp_idx: np.ndarray     # [B, P, 8] int32 into flattened B*L_0 (sentinel B*L_0)
    interp_w: np.ndarray       # [B, P, 8] float32

    # Map from each point to its containing level-0 voxel (flattened index,
    # sentinel for invalid points). Used for nearest-voxel readout.
    point_to_voxel: np.ndarray  # [B, P] int32

    # Bookkeeping
    num_voxels: List[np.ndarray]  # level l: [B] int32 true counts
    dropped: List[int]            # voxels dropped per level due to caps


def _map_levels(name: str) -> Tuple[int, int]:
    """(src_level, dst_level) of a kernel-map name like 'same0k3'."""
    kind = "same" if name.startswith("same") else (
        "down" if name.startswith("down") else "up")
    lvl = int(name[len(kind):].split("k")[0])
    if kind == "same":
        return lvl, lvl
    if kind == "down":
        return lvl, lvl + 1
    return lvl + 1, lvl


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------


def _pack_keys(coords: np.ndarray, mins: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Pack int coords [N,3] into sortable int64 keys (within one shape)."""
    c = coords - mins[None, :]
    return (c[:, 0].astype(np.int64) * dims[1] + c[:, 1]) * dims[2] + c[:, 2]


class _LevelIndex:
    """Sorted-key lookup table for one (batch-element, level) coordinate set."""

    def __init__(self, coords: np.ndarray):
        # coords: [n, 3] int64, unique
        if coords.shape[0] == 0:
            self.mins = np.zeros(3, dtype=np.int64)
            self.dims = np.ones(3, dtype=np.int64)
            self.sorted_keys = np.empty(0, dtype=np.int64)
            self.sorted_idx = np.empty(0, dtype=np.int64)
            return
        self.mins = coords.min(axis=0) - 1
        maxs = coords.max(axis=0) + 2
        self.dims = (maxs - self.mins).astype(np.int64)
        keys = _pack_keys(coords, self.mins, self.dims)
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_idx = order

    def lookup(self, queries: np.ndarray) -> np.ndarray:
        """queries: [M, 3] int64 -> index into the original coords array,
        or -1 if absent."""
        if self.sorted_keys.shape[0] == 0:
            return np.full(queries.shape[0], -1, dtype=np.int64)
        inside = np.all((queries > self.mins) & (queries < self.mins + self.dims),
                        axis=1)
        q = np.where(inside[:, None], queries, self.mins[None, :] + 1)
        keys = _pack_keys(q, self.mins, self.dims)
        pos = np.searchsorted(self.sorted_keys, keys)
        pos = np.clip(pos, 0, self.sorted_keys.shape[0] - 1)
        found = (self.sorted_keys[pos] == keys) & inside
        out = np.where(found, self.sorted_idx[pos], -1)
        return out


def _shape_tables_numpy(pts: np.ndarray, spec: PyramidSpec) -> dict:
    """Per-shape coordinate tables (pure numpy): voxel coords per level,
    local kernel maps (-1 = missing), interp corners, point->voxel map."""
    nl = spec.num_levels
    ic = np.floor(pts).astype(np.int64)
    mins = ic.min(axis=0) - 1
    dims = ic.max(axis=0) + 2 - mins
    keys = _pack_keys(ic, mins, dims)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    n = uniq_keys.shape[0]
    order = np.argsort(inv, kind="stable")
    inv_sorted = inv[order]
    boundary = np.ones(inv_sorted.shape[0], dtype=bool)
    boundary[1:] = inv_sorted[1:] != inv_sorted[:-1]
    first_idx = np.empty(n, dtype=np.int64)
    first_idx[inv_sorted[boundary]] = order[boundary]
    vc = ic[first_idx]

    coords = [vc]
    indices = [_LevelIndex(vc)]
    prev = vc
    for l in range(1, nl):
        s2 = 2 ** l
        down = np.floor_divide(prev, s2) * s2
        uniq = np.unique(down, axis=0)
        coords.append(uniq)
        indices.append(_LevelIndex(uniq))
        prev = uniq

    kmaps = {}
    for m in spec.maps:
        if m.kind == "same":
            src_l, dst_l, sign = m.level, m.level, +1
        elif m.kind == "down":
            src_l, dst_l, sign = m.level, m.level + 1, +1
        else:
            src_l, dst_l, sign = m.level + 1, m.level, -1
        offs = m.offsets()
        out_c = coords[dst_l][: spec.level_caps[dst_l]]
        nk = offs.shape[0]
        table = np.full((nk, spec.level_caps[dst_l]), -1, dtype=np.int32)
        if out_c.shape[0]:
            for k in range(nk):
                hit = indices[src_l].lookup(out_c + sign * offs[k][None, :])
                table[k, : out_c.shape[0]] = hit.astype(np.int32)
        kmaps[m.name] = table

    base = np.floor(pts).astype(np.int64)
    frac = pts - base
    p = pts.shape[0]
    interp_idx = np.full((p, 8), -1, dtype=np.int32)
    interp_w = np.zeros((p, 8), dtype=np.float32)
    corner_offs = np.array(list(itertools.product([0, 1], repeat=3)),
                           dtype=np.int64)
    for k in range(8):
        off = corner_offs[k]
        hit = indices[0].lookup(base + off[None, :])
        w = np.prod(np.where(off[None, :] == 1, frac, 1.0 - frac),
                    axis=1).astype(np.float32)
        interp_idx[:, k] = hit.astype(np.int32)
        interp_w[:, k] = np.where(hit >= 0, w, 0.0)

    return {"coords": coords, "kmaps": kmaps, "interp_idx": interp_idx,
            "interp_w": interp_w, "p2v": inv.astype(np.int32)}


def _shape_tables_native(pts: np.ndarray, spec: PyramidSpec) -> dict:
    """Same tables via the C++ engine (csn_tpu_torch/csrc/coords.cpp)."""
    from csn_tpu_torch.core import native

    nl = spec.num_levels
    sh = native.NativeShape(pts.astype(np.float32), nl)
    coords = [sh.coords(l, spec.level_caps[l] + 10 ** 9)
              for l in range(nl)]
    kmaps = {}
    for m in spec.maps:
        dst_l = m.level + 1 if m.kind == "down" else m.level
        kmaps[m.name] = sh.kernel_map(m.kind, m.level, m.ksize,
                                      spec.level_caps[dst_l])
    interp_idx, interp_w = sh.interp()
    return {"coords": coords, "kmaps": kmaps, "interp_idx": interp_idx,
            "interp_w": interp_w, "p2v": sh.p2v()}


def build_voxel_batch(
    shapes: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    spec: PyramidSpec,
    rng: Optional[np.random.Generator] = None,
    ignore_label: int = 255,
    use_native: Optional[bool] = None,
) -> VoxelBatch:
    """Build a static-shape VoxelBatch from a list of shapes.

    shapes: sequence of (coords [P_i,3] float world coords, feats [P_i,Cf],
            labels [P_i] int). Coords are divided by spec.voxel_size here
            (reference: `lib/voxelizer.py:34-45` applies the same scale as a
            homogeneous transform before ME quantizes).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    B = len(shapes)
    P = spec.num_points
    cf = shapes[0][1].shape[1]
    nl = spec.num_levels

    points = np.zeros((B, P, 3), dtype=np.float32)
    point_feats = np.zeros((B, P, cf), dtype=np.float32)
    labels = np.full((B, P), ignore_label, dtype=np.int32)
    point_mask = np.zeros((B, P), dtype=bool)

    coords = [np.zeros((B, spec.level_caps[l], 3), dtype=np.int32)
              for l in range(nl)]
    masks = [np.zeros((B, spec.level_caps[l]), dtype=bool) for l in range(nl)]
    vox_feats = np.zeros((B, spec.level_caps[0], cf), dtype=np.float32)
    num_voxels = [np.zeros(B, dtype=np.int32) for _ in range(nl)]
    dropped = [0 for _ in range(nl)]
    L0 = spec.level_caps[0]
    point_to_voxel = np.full((B, P), B * L0, dtype=np.int32)
    interp_idx = np.full((B, P, 8), B * L0, dtype=np.int32)
    interp_w = np.zeros((B, P, 8), dtype=np.float32)
    kmaps: Dict[str, np.ndarray] = {}
    for m in spec.maps:
        dst_l = m.level + 1 if m.kind == "down" else m.level
        src_l = m.level + 1 if m.kind == "up" else m.level
        if dst_l >= nl or src_l >= nl:
            raise ValueError(
                f"map {m.name} needs level {max(src_l, dst_l)} but spec has "
                f"{nl}")
        Ld, Ls = spec.level_caps[dst_l], spec.level_caps[src_l]
        # np.empty, not np.full: fill_shape writes EVERY [:, b*Ld:(b+1)*Ld]
        # column slice unconditionally (sentinels included via np.where), so
        # a sentinel pre-fill would only touch the pages twice.
        kmaps[m.name] = np.empty((m.num_offsets, B * Ld), dtype=np.int32)

    if use_native is None:
        from csn_tpu_torch.core import native as _native

        use_native = _native.available()
    shape_tables = (_shape_tables_native if use_native
                    else _shape_tables_numpy)
    if use_native:
        from csn_tpu_torch.core.native import globalize_kmap_native \
            as _native_globalize
    else:
        _native_globalize = None

    # Build the per-shape tables in parallel: the C++ engine releases the GIL
    # during its calls, so a thread pool scales across cores and keeps the
    # host pipeline off the training critical path.
    pts_all = []
    for (c, f, lab) in shapes:
        p = min(c.shape[0], P)
        pts_all.append(np.asarray(c[:p], dtype=np.float64) / spec.voxel_size)
    if use_native and B > 1:
        tabs_all = list(_host_pool().map(lambda a: shape_tables(a, spec),
                                         pts_all))
    else:
        tabs_all = [shape_tables(a, spec) for a in pts_all]

    # Per-shape post-processing (quantization reduction, kmap
    # globalization over [K, Ld] tables, interp fixups) writes disjoint
    # [b] slices of the preallocated batch arrays, so it runs in the same
    # pool (numpy releases the GIL on the large-array ops). The RANDOM_
    # SUBSAMPLE draws are taken serially, in b order, BEFORE the parallel
    # section — bit-identical batches vs the serial construction.
    rand_all = None
    if spec.qmode == QMode.RANDOM_SUBSAMPLE:
        rand_all = [rng.random(pts_all[b].shape[0]) for b in range(B)]

    def fill_shape(b):
        c, f, lab = shapes[b]
        p = pts_all[b].shape[0]
        pts = pts_all[b]
        f_p = np.asarray(f[:p])
        lab_p = np.asarray(lab[:p]).reshape(-1)
        tabs = tabs_all[b]
        if spec.sort_points:
            # voxel-sorted point order (see PyramidSpec.sort_points): every
            # per-point array permutes together, so nothing downstream
            # changes semantically
            perm = np.argsort(tabs["p2v"], kind="stable")
            pts = pts[perm]
            f_p = f_p[perm]
            lab_p = lab_p[perm]
            tabs = {**tabs, "p2v": tabs["p2v"][perm],
                    "interp_idx": tabs["interp_idx"][perm],
                    "interp_w": tabs["interp_w"][perm]}
        points[b, :p] = pts.astype(np.float32)
        point_feats[b, :p] = f_p
        labels[b, :p] = lab_p
        point_mask[b, :p] = True

        p2v = tabs["p2v"]
        feats_p = np.asarray(f_p, dtype=np.float32)
        n0_full = tabs["coords"][0].shape[0]
        n0 = min(n0_full, L0)
        drop_b = [n0_full - n0] + [0] * (nl - 1)

        # point -> voxel feature reduction (ME quantization modes)
        if spec.qmode == QMode.UNWEIGHTED_AVERAGE:
            sums = np.zeros((n0_full, cf), dtype=np.float64)
            np.add.at(sums, p2v, feats_p)
            counts = np.bincount(p2v, minlength=n0_full).astype(np.float64)
            vf = (sums / np.maximum(counts, 1.0)[:, None]).astype(np.float32)
        else:  # RANDOM_SUBSAMPLE
            r = rand_all[b]
            best = np.full(n0_full, -1.0)
            np.maximum.at(best, p2v, r)
            best_idx = np.zeros(n0_full, dtype=np.int64)
            hit = r >= best[p2v] - 1e-12
            best_idx[p2v[hit]] = np.nonzero(hit)[0]
            vf = feats_p[best_idx]

        for l in range(nl):
            cl = tabs["coords"][l]
            n_full = cl.shape[0]
            n = min(n_full, spec.level_caps[l])
            if l > 0:
                drop_b[l] = n_full - n
            coords[l][b, :n] = cl[:n]
            masks[l][b, :n] = True
            num_voxels[l][b] = n
        vox_feats[b, :n0] = vf[:n0]

        valid_v = p2v < n0
        point_to_voxel[b, :p] = np.where(valid_v, b * L0 + p2v, B * L0)

        for m in spec.maps:
            dst_l = m.level + 1 if m.kind == "down" else m.level
            src_l = m.level + 1 if m.kind == "up" else m.level
            Ld, Ls = spec.level_caps[dst_l], spec.level_caps[src_l]
            n_src = int(num_voxels[src_l][b])
            local = tabs["kmaps"][m.name]  # [K, Ld] local ids, -1 missing
            if (use_native and local.dtype == np.int32
                    and local.flags.c_contiguous
                    and _native_globalize(local, n_src, b * Ls, B * Ls,
                                          kmaps[m.name], b * Ld)):
                continue
            ok = (local >= 0) & (local < n_src)
            kmaps[m.name][:, b * Ld : (b + 1) * Ld] = np.where(
                ok, b * Ls + local, B * Ls).astype(np.int32)

        li = tabs["interp_idx"][:p]
        lw = tabs["interp_w"][:p]
        ok = (li >= 0) & (li < n0)
        interp_idx[b, :p] = np.where(ok, b * L0 + li, B * L0).astype(np.int32)
        interp_w[b, :p] = np.where(ok, lw, 0.0)
        return drop_b

    if B > 1:
        drops = list(_host_pool().map(fill_shape, range(B)))
    else:
        drops = [fill_shape(b) for b in range(B)]
    for d in drops:
        for l in range(nl):
            dropped[l] += d[l]

    return VoxelBatch(
        points=points,
        point_feats=point_feats,
        labels=labels,
        point_mask=point_mask,
        coords=coords,
        masks=masks,
        vox_feats=vox_feats,
        kmaps=kmaps,
        interp_idx=interp_idx,
        interp_w=interp_w,
        point_to_voxel=point_to_voxel,
        num_voxels=num_voxels,
        dropped=dropped,
    )


map_levels = _map_levels


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

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


def to_torch(vb, device, compact: bool = True) -> TorchVoxelBatch:
    """`VoxelBatch` (host numpy) -> `TorchVoxelBatch` on `device`: int32
    tables and f32 floats, plus the readout's CSR table (`interp_csr`).
    With `compact` (the default, as `VoxelBatch.to_jax`'s), the voxel
    features and the interpolation weights ship as f16 and are widened to
    f32 on the device: the values the JAX package's trainers compute with.
    `compact=False` ships them as f32, as `to_jax(compact=False)`. The JAX
    package's int16 wire coders of the maps are not ported: the tables ship
    as int32 either way (the same values)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def f32(x):
        if compact:
            return t(x.astype(np.float16)).float()
        return t(x.astype(np.float32))

    interp_idx = vb.interp_idx.astype(np.int32)
    ptr, ent = interp_csr(interp_idx, vb.masks[0].size)

    return TorchVoxelBatch(
        points=t(vb.points.astype(np.float32)),
        point_feats=t(vb.point_feats.astype(np.float32)),
        labels=t(vb.labels.astype(np.int32)),
        point_mask=t(vb.point_mask),
        coords=tuple(t(c.astype(np.int32)) for c in vb.coords),
        masks=tuple(t(m) for m in vb.masks),
        vox_feats=f32(vb.vox_feats),
        kmaps={k: t(v.astype(np.int32)) for k, v in vb.kmaps.items()},
        interp_idx=t(interp_idx),
        interp_w=f32(vb.interp_w),
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
