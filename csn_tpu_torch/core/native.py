"""ctypes binding for the port's native host engine
(`csn_tpu_torch/csrc/coords.cpp`).

The port's own copy of `csn_tpu/core/native.py`. The library is compiled
with the host C++ compiler at first use into the git-ignored
`csn_tpu_torch/_build/`; when no compiler is found or the build fails,
`available()` is false and `core/pyramid.py` takes its pure-numpy path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "coords.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SO = _BUILD_DIR / "libcsn_tpu_torch_coords.so"

CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

KIND = {"same": 0, "down": 1, "up": 2}


def _build() -> bool:
    """Compile the engine; False when there is no compiler or it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)  # atomic: a reader never sees half a library
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    # rebuild on source changes too: a stale library with an old C ABI
    # would be called with the new argtypes (silent corruption)
    stale = (not _SO.exists()
             or _SRC.stat().st_mtime > _SO.stat().st_mtime)
    if stale and not _build():
        return None
    lib = ctypes.CDLL(str(_SO))
    lib.csn_shape_create.restype = ctypes.c_void_p
    lib.csn_shape_create.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32]
    lib.csn_shape_num_voxels.restype = ctypes.c_int64
    lib.csn_shape_num_voxels.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.csn_shape_coords.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    lib.csn_shape_p2v.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.csn_shape_kernel_map.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.csn_shape_interp.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.csn_shape_destroy.argtypes = [ctypes.c_void_p]
    lib.csn_globalize_kmap.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


class NativeShape:
    """One shape's coordinate pyramid built in C++."""

    def __init__(self, points: np.ndarray, n_levels: int):
        lib = _load()
        assert lib is not None
        self.lib = lib
        pts = np.ascontiguousarray(points, dtype=np.float32)
        self.n_points = pts.shape[0]
        self.n_levels = n_levels
        self.handle = lib.csn_shape_create(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_points, n_levels)
        if not self.handle:
            raise ValueError(
                "csn_shape_create rejected the point set: a coordinate is "
                "non-finite or |c| >= 2^20 voxel units (the packed 21-bit "
                "key lanes would alias) — check voxel_size and the dataset "
                "for outlier/NaN points")

    def num_voxels(self, level: int) -> int:
        return int(self.lib.csn_shape_num_voxels(self.handle, level))

    def coords(self, level: int, cap: int) -> np.ndarray:
        n = min(self.num_voxels(level), cap)
        out = np.zeros((max(n, 1), 3), dtype=np.int32)
        self.lib.csn_shape_coords(
            self.handle, level,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return out[:n]

    def p2v(self) -> np.ndarray:
        out = np.zeros(self.n_points, dtype=np.int32)
        self.lib.csn_shape_p2v(
            self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def kernel_map(self, kind: str, level: int, ksize: int,
                   cap_dst: int) -> np.ndarray:
        K = ksize ** 3
        out = np.empty((K, cap_dst), dtype=np.int32)
        self.lib.csn_shape_kernel_map(
            self.handle, KIND[kind], level, ksize, cap_dst,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def interp(self) -> tuple:
        idx = np.empty((self.n_points, 8), dtype=np.int32)
        w = np.empty((self.n_points, 8), dtype=np.float32)
        self.lib.csn_shape_interp(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return idx, w

    def __del__(self):
        try:
            self.lib.csn_shape_destroy(self.handle)
        except Exception:
            pass


def globalize_kmap_native(local: np.ndarray, n_src: int, add: int, sent: int,
                          out: np.ndarray, col0: int) -> bool:
    """Fused C++ form of fill_shape's kmap globalization: write
    `out[:, col0:col0+Ld] = where(0 <= local < n_src, add + local, sent)`
    in one GIL-released pass (csrc csn_globalize_kmap). Returns False when
    the native engine lacks the symbol (caller runs the numpy form).
    `local` must be int32 [K, Ld]; `out` int32 C-contiguous [K, W]."""
    lib = _load()
    if lib is None:
        return False
    assert local.dtype == np.int32 and local.flags.c_contiguous
    assert out.dtype == np.int32 and out.flags.c_contiguous
    k, ld = local.shape
    base = out.ctypes.data + col0 * 4
    lib.csn_globalize_kmap(
        local.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        k, ld, n_src, add, sent,
        ctypes.cast(base, ctypes.POINTER(ctypes.c_int32)), out.shape[1])
    return True
