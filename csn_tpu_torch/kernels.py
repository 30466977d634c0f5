"""Build and load the port's CUDA kernels, and count their launches.

Each `.cu` source under `csn_tpu_torch/csrc/` compiles with its own `nvcc`,
all started together, and one more `nvcc` links the objects into a shared
library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <build>/<name>.o   (each)
    nvcc -shared -o <build>/libcsn_tpu_torch_kernels.so <build>/*.o

The build runs at the first kernel call (never at import: the CPU tests
import every module), lands in `csn_tpu_torch/_build/` (git-ignored), and
reruns when a source is newer than the library. The launchers take raw
device pointers, sizes and a `cudaStream_t`, and return the CUDA error code
of the launch; `check` turns a nonzero code into an exception.

`LAUNCHES` counts, per kernel, the launches its wrapper made. A wrapper adds
one right after its kernel launched and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_PATH = BUILD_DIR / "libcsn_tpu_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# dtype codes of the C launchers (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# sparse_conv_fwd counts the forward convs and the backward d_feats convs
# (the same kernel over the transpose map)
LAUNCHES = {"sparse_conv_fwd": 0, "sparse_conv_dw": 0, "flash_attn_fwd": 0,
            "flash_attn_bwd": 0, "flash_attn_carry": 0,
            "flash_attn_block_bwd": 0, "interp_fwd": 0, "interp_bwd": 0,
            "sparse_conv_im2col_fwd": 0, "sparse_conv_im2col_bwd": 0,
            "probe_window_gather": 0, "probe_gather_accum": 0,
            "probe_slot_load": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_SIGNATURES = {
    # dtype, feats, kmap, w, out, n_in, n_out, n_off, cin, cout, stream
    "csn_sparse_conv_fwd": [_I, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P],
    # dtype, feats, g, kmap_t, part, out, n_in, n_g, n_off, cin, cout,
    # n_split, stream
    "csn_sparse_conv_dw": [_I, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I,
                           _I, _P],
    # dtype, feats, kmap, w, out, n_in, n_out, n_off, cin, cout, stream
    "csn_sparse_conv_im2col_fwd": [_I, _P, _P, _P, _P, _I64, _I64, _I, _I, _I,
                                   _P],
    # dtype, feats, g, kmap_t, wt, dfeats, part, out, n_in, n_g, n_off, cin,
    # cout, n_split, dw_only, stream
    "csn_sparse_conv_im2col_bwd": [_I] + [_P] * 7 + [_I64, _I64] + [_I] * 5
                                  + [_P],
    # dtype, q, k, v, kv_mask, q_mask, out, lse, B, H, Lq, Lk, D, inv_temp,
    # seed, thresh, inv_keep, use_drop, stream
    "csn_flash_attn_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _U64, _U32, _F, _I, _P],
    # dtype, q, k, v, dout, lse, delta, kv_mask, q_mask, dq, dk, dv, B, H,
    # Lq, Lk, D, inv_temp, seed, thresh, inv_keep, use_drop, stream
    "csn_flash_attn_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _F, _U64, _U32, _F, _I, _P],
    # dtype, q, k, v, kv_mask, q_mask, m_in, l_in, acc_in, m_out, l_out,
    # acc_out, B, H, Lq, Lk, D, inv_temp, seed, thresh, inv_keep, use_drop,
    # row_off, col_off, stream
    "csn_flash_attn_carry": [_I] + [_P] * 11 + [_I] * 5 + [
        _F, _U64, _U32, _F, _I, _I, _I, _P],
    # dtype, q, k, v, dout, lse, delta, kv_mask, q_mask, dq (f32), dk, dv,
    # B, H, Lq, Lk, D, inv_temp, seed, thresh, inv_keep, use_drop, row_off,
    # col_off, stream
    "csn_flash_attn_block_bwd": [_I] + [_P] * 11 + [_I] * 5 + [
        _F, _U64, _U32, _F, _I, _I, _I, _P],
    # dtype, flat, idx, w, out, n_vox, n_pts, c, stream
    "csn_interp_fwd": [_I, _P, _P, _P, _P, _I64, _I64, _I, _P],
    # dtype, g, ptr, ent, w, dflat, n_vox, c, stream
    "csn_interp_bwd": [_I, _P, _P, _P, _P, _P, _I64, _I, _P],
    # dtype, layout, win, rel, out, W, T, C, stream
    "csn_probe_window_gather": [_I, _I, _P, _P, _P, _I, _I, _I, _P],
    # dtype, mode, rows, win, out, n_tiles, K, W, T, C, stream
    "csn_probe_gather_accum": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # variant, x, out, stream
    "csn_probe_slot_load": [_I, _P, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(force: bool = False) -> float:
    """Compile the library if it is missing or older than a source. Returns
    the seconds spent compiling (0.0 when the library was current)."""
    srcs = sources()
    if (not force and LIB_PATH.exists() and LIB_PATH.stat().st_mtime
            >= max(s.stat().st_mtime for s in srcs)):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, proc in procs:  # wait for every compiler before raising
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    tmp = LIB_PATH.with_suffix(f".{tag}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a reader never sees half a library
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.csn_error_string.argtypes = [ctypes.c_int]
            lib.csn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = library().csn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"kernels take float32 or bfloat16, got {t.dtype}") from None


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Wrapper precondition: every tensor contiguous and on the current CUDA
    device (the launch goes to that device's current stream)."""
    for t in tensors:
        if not t.is_cuda or t.device.index != torch.cuda.current_device():
            raise ValueError(f"{what}: tensors must be on the current CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
