"""The interpolation pair's warp designs against the shipped kernels.

    python -m csn_tpu_torch.tools.interp_designs [--reps N]

On one CUDA card: builds `tools/interp_designs.cu` (a warp per 4 points
for the forward, a group of 8, 16 or 32 lanes per voxel for the backward,
with the weights gathered through the corner table or read from a
voxel-major copy) and times each design against `interp_fwd` and
`interp_bwd` on the corner table of one HRNetSimCSN3S query batch (the A/B
tool's, `conv_ab.interp_table`), at 13, 39 and 256 channels in f32 and
bf16. Prints, per shape, each kernel's device ms per call with a warm L2
and from device memory (`tools/timing.py`), whether its output is bitwise
equal to the shipped kernel's, and the registers ptxas reports. A design
whose lanes cannot hold a row (more than 8 channels per lane) is skipped.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

WIDTHS = (13, 39, 256)
FWD = {0: "warp, 8 lanes/point", 1: "warp, 16 lanes/point",
       2: "warp, 32 lanes/point"}
BWD = {10: "8 lanes/voxel", 11: "16 lanes/voxel", 12: "32 lanes/voxel",
       13: "8 lanes/voxel, vm weights", 14: "16 lanes/voxel, vm weights",
       15: "32 lanes/voxel, vm weights"}
LANES = {10: 8, 11: 16, 12: 32, 13: 8, 14: 16, 15: 32}


def build(tmp: Path):
    """(library, [(kernel, registers)]) of `interp_designs.cu`."""
    from csn_tpu_torch import kernels
    so = tmp / "libinterp_designs.so"
    res = subprocess.run(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(kernels.CSRC), "-shared", "-o", str(so),
         str(Path(__file__).with_name("interp_designs.cu"))],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc interp_designs.cu:\n{res.stderr}")
    regs, name = [], None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.append((name, int(m.group(1))))
            name = None
    lib = ctypes.CDLL(str(so))
    lib.csn_interp_design.argtypes = ([ctypes.c_int] * 2
                                      + [ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    import torch
    from csn_tpu_torch import kernels
    from csn_tpu_torch.core import interp_window
    from csn_tpu_torch.tools.conv_ab import SEED, interp_table
    from csn_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        print("interp_designs: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lib, regs = build(tmp)
        interp_table(tmp / "table.pt")
        tab = {k: v.to(dev) for k, v in torch.load(tmp / "table.pt").items()}
    idx, w8, ptr, ent = tab["idx"], tab["w"], tab["ptr"], tab["ent"]
    n_vox, n_pts = ptr.shape[0] - 1, idx.shape[0]
    vw = w8.reshape(-1)[ent.long()].contiguous()   # voxel-major weights

    def design(which, x):
        c = x.shape[1]
        fwd = which < 10
        out = torch.empty((n_pts if fwd else n_vox, c), dtype=x.dtype,
                          device=dev)
        b, e = (idx, idx) if fwd else (ptr, ent)
        wt = vw if which >= 13 else w8
        code = lib.csn_interp_design(
            which, kernels.dtype_code(x), x.data_ptr(), b.data_ptr(),
            e.data_ptr(), wt.data_ptr(), out.data_ptr(), n_vox, n_pts, c,
            kernels.stream())
        kernels.check(code, f"interp design {which}")
        return out

    def timed(fn):
        return (f"{graph_ms(fn, reps=args.reps) * 1e3:.1f}/"
                f"{graph_ms(fn, reps=args.reps, cold=True) * 1e3:.1f}")

    print(f"[designs] table: {n_vox} voxels, {n_pts} points, {ent.numel()} "
          f"live corners; us per call, warm L2 / from device memory")
    gen = torch.Generator().manual_seed(SEED)
    for c in WIDTHS:
        flat32 = torch.randn(n_vox, c, generator=gen)
        g32 = torch.randn(n_pts, c, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            flat, g = flat32.to(dev, dt), g32.to(dev, dt)
            ref_f = interp_window.interp_fwd(flat, idx, w8)
            ref_b = interp_window.interp_bwd(g, ptr, ent, w8)
            cells = [
                "fwd shipped " + timed(
                    lambda: interp_window.interp_fwd(flat, idx, w8))]
            for which, name in FWD.items():
                same = torch.equal(design(which, flat), ref_f)
                cells.append(f"fwd {name} "
                             + timed(lambda: design(which, flat))
                             + ("" if same else " DIFFERENT BITS"))
            cells.append("bwd shipped " + timed(
                lambda: interp_window.interp_bwd(g, ptr, ent, w8)))
            for which, name in BWD.items():
                if -(-c // LANES[which]) > 8:
                    continue
                same = torch.equal(design(which, g), ref_b)
                cells.append(f"bwd {name} " + timed(lambda: design(which, g))
                             + ("" if same else " DIFFERENT BITS"))
            print(f"[designs] {c} {str(dt)[6:]}: " + " | ".join(cells),
                  flush=True)
    for name, n in regs:
        print(f"[designs registers] {name}: {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
