"""The layouts of the f32 D=64 split-TF32 attention forward against each
other, and the shipped backward by pass.

    python -m csn_tpu_torch.tools.flash_d64_designs [--reps N]

On one CUDA card: builds `tools/flash_d64_designs.cu` (the forward with
Q's A fragments kept in registers or split from the Q tile at every key
tile, P V in groups of 4 or 8 n-tiles) and times each layout at the HRNet
SSA call [16, 4, 5632, 64] and the CSA call [8, 4, 5632, 64] in f32 (valid
rows a prefix of seeded length, as a padded point set), at dropout 0.1 and
0. Prints per call each layout's device ms per call (CUDA graphs, warm L2:
`tools/timing.py`), whether its outputs are bitwise equal to the shipped
layout's (`ops/flash.py`), and the shipped backward's device ms by pass
(dK/dV, dQ) from `torch.profiler`; first the registers and spill bytes
ptxas reports for each layout and for the shipped f32 D=64 kernels of
`csrc/flash_attn.cu` and `csrc/flash_attn_bwd.cu`.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FWD = {0: "Q in registers, P V by 4 n-tiles",
       1: "Q in registers, P V by 8 n-tiles",
       2: "Q split per key tile, P V by 4 n-tiles",
       3: "Q split per key tile, P V by 8 n-tiles"}
SEED, DROPOUT, DROP_SEED = 7, 0.1, 0x5EED


def build(tmp: Path):
    """(library, [(kernel, registers, spill store bytes, spill load
    bytes)]) of `flash_d64_designs.cu`."""
    from csn_tpu_torch import kernels
    so = tmp / "libflash_d64_designs.so"
    res = subprocess.run(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(kernels.CSRC), "-shared", "-o", str(so),
         str(Path(__file__).with_name("flash_d64_designs.cu"))],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc flash_d64_designs.cu:\n{res.stderr}")
    regs, name, spill = [], None, (0, 0)
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.append((name, int(m.group(1)), *spill))
            name = None
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.csn_flash_d64_fwd_design.argtypes = (
        [i] + [p] * 7 + [i] * 4 + [f, ctypes.c_uint64, ctypes.c_uint32, f, i,
                                   p])
    return lib, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from csn_tpu_torch import kernels
    from csn_tpu_torch.ops import flash
    from csn_tpu_torch.tools.conv_ab import registers
    from csn_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        print("flash_d64_designs: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib, regs = build(Path(tmp))
        shipped = [r[:4] for r in registers(kernels.CSRC.parents[1],
                                                 ("flash",))
                   if "tf32_d64" in r[0]]
        for name, r, st, ld in regs + shipped:
            print(f"[designs registers] {name}: {r} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
        gen = torch.Generator().manual_seed(SEED)

        def prefix(b, L):
            n = torch.randint(L // 2, L + 1, (b,), generator=gen)
            return (torch.arange(L)[None, :] < n[:, None]).to(dev)

        L, temp = 5632, 8.0
        ssa = prefix(16, L)
        calls = (("SSA", ssa, ssa), ("CSA", prefix(8, L), prefix(8, L)))
        for tag, qm, km in calls:
            b = qm.shape[0]
            q, k, v, g = (torch.randn(b, 4, L, 64, generator=gen).to(dev)
                          for _ in range(4))
            g = g * qm[:, None, :, None]
            st = kernels.stream
            for drop in (DROPOUT, 0.0):
                sd, thresh, inv_keep, on = flash._drop_args(
                    drop, DROP_SEED if drop else None)
                out, lse = flash.flash_attention(q, k, v, km, qm, temp, drop,
                                                 DROP_SEED if drop else None)
                delta = (g * out).sum(dim=-1)
                shape = f"{tag} [{b},4,{L},64] f32 dropout {drop}"
                for var, what in FWD.items():
                    o2, l2 = torch.empty_like(out), torch.empty_like(lse)

                    def fwd():
                        kernels.check(lib.csn_flash_d64_fwd_design(
                            var, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            km.data_ptr(), qm.data_ptr(), o2.data_ptr(),
                            l2.data_ptr(), b, 4, L, L, 1.0 / temp, sd,
                            thresh, inv_keep, on, st()), "fwd design")

                    fwd()
                    same = torch.equal(o2, out) and torch.equal(l2, lse)
                    ms = graph_ms(fwd, calls=5, reps=args.reps)
                    print(f"[designs] {shape} forward {var} ({what}): "
                          f"{ms:.4f} ms, bitwise the shipped {same}")
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        flash.flash_attention_bwd(
                            q, k, v, g, lse, delta, km, qm, temp, drop,
                            DROP_SEED if drop else None)
                    torch.cuda.synchronize()
                passes = {re.search(r"flash_\w+", e.key).group(0):
                          e.device_time_total / 1e3 / 3
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "flash_" in e.key}
                print(f"[designs] {shape} shipped backward by pass "
                      f"(profiler, ms per call): " + ", ".join(
                          f"{n} {ms:.4f}" for n, ms in passes.items()))
            del q, k, v, g
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
