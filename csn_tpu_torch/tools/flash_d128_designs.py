"""The other layouts of the f32 D=128 split-TF32 attention bodies against
the shipped ones.

    python -m csn_tpu_torch.tools.flash_d128_designs [--reps N]

On one CUDA card: builds `tools/flash_d128_designs.cu` (the shipped
forward's layout, 4 warps of 16 rows over the whole head with Q split at
every k-step, with P V by 8 n-tiles or with 64-key tiles; the D=256 body of
`csrc/flash_tf32_fwd.cuh` at half the width, whose warps split D; and a dQ
pass that recomputes S, dP and dS instead of reading dS^T from the
scratch) and times them at the HRNet SSA call [16, 2, 5632, 128] and the
CSA call [8, 2, 5632, 128] in f32 (valid rows a prefix of seeded length,
as a padded point set), at dropout 0.1 and 0, beside the shipped bodies
(`ops/flash.py`: `csrc/flash_tf32_d128_fwd.cuh` and
`csrc/flash_tf32_bwd.cuh` at head dim 128). Prints per call each forward
layout's device ms per call (CUDA graphs, warm L2: `tools/timing.py`),
timed twice in turns (shipped, variants, the variants backwards, shipped,
so that a drift over the run shows), its outputs' largest difference from
the shipped body's as a share of max|shipped|, the recomputing dQ pass's
ms and its difference from the shipped dQ, the
shipped backward's device ms by pass (dK/dV with the dS^T scratch writes,
dQ from the scratch) from `torch.profiler`, and the least time of the
scratch's writes and reads at 3.35 TB/s; first the registers and spill
bytes ptxas reports for each layout and for the shipped D=128 kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

FWD = {0: "rows over the whole head, 32-key tiles, P V by 8 n-tiles",
       1: "rows over the whole head, 64-key tiles, P V by 8 n-tiles",
       2: "the D=256 body at half the width: warps split D, S exchanged"}
SEED, DROPOUT, DROP_SEED = 7, 0.1, 0x5EED
HBM_BYTES_S = 3.35e12


def build(tmp: Path):
    """(library, [(kernel, registers, spill store bytes, spill load
    bytes)]) of the design kernels of `flash_d128_designs.cu` (the
    headers' kernels it also compiles left out)."""
    from csn_tpu_torch import kernels
    so = tmp / "libflash_d128_designs.so"
    res = subprocess.run(
        [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(kernels.CSRC), "-shared", "-o", str(so),
         str(Path(__file__).with_name("flash_d128_designs.cu"))],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc flash_d128_designs.cu:\n{res.stderr}")
    filt = shutil.which("cu++filt", path=str(Path(kernels.nvcc()).parent))
    regs, name, spill = [], None, (0, 0)
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            if "d128_designs" not in name.split("GLOBAL")[0]:
                name = None
            elif filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip()
                name = name.split("(")[0].split("::")[-1]
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
    drop = [f, ctypes.c_uint64, ctypes.c_uint32, f, i, p]
    lib.csn_flash_d128_fwd_design.argtypes = [i] + [p] * 7 + [i] * 4 + drop
    lib.csn_flash_d128_dq_recompute.argtypes = [p] * 9 + [i] * 4 + drop
    return lib, regs


def rel(got, ref) -> float:
    """max|got - ref| / max|ref|"""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)


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
        print("flash_d128_designs: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib, regs = build(Path(tmp))
        shipped = [r[:4] for r in registers(kernels.CSRC.parents[1],
                                                 ("flash",))
                   if "tf32_d128" in r[0]
                   or ("<128" in r[0] and "tf32" in r[0])]
        for name, r, st, ld in regs + shipped:
            print(f"[designs registers] {name}: {r} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
        gen = torch.Generator().manual_seed(SEED)

        def prefix(b, L):
            n = torch.randint(L // 2, L + 1, (b,), generator=gen)
            return (torch.arange(L)[None, :] < n[:, None]).to(dev)

        L, d, h = 5632, 128, 2
        temp = float(d) ** 0.5
        ssa = prefix(16, L)
        calls = (("SSA", ssa, ssa), ("CSA", prefix(8, L), prefix(8, L)))
        st = kernels.stream
        for tag, qm, km in calls:
            b = qm.shape[0]
            q, k, v, g = (torch.randn(b, h, L, d, generator=gen).to(dev)
                          for _ in range(4))
            g = g * qm[:, None, :, None]
            scratch_ms = 2 * b * h * L * L * 4 / HBM_BYTES_S * 1e3
            for drop in (DROPOUT, 0.0):
                seed = DROP_SEED if drop else None
                sd, thresh, inv_keep, on = flash._drop_args(drop, seed)
                shape = f"{tag} [{b},{h},{L},{d}] f32 dropout {drop}"
                out, lse = flash.flash_attention(q, k, v, km, qm, temp, drop,
                                                 seed)
                delta = (g * out).sum(dim=-1)
                layouts = {"shipped": (
                    "rows over the whole head, 32-key tiles, P V by 4 "
                    "n-tiles", lambda: flash.flash_attention(
                        q, k, v, km, qm, temp, drop, seed), "")}
                valid = qm[:, None, :]
                for var, what in FWD.items():
                    o2, l2 = torch.empty_like(out), torch.empty_like(lse)

                    def fwd(var=var, o2=o2, l2=l2):
                        kernels.check(lib.csn_flash_d128_fwd_design(
                            var, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            km.data_ptr(), qm.data_ptr(), o2.data_ptr(),
                            l2.data_ptr(), b, h, L, L, 1.0 / temp, sd,
                            thresh, inv_keep, on, st()), "fwd design")

                    fwd()
                    e_out = rel(o2 * valid[..., None], out * valid[..., None])
                    e_lse = rel(torch.where(valid, l2, 0.0),
                                torch.where(valid, lse, 0.0))
                    layouts[var] = (what, fwd, f", vs the shipped out "
                                    f"{e_out:.2e}, lse {e_lse:.2e} of "
                                    f"max|shipped|")
                order = list(layouts)
                times = {n: [] for n in order}
                for n in order + order[::-1]:
                    times[n].append(graph_ms(layouts[n][1], calls=5,
                                             reps=args.reps))
                for n in order:
                    what, _, diff = layouts[n]
                    print(f"[designs] {shape} forward {n} ({what}): "
                          + " / ".join(f"{t:.4f}" for t in times[n])
                          + f" ms (in turns){diff}")
                dq, dk, dv = flash.flash_attention_bwd(
                    q, k, v, g, lse, delta, km, qm, temp, drop, seed)
                ms = graph_ms(lambda: flash.flash_attention_bwd(
                    q, k, v, g, lse, delta, km, qm, temp, drop, seed),
                    calls=5, reps=args.reps)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        flash.flash_attention_bwd(q, k, v, g, lse, delta, km,
                                                  qm, temp, drop, seed)
                    torch.cuda.synchronize()
                passes = {re.search(r"flash_\w+", e.key).group(0):
                          e.device_time_total / 1e3 / 3
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "flash_" in e.key}
                dq2 = torch.empty_like(dq)

                def dq_pass():
                    kernels.check(lib.csn_flash_d128_dq_recompute(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        km.data_ptr(), qm.data_ptr(), dq2.data_ptr(), b, h, L,
                        L, 1.0 / temp, sd, thresh, inv_keep, on, st()),
                        "dq design")

                dq_pass()
                vq = qm[:, None, :, None]
                e_dq = rel(dq2 * vq, dq * vq)
                rms = graph_ms(dq_pass, calls=5, reps=args.reps)
                print(f"[designs] {shape} backward shipped {ms:.4f} ms (CUDA "
                      f"graphs); by pass (profiler, ms per call): "
                      + ", ".join(f"{n} {t:.4f}" for n, t in passes.items())
                      + f"; the dS^T scratch's write and read at 3.35 TB/s: "
                      f"at least {scratch_ms:.4f} ms")
                print(f"[designs] {shape} dQ pass recomputing S, dP and dS "
                      f"(32-key tiles): {rms:.4f} ms, vs the shipped dq "
                      f"{e_dq:.2e} of max|shipped|")
            del q, k, v, g
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
