"""Designs of the f32 im2col backward's split-TF32 body against the shipped
one, at HRNetSimCSN3S's real maps.

    python -m csn_tpu_torch.tools.im2col_bwd_designs [--reps N]

On one CUDA card: builds `csrc/sparse_conv_im2col_bwd.cu` as shipped and
in each variant of VARIANTS (a text substitution of the shipped source,
each into a library of its own, all `nvcc` runs started together), then
runs the backward of every conv of one HRNetSimCSN3S train step (the dW
and d_feats of each (map, Cin, Cout), dW only at the stem) on the maps of
one request at the chip_smoke.py protocol (8 query and 8 key shapes of
10000 points, voxel 0.05, level-0 cap 5632, k5 stem), seeded f32 inputs.
Prints per conv each design's device ms per call (CUDA graphs of 5 calls,
warm L2: `tools/timing.py`) and whether its dW and d_feats are bitwise
equal to the shipped body's, beside the bf16 body and the K1 form in f32
(`conv_bwd_kernels`: d_feats on K1 plus `sparse_conv_dw`) on the same
inputs; then each design's sum over the train step, and first the
registers and spill bytes ptxas reports for each design's split-TF32
kernels. The variants:

* `dw_unroll_4`: the dW loop over a super-tile's k-steps unrolled by 4,
  not 8;
* `skip_dfeats`, `skip_dw_ksteps`, `skip_dw_groups`, `skip_both`: the
  gathering warps record per stage which rows of their piece are live
  (warp ballots of the map entries); d_feats then skips an m16 tile of a
  warp's rows without a live row at the k-step's offset (K1's f32 rule),
  dW a k-step of 8 rows without a live row at an n8 block's offset, or a
  group of 32 such rows; `skip_both` the first two.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / \
    "sparse_conv_im2col_bwd.cu"
SHAPES, POINTS, SEED = 8, 10000, 0

# the live masks: NST stages x 8 warps x 8 words of 32 rows, written by the
# gathering warps, read after the step's barrier
MASKS = [
    ("""  static constexpr int F_ELEMS = SR * LDF;
  // NST stages (GG, WT), one feats tile
  static constexpr size_t SMEM =
      sizeof(float) * (NST * STAGE_ELEMS + F_ELEMS);
};
""", """  static constexpr int F_ELEMS = SR * LDF;
  static constexpr int MASK_WORDS = NWARPS * RPL;
  static constexpr size_t SMEM =
      sizeof(float) * (NST * STAGE_ELEMS + F_ELEMS) +
      sizeof(uint32_t) * NST * MASK_WORDS;
};

template <int MT, int NB, int LDW>
__device__ __forceinline__ void dfeats_kstep(float (&acc)[2][NB][4],
                                             const float* gs, const float* ws,
                                             int ks, int warp, int c0, int cin,
                                             int g, int t) {
  FragA a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(MT >> i & 1)) continue;
    const float* p = gs + (32 * warp + 16 * i + g) * LDT + ks * 8 + 2 * t;
    csn_tf32::split_a(a[i], csn_tf32::ld2(p), csn_tf32::ld2(p + 8 * LDT));
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    if (c0 + 8 * nb >= cin) break;
    const float* q = ws + (ks * 8 + 2 * t) * LDW + 8 * nb + g;
    FragB b;
    split(q[0], b.hi[0], b.lo[0]);
    split(q[LDW], b.hi[1], b.lo[1]);
    float p[2][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) mma_tf32(p[i], a[i].lo, b.hi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) mma_tf32(p[i], a[i].hi, b.lo);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1) mma_tf32(p[i], a[i].hi, b.hi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (MT >> i & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nb][e] += p[i][e];
  }
}
"""),
    ("""  float* fs = stages + NST * Tl::STAGE_ELEMS;  // [SR][LDF]
""", """  float* fs = stages + NST * Tl::STAGE_ELEMS;  // [SR][LDF]
  uint32_t* masks = reinterpret_cast<uint32_t*>(fs + Tl::F_ELEMS);
"""),
    ("""      cp_async16(gs + (lane + 32 * q) * LDT + 4 * warp,
                 g + (ok ? (int64_t)v * cout + d : 0), ok);
    }
""", """      cp_async16(gs + (lane + 32 * q) * LDT + 4 * warp,
                 g + (ok ? (int64_t)v * cout + d : 0), ok);
      const uint32_t live = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) masks[st * Tl::MASK_WORDS + warp * RPL + q] = live;
    }
"""),
    ("""    const float* ws = gs + Tl::G_ELEMS;
""", """    const float* ws = gs + Tl::G_ELEMS;
    const uint32_t* mk = masks + st * Tl::MASK_WORDS;
"""),
]

DFEATS_LOOP = re.compile(
    r"      for \(int ks = 0; ks < TBJ / 8; \+\+ks\) \{\n"
    r"        if \(ks >= nks\) break;\n.*?\n      \}\n    \}\n", re.S)
SKIP_DFEATS = """      for (int ks = 0; ks < TBJ / 8; ++ks) {
        if (ks >= nks) break;
        const uint32_t live = mk[2 * ks * RPL + warp];
        const int mt = (live & 0xffffu ? 1 : 0) | (live >> 16 ? 2 : 0);
        if (mt == 3)
          dfeats_kstep<3, NB, LDW>(dacc, gs, ws, ks, warp, c0, cin, gq, t4);
        else if (mt == 1)
          dfeats_kstep<1, NB, LDW>(dacc, gs, ws, ks, warp, c0, cin, gq, t4);
        else if (mt == 2)
          dfeats_kstep<2, NB, LDW>(dacc, gs, ws, ks, warp, c0, cin, gq, t4);
      }
    }
"""
DW_LOOP = re.compile(
    r"#pragma unroll 8\n      for \(int ks = 0; ks < SR / 8; \+\+ks\) \{\n"
    r".*?\n      \}\n(?=#pragma unroll\n      for \(int n = 0; n < DW_NB)",
    re.S)
DW_BODY = """          const float* fa = fs + (ks * 8 + t4) * LDF + 16 * wm + gq;
          FragA a;
          split(fa[0], a.hi[0], a.lo[0]);
          split(fa[8], a.hi[1], a.lo[1]);
          split(fa[4 * LDF], a.hi[2], a.lo[2]);
          split(fa[4 * LDF + 8], a.hi[3], a.lo[3]);
          const float* gb = gs + (ks * 8 + t4) * LDT + colw + gq;
#pragma unroll
          for (int n = 0; n < DW_NB; ++n) {
            if (!LIVE_N) continue;
            FragB b;
            split(gb[8 * n], b.hi[0], b.lo[0]);
            split(gb[4 * LDT + 8 * n], b.hi[1], b.lo[1]);
            float p[4] = {};
            mma_tf32(p, a.lo, b.hi);
            mma_tf32(p, a.hi, b.lo);
            mma_tf32(p, a.hi, b.hi);
#pragma unroll
            for (int e = 0; e < 4; ++e) wacc[n][e] += p[e];
          }
"""
# rows 8 ks .. 8 ks + 7 of the super-tile at block n's offset: warp
# (colw + 8 n) / 4's piece, word ks / 4, byte ks % 4
SKIP_DW_KSTEPS = """      const uint32_t* lv = mk + (colw / 4) * RPL;
#pragma unroll 2
      for (int q = 0; q < RPL; ++q) {
        uint32_t live[DW_NB];
        uint32_t any = 0;
#pragma unroll
        for (int n = 0; n < DW_NB; ++n) any |= live[n] = lv[2 * n * RPL + q];
        if (!any) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * q + kk;
          if (!(any >> (8 * kk) & 0xffu)) continue;
""" + DW_BODY.replace("LIVE_N", "(live[n] >> (8 * kk) & 0xffu)") + """        }
      }
"""
SKIP_DW_GROUPS = """      const uint32_t* lv = mk + (colw / 4) * RPL;
#pragma unroll 2
      for (int q = 0; q < RPL; ++q) {
        uint32_t live[DW_NB];
        uint32_t any = 0;
#pragma unroll
        for (int n = 0; n < DW_NB; ++n) any |= live[n] = lv[2 * n * RPL + q];
        if (!any) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * q + kk;
""" + DW_BODY.replace("LIVE_N", "live[n]") + """        }
      }
"""


def variant(name: str, text: str) -> str:
    """The shipped source `text` with VARIANTS' substitutions `name`."""
    def sub(pattern, new):
        out, n = pattern.subn(lambda _: new, text, count=1)
        if n != 1:
            raise RuntimeError(f"{name}: the shipped source has changed")
        return out

    if name == "dw_unroll_4":
        old = "#pragma unroll 8\n      for (int ks = 0; ks < SR / 8; ++ks) {"
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the shipped source has changed")
        return text.replace(old, old.replace("unroll 8", "unroll 4"))
    for old, new in MASKS:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the shipped source has changed")
        text = text.replace(old, new)
    if name in ("skip_dfeats", "skip_both"):
        text = sub(DFEATS_LOOP, SKIP_DFEATS)
    if name in ("skip_dw_ksteps", "skip_both"):
        text = sub(DW_LOOP, SKIP_DW_KSTEPS)
    if name == "skip_dw_groups":
        text = sub(DW_LOOP, SKIP_DW_GROUPS)
    return text


VARIANTS = ("shipped", "dw_unroll_4", "skip_dfeats", "skip_dw_ksteps",
            "skip_dw_groups", "skip_both")


def build(tmp: Path) -> dict:
    """{design: (entry point, [(kernel, registers, spill store bytes, spill
    load bytes)])}, each design in a library of its own."""
    from csn_tpu_torch import kernels
    text = SOURCE.read_text()
    procs = {}
    for name in VARIANTS:
        src = tmp / f"{name}.cu"
        src.write_text(text if name == "shipped" else variant(name, text))
        procs[name] = subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(SOURCE.parent), "-shared", "-o", str(tmp / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        regs, kern = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kern = m.group(1) if "tf32_kernel" in m.group(1) else None
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kern:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kern:
                mc = re.search(r"kernelILi(\d+)E", kern).group(1)
                regs.append((f"im2col_bwd_tf32_kernel<{mc}>",
                             int(m.group(1)), *spill))
                kern = None
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        fn = lib.csn_sparse_conv_im2col_bwd
        fn.argtypes = kernels._SIGNATURES["csn_sparse_conv_im2col_bwd"]
        fn.restype = ctypes.c_int
        out[name] = (fn, sorted(regs))
    return out


def convs(dev):
    """[(map, Cin, Cout, convs per step, kmap_t, n_in, n_g, mirror, stem)]
    of HRNetSimCSN3S's train step on one request's maps."""
    import numpy as np
    from csn_tpu_torch.core import conv
    from csn_tpu_torch.core.pyramid import concat_batches, map_levels, \
        to_torch
    from csn_tpu_torch.data import pipeline
    from csn_tpu_torch.data.synthetic import make_surface_shape
    from csn_tpu_torch.models import load_model
    from csn_tpu_torch.models.layers import SparseConv

    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=POINTS, voxel_size=0.05, conv1_kernel_size=5,
        level0_cap=5632, shrink=3.0)
    rng = np.random.default_rng(SEED)
    big = concat_batches([to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, POINTS) for _ in range(SHAPES)], spec,
        rng=rng), dev) for _ in range(2)])
    model = cls(out_channels=39, conv1_kernel_size=5,
                compute_dtype="float32", d_model=256, n_head=4,
                k_neighbors=1)
    count = {}
    for m in model.modules():
        if isinstance(m, SparseConv):
            key = (m.map_name, *m.kernel.shape[1:])
            count[key] = count.get(key, 0) + 1
    stem = (model.conv0.map_name, *model.conv0.kernel.shape[1:])
    out = []
    for (name, cin, cout), n in sorted(count.items()):
        t_name, mirror = conv.transpose_map_name(name)
        kmap = big.kmaps[name]
        out.append((name, cin, cout, n, big.kmaps[t_name],
                    big.masks[map_levels(name)[0]].numel(), kmap.shape[1],
                    mirror, (name, cin, cout) == stem))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from csn_tpu_torch.core import conv, window_conv
    from csn_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("im2col_bwd_designs: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory() as tmp:
        designs = build(Path(tmp))
        for name, (_, regs) in designs.items():
            for kern, r, st, ld in regs:
                print(f"[designs] {name} {kern}: {r} registers, {st} bytes "
                      f"spill stores, {ld} bytes spill loads")
        gen = torch.Generator().manual_seed(SEED)
        total = {name: 0.0 for name in (*designs, "bf16", "K1 form f32")}
        for (name, cin, cout, n, kmap_t, n_in, n_g, mirror,
             stem) in convs(dev):
            k = kmap_t.shape[0]
            f = torch.randn(n_in, cin, generator=gen).to(dev)
            gd = torch.randn(n_g, cout, generator=gen).to(dev)
            w = ((torch.rand(k, cin, cout, generator=gen) * 2 - 1)
                 / (cin * k) ** 0.5).to(dev)
            wt = None if stem else conv.stack_pair_transposed(
                w.flip(0) if mirror else w).contiguous()
            s = window_conv.im2col_bwd_tc_splits(
                n_in, k, cin, cout, 256, 16 if cin <= 16 else 64)
            part = torch.empty((s, cin, k * cout), device=dev)
            out = part[0] if s == 1 else torch.empty_like(part[0])
            df = None if stem else torch.empty_like(f)

            def call(fn):
                code = fn(0, f.data_ptr(), gd.data_ptr(), kmap_t.data_ptr(),
                          0 if stem else wt.data_ptr(),
                          0 if stem else df.data_ptr(), part.data_ptr(),
                          out.data_ptr(), n_in, n_g, k, cin, cout, s,
                          int(stem), torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")

            live = float((kmap_t < n_g).float().mean())
            line = (f"[designs] {name} {cin}->{cout} x{n} N_in={n_in} live "
                    f"{live:.3f} S={s}:")
            ref = None
            for dname, (fn, _) in designs.items():
                call(fn)
                got = (out.clone(), None if stem else df.clone())
                if ref is None:
                    ref = got
                same = torch.equal(got[0], ref[0]) and (
                    stem or torch.equal(got[1], ref[1]))
                ms = graph_ms(lambda: call(fn), calls=5, reps=args.reps)
                total[dname] += n * ms
                line += (f" {dname} {ms:.4f}"
                         f"{'' if same else ' (bits differ)'},")
            fb, gb = f.bfloat16(), gd.bfloat16()
            for rname, fn in (
                    ("bf16", lambda: conv.conv_im2col_bwd_kernels(
                        fb, gb, kmap_t, w, mirror, not stem)),
                    ("K1 form f32", lambda: conv.conv_bwd_kernels(
                        f, gd, kmap_t, w, mirror, not stem))):
                ms = graph_ms(fn, calls=5, reps=args.reps)
                total[rname] += n * ms
                line += f" {rname} {ms:.4f},"
            print(line.rstrip(",") + " ms per call")
            torch.cuda.empty_cache()
        print("[designs] sums over one HRNetSimCSN3S train step, device ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in total.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
