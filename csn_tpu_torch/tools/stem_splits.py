"""The k5 stems' conv kernels at their real maps on one CUDA card: K1's
flattened steps and `sparse_conv_dw`'s narrow body, in f32 (split TF32)
and bf16, with the narrow body timed at several row splits S.

    python -m csn_tpu_torch.tools.stem_splits [--splits 8,13,20,26,39,52,64]

The maps are those of HRNetSimCSN3S's stem (same0k5, 125 offsets) at the
chip_smoke.py protocol (8 shapes of 10000 points, voxel 0.05, level-0 cap
5632, k5 stem): the combined pass's 16 shapes (90112 level-0 rows, the
HRNet stem) and one batch of 8 (45056 rows, Res16UNet34C's stem at its
batch). Inputs are seeded; Cin 3 -> Cout 32. Each line gives the device ms
per call from CUDA graphs (warm L2, `tools/timing.py`), and each result's
error against a float64 reference of the same operands as a share of
max|ref| (the f32 bodies are held to 1e-4 in chip_smoke.py). `S` forces the
splits that `window_conv.dw_splits` would pick; the line marked `(dw_splits)`
is the wrapper's own choice.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from csn_tpu_torch import kernels
from csn_tpu_torch.core import conv, window_conv
from csn_tpu_torch.core.pyramid import concat_batches, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.data.synthetic import make_surface_shape
from csn_tpu_torch.models import load_model
from csn_tpu_torch.tools.timing import graph_ms

SHAPES, POINTS, SEED = 8, 10000, 0
STEM = "same0k5"


def stem_maps(dev):
    """{level-0 rows: (kmap, kmap_t)} of the stem at one and two batches."""
    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=POINTS, voxel_size=0.05,
        conv1_kernel_size=5, level0_cap=5632, shrink=3.0)
    rng = np.random.default_rng(SEED)
    one, two = (to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, POINTS) for _ in range(SHAPES)], spec,
        rng=rng), dev) for _ in range(2))
    out = {}
    for b in (concat_batches([one, two]), one):
        kmap = b.kmaps[STEM]
        t_name, _ = conv.transpose_map_name(STEM)
        out[kmap.shape[1]] = (kmap, b.kmaps[t_name])
    return out


def rel_err(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="8,13,20,26,39,52,64")
    args = ap.parse_args(argv)
    splits = [int(s) for s in args.splits.split(",")]
    if not torch.cuda.is_available():
        print("stem_splits: no CUDA device visible")
        return 1
    dev = torch.device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)}")
    kernels.library()
    gen = torch.Generator().manual_seed(SEED)
    chosen = window_conv.dw_splits
    for n, (kmap, kmap_t) in stem_maps(dev).items():
        k = kmap.shape[0]
        live = int((kmap < n).sum())
        f = torch.randn(n, 3, generator=gen).to(dev)
        w = ((torch.rand(k, 3, 32, generator=gen) * 2 - 1) / (3 * k) ** 0.5
             ).to(dev)
        gd = torch.randn(n, 32, generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            fx, wx, gx = f.to(dt), w.to(dt), gd.to(dt)
            ref = sum(conv.gather_rows(fx.double(), kmap[o]) @ wx[o].double()
                      for o in range(k))
            out = window_conv.sparse_conv_fwd(fx, kmap, wx)
            ms = graph_ms(lambda: window_conv.sparse_conv_fwd(fx, kmap, wx))
            print(f"[stem] K1 {n} rows x {k} offsets ({live} live) 3->32 "
                  f"{str(dt)[6:]}: {ms:.4f} ms, vs float64 "
                  f"{rel_err(out, ref):.3e} of max|ref|")
            ref = torch.stack([fx.double().t() @ conv.gather_rows(
                gx.double(), kmap_t[o]) for o in range(k)])
            auto = chosen(n, k, 3, 32, True, dt)
            for s in sorted(set(splits + [auto])):
                window_conv.dw_splits = lambda *a, s=s, **kw: s
                try:
                    got = window_conv.sparse_conv_dw(fx, gx, kmap_t)
                    ms = graph_ms(lambda: window_conv.sparse_conv_dw(
                        fx, gx, kmap_t))
                finally:
                    window_conv.dw_splits = chosen
                mark = " (dw_splits)" if s == auto else ""
                print(f"[stem] dW {n} rows S={s}{mark} {str(dt)[6:]}: "
                      f"{ms:.4f} ms, vs float64 "
                      f"{rel_err(got, ref):.3e} of max|ref|")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
