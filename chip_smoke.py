"""Smoke run of the PyTorch port on one CUDA GPU: build the kernels, check
each against its plain version at the main path's shapes, then serve a few
eval requests of HRNetSimCSN3S (K=1) at full width.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi), the C++ host
     engine;
  2. build: nvcc of csn_tpu_torch/csrc/*.cu;
  3. kernels: K1 (sparse conv) on every map and width of the model, K2
     (flash attention) at the SSA and CSA shapes with masks, K3 (voxel ->
     point interpolation), each in f32 and bf16 against its plain version on
     the same inputs, with median times of both;
  4. slice: 3 eval requests (query batch + 1 key batch each) through
     `eval_step`, launch counts per kernel, ms/step, shapes/s, peak memory,
     and the f32 forward with kernels against the plain forward on the CPU.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.

Protocol (the JAX package's bench.py infer mode): B=8 query shapes of 10000
points, voxel 0.05, level-0 cap 5632, level caps shrinking 3x, k5 stem,
d_model 256, 4 heads, 39 classes, activations in bf16; weights are random,
drawn from a seeded generator.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench
from csn_tpu_torch import kernels
from csn_tpu_torch.core import conv, interp, interp_window, window_conv
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.host import native, pipeline
from csn_tpu_torch.models import load_model
from csn_tpu_torch.models.layers import SparseConv
from csn_tpu_torch.ops import attention, flash
from csn_tpu_torch.train.steps import eval_step

B, P, VOXEL, K_NEIGHBORS = 8, 10000, 0.05, 1
LEVEL0_CAP, SHRINK, STEM_K = 5632, 3.0, 5
D_MODEL, N_HEAD, NUM_CLASSES = 256, 4, 39
N_REQUESTS, TIMED_STEPS, SEED = 3, 10, 0
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max|ref|

KERNELS = {
    "sparse_conv_fwd": ("csn_tpu_torch/csrc/sparse_conv.cu",
                        "csn_tpu/core/window_conv.py:973"),
    "flash_attn_fwd": ("csn_tpu_torch/csrc/flash_attn.cu",
                       "csn_tpu/ops/flash.py:262"),
    "interp_fwd": ("csn_tpu_torch/csrc/interp.cu",
                   "csn_tpu/core/interp_window.py:288"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median device time of one call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def build_requests(cls, spec, dev):
    """N_REQUESTS (query batch, key batch) pairs, each from its own seed."""
    reqs = []
    for r in range(N_REQUESTS):
        rng = np.random.default_rng(SEED + 1000 * r)
        qb, kb = (pipeline.collate_shapes(
            [bench.make_surface_shape(rng, P) for _ in range(B)], spec,
            rng=rng) for _ in range(K_NEIGHBORS + 1))
        reqs.append((qb, kb))
    if reqs[0][0].dropped[1] or reqs[0][0].dropped[2]:
        print(f"[batch] voxels dropped by the level caps in request 0's "
              f"query batch: {reqs[0][0].dropped}")
    return [(to_torch(q, dev), (to_torch(k, dev),)) for q, k in reqs]


class Table:
    """Per-kernel results for the JSON kernel line."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}

    def check(self, name, what, got, ref, dtype, valid=None):
        got, ref = got.float(), ref.float()
        if valid is not None:
            got = torch.where(valid, got, torch.zeros_like(got))
            ref = torch.where(valid, ref, torch.zeros_like(ref))
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = TOL[dtype] * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f"[check] {name} {what} {str(dtype)[6:]}: max_abs_err {err:.3e}"
              f" tol {tol:.3e} (max|ref| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {what} {dtype} disagrees with its plain version")
        self.err[name] = max(self.err[name], err)

    def time(self, name, what, fn_kernel, fn_plain, dtype, count=1):
        ms, pms = median_ms(fn_kernel), median_ms(fn_plain)
        print(f"[time] {name} {what} {str(dtype)[6:]}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms (x{count} per forward)")
        if dtype == torch.bfloat16:     # the main path's activation dtype
            self.ms[name] += count * ms
            self.plain_ms[name] += count * pms


def check_kernels(model, req, dev, table):
    qb, (kb,) = req
    big = concat_batches([qb, kb])
    g = torch.Generator(device="cpu").manual_seed(SEED)

    # K1: every (map, Cin, Cout) the model runs, counted per forward
    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv):
            k, cin, cout = m.kernel.shape
            key = (m.map_name, cin, cout)
            convs[key] = convs.get(key, 0) + 1
    for (name, cin, cout), count in sorted(convs.items()):
        kmap = big.kmaps[name]
        n_in = big.masks[map_levels(name)[0]].numel()
        feats = torch.randn(n_in, cin, generator=g).to(dev)
        w = ((torch.rand(kmap.shape[0], cin, cout, generator=g) * 2 - 1)
             / (cin * kmap.shape[0]) ** 0.5).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            f, wt = feats.to(dt), w.to(dt)
            what = f"{name} {cin}->{cout} N_out={kmap.shape[1]}"
            table.check("sparse_conv_fwd", what,
                        window_conv.sparse_conv_fwd(f, kmap, wt),
                        conv.conv_plain(f, kmap, wt), dt)
            table.time("sparse_conv_fwd", what,
                       lambda: window_conv.sparse_conv_fwd(f, kmap, wt),
                       lambda: conv.conv_plain(f, kmap, wt), dt, count)

    # K2: SSA over the combined pass, CSA of the query against the key
    dk = D_MODEL // N_HEAD
    bmask, qmask, kmask = big.masks[0], qb.masks[0], kb.masks[0]
    for what, qm, km in (("SSA", bmask, bmask), ("CSA", qmask, kmask)):
        b, L = qm.shape
        q, k, v = (torch.randn(b, N_HEAD, L, dk, generator=g).to(dev)
                   for _ in range(3))
        valid = qm[:, None, :, None]
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            temp = float(dk) ** 0.5
            out, lse = flash.flash_attention(qd, kd, vd, km, qm, temp)
            ref, ref_lse = attention.scaled_dot_product_attention(
                qd, kd, vd, km, temp, return_lse=True)
            shape = f"{what} [{b},{N_HEAD},{L},{dk}]"
            table.check("flash_attn_fwd", shape, out, ref, dt, valid)
            table.check("flash_attn_fwd", shape + " lse", lse, ref_lse, dt,
                        valid[..., 0])
            del out, ref, lse, ref_lse
            table.time("flash_attn_fwd", shape,
                       lambda: flash.flash_attention(qd, kd, vd, km, qm,
                                                     temp),
                       lambda: attention.scaled_dot_product_attention(
                           qd, kd, vd, km, temp), dt)

    # K3: the query batch's voxel -> point readout of the logits
    n0 = qb.masks[0].numel()
    flat = torch.randn(n0, NUM_CLASSES, generator=g).to(dev)
    idx = qb.interp_idx.reshape(-1, 8)
    w8 = qb.interp_w.reshape(-1, 8)
    for dt in (torch.float32, torch.bfloat16):
        fl = flat.to(dt)
        what = f"[{n0},{NUM_CLASSES}] -> [{idx.shape[0]},{NUM_CLASSES}]"
        table.check("interp_fwd", what, interp_window.interp_fwd(fl, idx, w8),
                    interp.interpolate_to_points(fl, idx[None], w8[None])[0],
                    dt)
        table.time("interp_fwd", what,
                   lambda: interp_window.interp_fwd(fl, idx, w8),
                   lambda: interp.interpolate_to_points(fl, idx[None],
                                                        w8[None]), dt)
    torch.cuda.synchronize()
    return sum(convs.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"C++ host engine loaded: {native.available()}")

    # 2. build
    t0 = time.perf_counter()
    build_s = kernels.build(force=True)
    kernels.library()
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: {build_s:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with loading)")

    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=P, voxel_size=VOXEL, conv1_kernel_size=STEM_K,
        level0_cap=LEVEL0_CAP, shrink=SHRINK, use_windows=False,
        dense_stem_grid=0)
    print(f"[batch] level caps {spec.level_caps}, maps {spec.map_names()}")
    t0 = time.perf_counter()
    reqs = build_requests(cls, spec, dev)
    print(f"[batch] {N_REQUESTS} requests x (1 + {K_NEIGHBORS}) batches of "
          f"{B} shapes built and moved in {time.perf_counter() - t0:.2f} s")

    model = cls(out_channels=NUM_CLASSES, conv1_kernel_size=STEM_K,
                d_model=D_MODEL, n_head=N_HEAD, k_neighbors=K_NEIGHBORS,
                compute_dtype="bfloat16")
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval().to(dev)

    # 3. kernels against their plain versions
    table = Table()
    n_convs = check_kernels(model, reqs[0], dev, table)
    expect = {"sparse_conv_fwd": n_convs, "flash_attn_fwd": 2,
              "interp_fwd": 1}

    # 4. the slice: N_REQUESTS eval requests through the kernels
    kernels.reset_launches()
    for r, (qb, keys) in enumerate(reqs):
        loss, point_logits, pred = eval_step(model, qb, keys)
        valid = qb.point_mask
        require(bool(torch.isfinite(loss)), f"request {r}: loss {loss}")
        require(point_logits.shape == (B, P, NUM_CLASSES)
                and bool(torch.isfinite(point_logits[valid]).all()),
                f"request {r}: bad point logits")
        p = pred[valid]
        require(int(p.min()) >= 1 and int(p.max()) <= NUM_CLASSES - 1,
                f"request {r}: predictions outside [1, {NUM_CLASSES - 1}]")
        print(f"[slice] request {r}: loss {float(loss):.6f}, "
              f"{int(valid.sum())} points, pred in [{int(p.min())}, "
              f"{int(p.max())}]")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[slice] launches over {N_REQUESTS} requests: {launches} "
          f"(expected per request: {expect})")
    for name, n in expect.items():
        require(launches[name] == N_REQUESTS * n,
                f"{name}: {launches[name]} launches, expected "
                f"{N_REQUESTS * n}")

    qb, keys = reqs[0]
    for _ in range(2):
        eval_step(model, qb, keys)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        eval_step(model, qb, keys)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] {ms:.3f} ms/step over {TIMED_STEPS} steps (B={B}, "
          f"K={K_NEIGHBORS}, bf16), {B / ms * 1e3:.3f} query shapes/s, peak "
          f"memory {peak / 2 ** 30:.3f} GiB")

    # the f32 forward through the kernels against the plain forward (CPU)
    m32 = cls(out_channels=NUM_CLASSES, conv1_kernel_size=STEM_K,
              d_model=D_MODEL, n_head=N_HEAD, k_neighbors=K_NEIGHBORS,
              compute_dtype="float32")
    m32.load_state_dict(model.state_dict())
    m32.eval().to(dev)
    with torch.no_grad():
        got = m32(qb, keys).cpu()
        m32.cpu()
        t0 = time.perf_counter()
        ref = m32(qb.to("cpu"), tuple(k.to("cpu") for k in keys))
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[slice] f32 logits, kernels on the GPU vs plain on the CPU "
          f"({time.perf_counter() - t0:.1f} s): max_abs_err {err:.3e} tol "
          f"{1e-3 * scale:.3e} (max|ref| {scale:.3e})")
    require(err <= 1e-3 * scale, "f32 forward: kernels disagree with plain")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": table.err[name],
         "ms": table.ms[name], "plain_ms": table.plain_ms[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
