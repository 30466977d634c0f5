"""Two checkouts' sparse conv, interpolation, attention and gather-probe
kernels side by side on one card.

    python -m csn_tpu_torch.tools.conv_ab OTHER_ROOT \
        [--kernels conv|interp|flash|probes|steps]

OTHER_ROOT is another checkout of this repo, for example `git archive` of
the parent commit unpacked into a git-ignored directory. Each checkout runs
in its own process with its own kernel build, in the order other, this,
this, other. A run times K1 (`sparse_conv_fwd`), `sparse_conv_dw` and the
im2col pair (`sparse_conv_im2col_fwd`, and the backward through
`conv_im2col_bwd_kernels`) on seeded bf16 inputs at conv shapes of
HRNetSimCSN3S and Res16UNet34C, and all four again on the same inputs in
f32 (device time from CUDA graphs, warm L2 and from device memory: the f32
form, split TF32 on the tensor cores at Cout % 8 == 0, the stem included,
whose bits are not another body's), and the interpolation
pair (`interp_fwd`,
`interp_bwd`) on the corner table of one HRNetSimCSN3S query batch (8
shapes of 10000 points, built once by this checkout and handed to both) at
39 and 256 channels in f32 and bf16 (CUDA-event medians per call over
batches of calls; for the interpolation pair over replays of a CUDA graph
of 20 calls, the device's time without the wrappers' host work, with a
warm L2 and from device memory: `tools/timing.py`), and the flash pair
(`flash_attn_fwd`, `flash_attn_bwd`) at the HRNet SSA call [16, 4, 5632,
64] in bf16 and f32, at the f32 CSA call [8, 4, 5632, 64] against 5632
keys, with ragged masks, at the MID-FC chunk shape [80, 8, 500, 256] in
f32 and bf16, and at the SSA call with d_model 256 in 2 heads of 128 and 1
of 256 in bf16 and in 2 heads of 128 in f32, at dropout 0 and 0.1 (device
time from CUDA graphs, warm L2), with the other bodies' outputs for the
bitwise comparison (bf16 D=32 and 16 at the SSA call cut to 4 shapes; the
ring's carry and block backward on one 2500-key block in f32 and bf16 at
D=256 and in f32 at D=64, and over all keys of the ring of one at d_model
128 and 64, [2, 8, 10000, 128] and [2, 8, 10000, 64], in f32 and bf16,
timed too; the f32 pair at D=128, the ring's bf16 D=256 pair and its
D=128 and D=64 pairs are also held against the other checkout's outputs
by value, as max|this - other| / max|other| within the tolerance of their
type, for bodies of another design), and the gather probes
(`probe_gather_accum` in its three modes at the probe scripts' timing
geometry, 352 tiles x 9 offsets x 256 rows x 128 channels, with the bf16
window at W = 384 and the f32 window at W = 384 and 256, row ids outside
the window mixed in; `probe_window_gather` at [384, 128] f32 and bf16 in
both layouts; `probe_slot_load`'s seven variants on the probe's inputs
beside the launch floor, an empty kernel, in graphs of 200 calls; device
time from CUDA graphs, warm L2 and from device memory), and the
HRNetSimCSN3S eval and train steps with f32 activations at the bench
protocol (`--kernels steps`: 8 query shapes of 10000 points,
K=1, voxel 0.05, level-0 cap 5632, k5 stem, d_model 256 in 4 heads, 39
classes, dropout 0.1, SGD; ms per step on the host clock, the peak
device memory of those steps, and the device ms per step of K1,
`sparse_conv_dw`, K2 with its backward and the rest from
`torch.profiler`),
and hashes every output. The script
prints each run's times, whether each kernel's outputs are bitwise equal
across the checkouts and between two launches in one run, and the
registers and spill bytes ptxas reports for the kernels of
`csrc/sparse_conv.cu`, `csrc/sparse_conv_bwd.cu`,
`csrc/sparse_conv_im2col.cu`, `csrc/sparse_conv_im2col_bwd.cu`,
`csrc/interp.cu`,
`csrc/interp_bwd.cu`, `csrc/flash_attn.cu`, `csrc/flash_attn_bwd.cu`,
`csrc/flash_attn_carry.cu`, `csrc/flash_attn_block_bwd.cu`,
`csrc/probe_gather.cu` and `csrc/probe_slots.cu` in each (with their static
shared memory). `--kernels` runs one family only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (rows, offsets, Cin, Cout): HRNetSimCSN3S's levels at 64, 128 and 256
# channels and its k5 stem, Res16UNet34C's widest k2 conv
SHAPES = ((90112, 27, 64, 64), (30208, 27, 128, 128), (10240, 27, 256, 256),
          (90112, 125, 3, 32), (5000, 8, 96, 384))
LIVE = 0.35      # share of map entries that name a row
SEED = 7
REGISTER_SOURCES = {"conv": ("sparse_conv.cu", "sparse_conv_bwd.cu",
                             "sparse_conv_im2col.cu",
                             "sparse_conv_im2col_bwd.cu"),
                    "interp": ("interp.cu", "interp_bwd.cu"),
                    "flash": ("flash_attn.cu", "flash_attn_bwd.cu",
                              "flash_attn_carry.cu",
                              "flash_attn_block_bwd.cu"),
                    "probes": ("probe_gather.cu", "probe_slots.cu"),
                    "steps": ()}
FAMILIES = tuple(REGISTER_SOURCES)
INTERP_WIDTHS = (39, 256)   # the HRNet heads' classes, the extraction chain
# the HRNet SSA call: (K + 1) B shapes, 4 heads of 64, the level-3 cap
FLASH_SHAPE = (16, 4, 5632, 64)
# the MID-FC CSA chunks: 4 shapes x 10000 points in chunks of 500, 8 heads of
# 256
MIDFC_SHAPE = (80, 8, 500, 256)
FLASH_DROPOUT, FLASH_SEED = 0.1, 0x5EED
SLOT_CALLS = 200    # calls per CUDA graph of the slot loads' timing
RING_BLOCK = 2500   # keys of one ring hop at phase 7's shape (10000 / 4)
# the ring of one at d_model 128 and 64 (phases 7c and 7d): all 10000 keys,
# 8 heads of 128 or 64
RING_ONE = ((2, 8, 10000, 128), (2, 8, 10000, 64))
# the shapes whose outputs are compared across checkouts by value, with the
# tolerance of their type (x max|other|)
BY_VALUE = {"ring block [2,8,2500,256] bfloat16": 2e-2,
            "flash SSA [16,2,5632,128] float32": 1e-4,
            "ring block [2,8,2500,64] float32": 1e-4,
            "ring of one [2,8,10000,128] float32": 1e-4,
            "ring of one [2,8,10000,128] bfloat16": 2e-2,
            "ring of one [2,8,10000,64] float32": 1e-4,
            "ring of one [2,8,10000,64] bfloat16": 2e-2}


def _median_ms(fn, reps: int, batch: int = 10) -> float:
    """Median ms per call over `reps` samples of `batch` calls back to back
    (the queue stays full, so the host's launch time hides behind the
    device's)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(batch):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / batch)
    return statistics.median(times)


def graph_ms(fn, **kw) -> float:
    """`tools/timing.py`'s `graph_ms`, loaded from this file's checkout:
    a worker imports the other checkout's package, which may lack it."""
    spec = importlib.util.spec_from_file_location(
        "csn_ab_timing", Path(__file__).with_name("timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    return timing.graph_ms(fn, **kw)


def _ms(v: float) -> str:
    """A time in ms, to 4 decimals, or 6 below 0.01 ms (the slot loads and
    the launch floor take a few microseconds)."""
    return f"{v:.6f}" if v < 0.01 else f"{v:.4f}"


def _digest(t) -> str:
    import torch
    if isinstance(t, (tuple, list)):
        return hashlib.sha256("".join(map(_digest, t)).encode()).hexdigest()[
            :16]
    t = t.contiguous()
    raw = t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def _entry(fn, reps: int, timer=_median_ms, **extra) -> list:
    """[ms per call, digest, whether a second launch gave the same bits,
    then the ms of `timer` with each of `extra`'s keyword sets]."""
    first = _digest(fn())
    return [timer(fn, reps=reps), first, _digest(fn()) == first] + [
        timer(fn, reps=reps, **kw) for kw in extra.values()]


def conv_worker(reps: int) -> dict:
    """The current checkout's conv kernels at every shape: {shape: {kernel:
    entry}}."""
    import torch
    from csn_tpu_torch.core import conv, window_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    res = {}
    for n, k, cin, cout in SHAPES:
        def rand_map():
            pick = torch.randint(0, n, (k, n), generator=gen,
                                 dtype=torch.int32)
            live = torch.rand(k, n, generator=gen) < LIVE
            return torch.where(live, pick, n).to(dev)

        kmap, kmap_t = rand_map(), rand_map()
        f = torch.randn(n, cin, generator=gen).to(dev, torch.bfloat16)
        gd = torch.randn(n, cout, generator=gen).to(dev, torch.bfloat16)
        w32 = ((torch.rand(k, cin, cout, generator=gen) * 2 - 1)
               / (cin * k) ** 0.5).to(dev)
        w = w32.to(torch.bfloat16)
        calls = {
            "sparse_conv_fwd": lambda: window_conv.sparse_conv_fwd(f, kmap, w),
            "sparse_conv_dw": lambda: window_conv.sparse_conv_dw(f, gd,
                                                                 kmap_t),
            "sparse_conv_im2col_fwd": lambda: window_conv
            .sparse_conv_im2col_fwd(f, kmap, w),
            "sparse_conv_im2col_bwd": lambda: conv.conv_im2col_bwd_kernels(
                f, gd, kmap_t, w32, False, cin != 3)[1],
        }
        res[f"{n}x{k} {cin}->{cout}"] = {
            name: _entry(fn, reps) for name, fn in calls.items()}
        # the f32 form on the same values
        f32, g32 = f.float(), gd.float()
        calls = {
            "sparse_conv_fwd": lambda: window_conv.sparse_conv_fwd(f32, kmap,
                                                                   w32),
            "sparse_conv_dw": lambda: window_conv.sparse_conv_dw(f32, g32,
                                                                 kmap_t),
            "sparse_conv_im2col_fwd": lambda: window_conv
            .sparse_conv_im2col_fwd(f32, kmap, w32),
            "sparse_conv_im2col_bwd": lambda: conv.conv_im2col_bwd_kernels(
                f32, g32, kmap_t, w32, False, cin != 3)[1],
        }
        # the im2col backward's partials are several MB a call: graphs of 5
        res[f"{n}x{k} {cin}->{cout} f32"] = {
            name: _entry(fn, reps, graph_ms, cold={"cold": True})
            if "im2col" not in name else
            _entry(fn, 3, lambda f, **kw: graph_ms(f, calls=5, **kw),
                   cold={"cold": True})
            for name, fn in calls.items()}
    return res


def interp_table(path: Path) -> None:
    """Save the corner table (idx, w, the CSR ptr and ent) of one
    HRNetSimCSN3S query batch at the chip smoke run's protocol."""
    import numpy as np
    import torch
    from csn_tpu_torch.core.pyramid import to_torch
    from csn_tpu_torch.data import pipeline
    from csn_tpu_torch.data.synthetic import make_surface_shape
    from csn_tpu_torch.models import load_model

    spec = pipeline.pyramid_spec_for_model(
        load_model("HRNetSimCSN3S"), num_points=10000, voxel_size=0.05,
        conv1_kernel_size=5, level0_cap=5632, shrink=3.0)
    rng = np.random.default_rng(SEED)
    qb = to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, 10000) for _ in range(8)], spec, rng=rng),
        "cpu")
    torch.save({"idx": qb.interp_idx.reshape(-1, 8),
                "w": qb.interp_w.reshape(-1, 8), "ptr": qb.interp_ptr,
                "ent": qb.interp_ent}, path)


def interp_worker(reps: int, table: Path) -> dict:
    """The current checkout's interpolation pair on the saved corner table:
    {shape: {kernel: entry}}."""
    import torch
    from csn_tpu_torch.core import interp_window

    dev = torch.device("cuda")
    tab = {k: v.to(dev) for k, v in torch.load(table).items()}
    idx, w8, ptr, ent = tab["idx"], tab["w"], tab["ptr"], tab["ent"]
    n_vox, n_pts = ptr.shape[0] - 1, idx.shape[0]
    gen = torch.Generator().manual_seed(SEED)
    res = {}
    for c in INTERP_WIDTHS:
        flat32 = torch.randn(n_vox, c, generator=gen)
        g32 = torch.randn(n_pts, c, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            flat, gd = flat32.to(dev, dt), g32.to(dev, dt)
            calls = {
                "interp_fwd": lambda: interp_window.interp_fwd(flat, idx, w8),
                "interp_bwd": lambda: interp_window.interp_bwd(gd, ptr, ent,
                                                               w8),
            }
            # device time (the host work of a call outlasts the kernel),
            # with a warm L2 and from device memory
            res[f"interp [{n_vox},{c}] <-> [{n_pts},{c}] {str(dt)[6:]}"] = {
                name: _entry(fn, reps, graph_ms, cold={"cold": True})
                for name, fn in calls.items()}
    return res


def _flash_calls(q, k, v, dout, qmask, kmask, reps: int, keep=None) -> dict:
    """{kernel at dropout: entry} of the flash pair on these inputs at
    dropout 0 and FLASH_DROPOUT (device time from CUDA graphs, warm L2);
    with `keep`, each call's outputs (f32, on the host) into it by the
    entry's name."""
    from csn_tpu_torch.ops import flash

    temp = float(q.shape[-1]) ** 0.5
    calls = {}
    for drop in (0.0, FLASH_DROPOUT):
        sd = FLASH_SEED if drop else None
        out, lse = flash.flash_attention(q, k, v, kmask, qmask, temp, drop,
                                         sd)
        delta = (dout.float() * out.float()).sum(dim=-1)
        calls[f"flash_attn_fwd dropout {drop}"] = (
            lambda drop=drop, sd=sd: flash.flash_attention(
                q, k, v, kmask, qmask, temp, drop, sd))
        calls[f"flash_attn_bwd dropout {drop}"] = (
            lambda drop=drop, sd=sd, lse=lse, delta=delta:
            flash.flash_attention_bwd(q, k, v, dout, lse, delta, kmask,
                                      qmask, temp, drop, sd))
    if keep is not None:
        for name, fn in calls.items():
            keep[name] = [t.float().cpu() for t in fn()]
    return {name: _entry(fn, reps, graph_ms) for name, fn in calls.items()}


def flash_worker(reps: int, keep: dict) -> dict:
    """The current checkout's flash pair: {shape: {kernel at dropout:
    entry}}, at FLASH_SHAPE (the HRNet SSA call) in bf16 and in f32 (the
    f32 HRNet step's call), at the CSA call (8 query shapes against 8 key
    shapes, the same sizes) in f32, at the MID-FC chunk shape MIDFC_SHAPE
    in f32 and bf16 (head dim 256), and at the SSA call with d_model 256 in
    2 heads of 128 and 1 of 256 in bf16 and in 2 heads of 128 in f32; then,
    for their bits, bf16 D=32 and 16 at the SSA call cut to 4 shapes and the
    ring's per-block kernels (`_ring_calls`). The outputs of the BY_VALUE
    shapes go into `keep`, by shape. Each shape's valid rows are a prefix of
    seeded length (as a padded point set); the SSA call takes one mask for
    queries and keys."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)

    def inputs(b, h, L, d, dt):
        x = [torch.randn(b, h, L, d, generator=gen).to(dev, dt)
             for _ in range(4)]
        n = torch.randint(L // 2, L + 1, (b,), generator=gen)
        mask = (torch.arange(L)[None, :] < n[:, None]).to(dev)
        x[3] = x[3] * mask[:, None, :, None]
        return x, mask

    res = {}
    b, h, L, d = FLASH_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        x, mask = inputs(b, h, L, d, dt)
        res[f"flash SSA [{b},{h},{L},{d}] {str(dt)[6:]}"] = _flash_calls(
            *x, mask, mask, reps)
    x, qmask = inputs(b // 2, h, L, d, torch.float32)
    n = torch.randint(L // 2, L + 1, (b // 2,), generator=gen)
    kmask = (torch.arange(L)[None, :] < n[:, None]).to(dev)
    res[f"flash CSA [{b // 2},{h},{L},{d}] float32"] = _flash_calls(
        *x, qmask, kmask, reps)
    b, h, L, d = MIDFC_SHAPE
    x, _ = inputs(b, h, L, d, torch.float32)
    ones = torch.ones(b, L, dtype=torch.bool, device=dev)
    res[f"flash MID-FC chunks [{b},{h},{L},{d}] float32"] = _flash_calls(
        *x, ones, ones, reps)
    # bf16 at the widths 128 and 256: the MID-FC chunks, and the SSA call
    # with d_model 256 in 2 heads of 128 and 1 of 256
    xb = [t.to(torch.bfloat16) for t in x]
    res[f"flash MID-FC chunks [{b},{h},{L},{d}] bfloat16"] = _flash_calls(
        *xb, ones, ones, reps)
    b, h, L, d = FLASH_SHAPE
    for d in (128, 256):
        x, mask = inputs(b, h * FLASH_SHAPE[3] // d, L, d, torch.bfloat16)
        res[f"flash SSA [{b},{x[0].shape[1]},{L},{d}] bfloat16"] = \
            _flash_calls(*x, mask, mask, reps)
    # f32 at d_model 256 in 2 heads of 128 (the inputs of the bf16 call at
    # 128 in f32 would draw other numbers: drawn anew)
    x, mask = inputs(b, h * FLASH_SHAPE[3] // 128, L, 128, torch.float32)
    shape = f"flash SSA [{b},{x[0].shape[1]},{L},128] float32"
    res[shape] = _flash_calls(*x, mask, mask, reps,
                              keep.setdefault(shape, {}))
    # the other bodies' bits, at the SSA call cut to 4 shapes
    for d, dt in ((32, torch.bfloat16), (16, torch.bfloat16)):
        x, mask = inputs(4, h * FLASH_SHAPE[3] // d, L, d, dt)
        res[f"flash SSA [4,{x[0].shape[1]},{L},{d}] {str(dt)[6:]}"] = \
            _flash_calls(*x, mask, mask, reps)
    for d, dt in ((256, torch.float32), (256, torch.bfloat16),
                  (64, torch.float32)):
        x, mask = inputs(2, 8, RING_BLOCK, d, dt)
        shape = f"ring block [2,8,{RING_BLOCK},{d}] {str(dt)[6:]}"
        res[shape] = _ring_calls(
            *x, mask, reps,
            keep.setdefault(shape, {}) if shape in BY_VALUE else None)
    # the ring of one at head dims 128 and 64 (a form on the CUDA cores
    # takes up to a tenth of a second a call: graphs of 5 calls)
    for b, h, L, d in RING_ONE:
        for dt in (torch.float32, torch.bfloat16):
            x, mask = inputs(b, h, L, d, dt)
            shape = f"ring of one [{b},{h},{L},{d}] {str(dt)[6:]}"
            res[shape] = _ring_calls(*x, mask, reps,
                                     keep.setdefault(shape, {}), col=0,
                                     calls=5, kept_heads=2)
    return res


def _ring_calls(q, k, v, dout, kmask, reps: int, keep=None,
                col: int = RING_BLOCK, calls: int = 20,
                kept_heads: int = None) -> dict:
    """{kernel at dropout: entry} of the ring's per-block kernels on one
    key block at column offset `col` (`flash_forward_carry` from a fresh
    carry, `flash_block_backward` against that block's own lse), at
    dropout 0 and FLASH_DROPOUT, timed in CUDA graphs of `calls` calls;
    with `keep`, each call's outputs (f32, on the host; of the first
    `kept_heads` heads, or all) into it by the entry's name."""
    from csn_tpu_torch.ops import flash

    temp = float(q.shape[-1]) ** 0.5
    b, h, lq, d = q.shape
    carry = flash.flash_carry_init(b, h, lq, d, q.device)
    fns = {}
    for drop in (0.0, FLASH_DROPOUT):
        sd = FLASH_SEED if drop else None
        out, lse = flash.flash_carry_finalize(flash.flash_forward_carry(
            q, k, v, kmask, None, carry, temp, drop, sd, 0, col))
        out = out.to(q.dtype)
        fns[f"flash_attn_carry dropout {drop}"] = (
            lambda drop=drop, sd=sd: flash.flash_forward_carry(
                q, k, v, kmask, None, carry, temp, drop, sd, 0, col))
        fns[f"flash_attn_block_bwd dropout {drop}"] = (
            lambda drop=drop, sd=sd, out=out, lse=lse:
            flash.flash_block_backward(q, k, v, kmask, out, lse, dout, temp,
                                       drop, sd, 0, col))
    if keep is not None:
        for name, fn in fns.items():
            keep[name] = [t[:, :kept_heads].float().cpu() for t in fn()]
    return {name: _entry(fn, reps, lambda f, reps: graph_ms(
        f, calls=calls, reps=reps)) for name, fn in fns.items()}


def probe_worker(reps: int) -> dict:
    """The current checkout's probe kernels at the probe scripts' shapes:
    {shape: {kernel: entry}}: the gathers, the seven slot loads and the
    launch floor. Both checkouts' wrappers take the same arguments."""
    import torch
    from csn_tpu_torch.probes import dyngather

    dev = torch.device("cuda")
    k, n_tiles, t, c = 9, 352, dyngather.T, dyngather.C
    res = {}
    for dt, w in ((torch.bfloat16, 384), (torch.float32, 384),
                  (torch.float32, 256)):
        rows, win = dyngather.timing_inputs(w, t, c, n_tiles, k, dt, dev)
        rows[1, :9] = -1          # row ids outside the window
        rows[5, 100:140] = w
        rows[k + 2, ::7] = w + 1000
        res[f"gather_accum {n_tiles}x{k}x{t} W={w} C={c} {str(dt)[6:]}"] = {
            f"probe_gather_accum {mode}": _entry(
                lambda mode=mode: dyngather.gather_accum(rows, win, k, mode),
                reps, graph_ms, cold={"cold": True})
            for mode in dyngather.MODES}
    win_np, rel_np, _ = dyngather.probe_inputs()
    rel = torch.from_numpy(rel_np).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        win = torch.from_numpy(win_np).to(dev, dt)
        res[f"window_gather W={dyngather.W} T={t} C={c} {str(dt)[6:]}"] = {
            f"probe_window_gather layout {layout}": _entry(
                lambda layout=layout: dyngather.window_gather(win, rel,
                                                              layout),
                reps, graph_ms, cold={"cold": True})
            for layout in (0, 1)}
    # the slot loads, each variant on the probe's input, beside the launch
    # floor (an empty kernel): both are a few microseconds, so each graph
    # holds SLOT_CALLS calls
    from csn_tpu_torch import kernels
    from csn_tpu_torch.probes import iw_bwd
    slot_ms = lambda f, reps, **kw: graph_ms(f, calls=SLOT_CALLS, reps=reps,
                                             **kw)
    res["slot_load"] = {
        f"probe_slot_load P{v}": _entry(
            lambda v=v, x=torch.from_numpy(iw_bwd.probe_input(v)).to(dev)
            * 3.0: iw_bwd.slot_load(v, x), reps, slot_ms,
            cold={"cold": True})
        for v in iw_bwd.VARIANTS}
    res["slot_load"]["launch floor"] = [slot_ms(kernels.empty_launch, reps)]
    return res


# the f32 steps: chip_smoke.py's protocol (the JAX package's bench.py)
STEP_SHAPES, STEP_POINTS, STEP_DROPOUT, STEP_LR = 8, 10000, 0.1, 0.05
# device kernels by name: K1's bodies, dW's, then K2's and its backward's
STEP_KERNELS = (("K1", ("sparse_conv_fwd",)),
                ("sparse_conv_dw", ("sparse_conv_dw", "sum_splits")),
                ("attention", ("flash_",)))


def steps_worker(reps: int) -> dict:
    """The current checkout's HRNetSimCSN3S eval and train steps with f32
    activations at STEP_SHAPES query shapes of STEP_POINTS points, K=1:
    {step: {"ms": [ms per step], device ms per step by STEP_KERNELS and
    "rest": [ms], "peak GiB": [peak device memory]}}. The step time is the
    host clock over `reps` steps ending in a synchronize, after 3 warm-up
    steps, and the peak memory that of those steps; the device times come
    from one more step under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from csn_tpu_torch.core.pyramid import to_torch
    from csn_tpu_torch.data import pipeline
    from csn_tpu_torch.data.synthetic import make_surface_shape
    from csn_tpu_torch.models import load_model
    from csn_tpu_torch.train import optim
    from csn_tpu_torch.train.steps import eval_step, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=STEP_POINTS, voxel_size=0.05, conv1_kernel_size=5,
        level0_cap=5632, shrink=3.0)
    rng = np.random.default_rng(SEED)
    qb, kb = (to_torch(pipeline.collate_shapes(
        [make_surface_shape(rng, STEP_POINTS) for _ in range(STEP_SHAPES)],
        spec, rng=rng), dev) for _ in range(2))
    model = cls(out_channels=39, conv1_kernel_size=5, compute_dtype="float32",
                d_model=256, n_head=4, k_neighbors=1,
                attn_dropout=STEP_DROPOUT)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.to(dev)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=STEP_LR)
    gen = torch.Generator().manual_seed(SEED)
    steps = {"eval": lambda: eval_step(model, qb, (kb,))[0],
             "train": lambda: train_step(model, opt, qb, (kb,), gen)[0]}
    res = {}
    for name, step in steps.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        dev_ms = {key: 0.0 for key, _ in STEP_KERNELS}
        dev_ms["rest"] = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = next((k for k, pats in STEP_KERNELS
                        if any(p in e.key for p in pats)), "rest")
            dev_ms[key] += e.device_time_total / 1e3
        res[f"HRNetSimCSN3S f32 {name} step B={STEP_SHAPES} K=1"] = {
            "ms": [ms],
            **{f"device {k}": [v] for k, v in dev_ms.items()},
            "peak GiB": [peak]}
    return res


def worker(reps: int, families: tuple, table: Path, keep: dict) -> dict:
    res = {}
    if "conv" in families:
        res.update(conv_worker(reps))
    if "interp" in families:
        res.update(interp_worker(reps, table))
    if "flash" in families:
        res.update(flash_worker(reps, keep))
    if "probes" in families:
        res.update(probe_worker(reps))
    if "steps" in families:
        res.update(steps_worker(reps))
    return res


def by_value(tmp: Path) -> None:
    """Print, for each output of the BY_VALUE shapes' calls, max|this -
    other| / max|other| of the first run of each checkout (`tmp` holds the
    workers' outputs) against the shape's tolerance."""
    import torch
    this, other = (torch.load(tmp / f"{tag}1.pt") for tag in ("this",
                                                                "other"))
    for shape, tol in BY_VALUE.items():
        for name, outs in this.get(shape, {}).items():
            errs = [float((a - r).abs().max())
                    / max(float(r.abs().max()), 1e-30)
                    for a, r in zip(outs, other[shape][name])]
            print(f"[ab] {shape}: {name} this vs other, max_abs_err / "
                  f"max|other| per output: "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + f" (tolerance {tol:.0e}: "
                  f"{'within' if max(errs) <= tol else 'OUTSIDE'})")


def registers(root: Path, families: tuple = (), sources: tuple = ()) -> list:
    """(kernel, registers, spill store bytes, spill load bytes, shared
    memory bytes) of every kernel ptxas compiles in the REGISTER_SOURCES of
    `families`, and in `sources`, in the checkout at `root`."""
    from csn_tpu_torch import kernels
    filt = shutil.which("cu++filt", path=str(Path(kernels.nvcc()).parent))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in (*(s for f in families for s in REGISTER_SOURCES[f]),
                    *sources):
            res = subprocess.run(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(root / "csn_tpu_torch" / "csrc" / src), "-o",
                 str(Path(tmp) / "k.o")], capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc {src} in {root}:\n{res.stderr}")
            name, spill = None, (0, 0)
            for line in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name, spill = m.group(1), (0, 0)
                    if filt:
                        name = subprocess.run([filt, name], capture_output=True,
                                              text=True).stdout.strip()
                        # kernel<(int)2, (int)4, false>(args) -> kernel<2, 4,
                        # false>
                        name = re.sub(r"\((?:int|bool|anonymous namespace)\)",
                                      "", name)
                        name = name.split("(")[0].split("::")[-1]
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    smem = re.search(r"(\d+) bytes smem", line)
                    out.append((f"{src} {name}", int(m.group(1)), *spill,
                                int(smem.group(1)) if smem else 0))
                    name, spill = None, (0, 0)
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", choices=FAMILIES,
                    help="one family only (default: all)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--table", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--outputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    families = (args.kernels,) if args.kernels else FAMILIES
    if args.worker:
        import torch
        keep = {}
        print(json.dumps(worker(args.reps, families, args.table, keep)))
        if keep:
            torch.save(keep, args.outputs)
        return 0
    this = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        table = Path(tmp) / "interp_table.pt"
        if "interp" in families:
            interp_table(table)
        for tag, root in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
            # the worker imports the package of `root`; this file drives it
            env = dict(os.environ, PYTHONPATH=str(root))
            outputs = Path(tmp) / f"{tag}{len(runs.get(tag, [])) + 1}.pt"
            res = subprocess.run(
                [sys.executable, __file__, str(other), "--worker", "--reps",
                 str(args.reps), "--table", str(table), "--outputs",
                 str(outputs)]
                + (["--kernels", args.kernels] if args.kernels else []),
                cwd=root, env=env, capture_output=True, text=True)
            if res.returncode:
                print(res.stdout, res.stderr, file=sys.stderr)
                return 1
            run = json.loads(res.stdout.strip().splitlines()[-1])
            runs.setdefault(tag, []).append(run)
            for shape, kern in run.items():
                print(f"[ab {tag}{len(runs[tag])}] {shape}: " + ", ".join(
                    (f"{name} {e[0]:.4f}" if "GiB" in name
                     else f"{name} {_ms(e[0])} ms")
                    + (f" ({_ms(e[3])} from device memory)" if len(e) > 3
                       else "") for name, e in kern.items()))
        if "flash" in families:
            by_value(Path(tmp))
    for shape, kern in runs["this"][0].items():
        # entries with outputs: [ms, digest, repeat, ...]; [ms] times only
        outs = [name for name, e in kern.items() if len(e) > 1]
        if not outs:
            continue
        same = {name: all(r[shape][name][1] == kern[name][1]
                          for r in runs["this"] + runs["other"])
                for name in outs}
        repeat = {name: all(r[shape][name][2]
                            for r in runs["this"] + runs["other"])
                  for name in outs}
        print(f"[ab] {shape}: bitwise equal across the checkouts: "
              + ", ".join(f"{name} {v}" for name, v in same.items())
              + "; two launches bitwise equal in every run: "
              + ", ".join(f"{name} {v}" for name, v in repeat.items()))
    for tag, root in (("other", other), ("this", this)):
        for name, regs, st, ld, smem in registers(root, families):
            print(f"[ab registers {tag}] {name}: {regs} registers, {st} "
                  f"bytes spill stores, {ld} bytes spill loads, {smem} bytes "
                  f"static shared memory")
    return 0


if __name__ == "__main__":
    sys.exit(main())
