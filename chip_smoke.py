"""Smoke run of the PyTorch port on one CUDA GPU: build the kernels, check
each against its plain version at the main paths' shapes, then serve a few
eval requests and take a few train steps of HRNetSimCSN3S (K=1) and of the
MID-FC CrossShapeAt heads (CSA on 500-point chunks; SSA with full attention
through a ring of one) at full width, run the HRNet trainer and the eval
CLI's path with the sparse conv in its im2col form (CSN_DYNG=2), then the
Res16UNet34C trainer, a ResUNet14 and a ResNet14 forward, the feature
extraction -> SSA -> kNN -> CSA -> `get_csa_pred` chain and the probes.

    python3 chip_smoke.py [--profile]

With --profile, phases 6, 7 and 8 also run their train step (phase 8: also
whole trainer iterations) under `torch.profiler` and print the device's busy
share and the device time by kernel (the breakdown PERF.md quotes).

Phases (each prints its lines; any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi), the C++ host
     engine;
  2. build: nvcc of csn_tpu_torch/csrc/*.cu, one process per source;
  3. kernels, each in f32 and bf16 against its plain version on the same
     inputs, with median times of both (bf16, the main path's type):
     K1 (sparse conv) on every map and width of the model, and on every
     transpose map with the weights transposed (the backward's d_feats);
     `sparse_conv_dw` (dW) at the same convs, random asymmetric weights,
     against `conv_bwd_plain`; on the same inputs `sparse_conv_im2col_fwd`
     against `conv_im2col_plain` and K1, and `sparse_conv_im2col_bwd`
     (d_feats and dW; dW only for the stem) against `conv_im2col_bwd_plain`
     and K1 / `sparse_conv_dw`; K2 (flash attention) at the SSA and CSA
     shapes with masks, at dropout 0 and 0.1 (same seed as the plain
     version); `flash_attn_bwd` at dropout 0 and 0.1 against autograd of
     the plain version; K3 (voxel -> point interpolation) and `interp_bwd`
     against `index_add_`; K2 and `flash_attn_bwd` at the MID-FC chunk
     shape [80, 8, 500, 256]; `flash_attn_carry` chained over 4 key blocks
     of 2500 at [2, 8, 10000, 256] against `online_block_update` chained the
     same way and against one K2 pass over all 10000 keys, and
     `flash_attn_block_bwd` summed over the 4 blocks against one
     `flash_attn_bwd` call; the four conv kernels again on every (map, Cin,
     Cout) of Res16UNet34C (8-offset k2 maps, five levels, widths 96, 192,
     384; timed, B=8) and of ResUNet14 and ResNet14 (1-offset k1 maps, six
     levels, widths up to 768; checked only, B=2); the probe kernels:
     `probe_window_gather` in f32 and bf16, both layouts, W = 384 and 256,
     matched and unmatched, with a row id outside the window;
     `probe_gather_accum` in its three modes against the plain version and
     against each other, bf16 and f32 windows, with row ids outside the
     window; `probe_slot_load` in every variant;
  4. eval slice: 3 eval requests (query batch + 1 key batch each) through
     `eval_step`, launch counts per kernel, ms/step, shapes/s, peak memory,
     and the f32 forward with kernels against the plain forward on the CPU;
  5. train slice: 3 train requests through `train_step` (bf16, attention
     dropout 0.1, SGD lr 0.05), launch counts per kernel and step, ms/step
     over 10 steps, shapes/s, peak memory; then one f32 train step at
     dropout 0 on B=2 shapes with the kernels on the GPU against the same
     step with the plain versions on the CPU (loss and every gradient),
     the CPU step taking the GPU step's ReLU decisions (`ReluDecisions`);
  6. MID-FC chunked, the JAX package's `bench.py` midfc protocol:
     `MidfcRunner(cfg, "csa")` with 8 heads of 256, K=4, B=4, P=10000,
     d_model 256, chunks of 500, 39 classes, f32, Adam(0.5, 0.999), seeded
     numpy features: 3 eval requests and 3 train steps through the runner's
     own `_eval` / `_grad` / `_apply`, launch counts per step, ms/step,
     shapes/s, peak memory; then one f32 B=1 step at dropout 0 with the
     kernels on the GPU against the plain step on the CPU;
  7. MID-FC full attention through the ring (a ring of one: what one card
     can run): `CrossShapeAt("ssa", chunk_size=None)` sharded over a
     `torch.distributed` group of one rank, through the `parallel/midfc.py`
     steps at B=2: one eval request and one train step on
     `flash_attn_carry` and `flash_attn_block_bwd`, the logits held against
     the same model without the group (K2);
  8. the trainer, inside CSN_DYNG=2: `tasks/main_csn.build_trainer` and
     `CSNTrainer.train()` on HRNetSimCSN3S at the protocol below (SGD, bf16)
     over an in-memory synthetic collection (16 train, 8 val, 8 test shapes
     of `make_surface_shape`; no h5 file), 2 epochs, MAX_PATIENCE =
     MAX_COOLDOWN = 1: every loss finite, the first graph built from random
     pairs, exact launch counts per train iteration (the im2col pair once
     per conv, K1 and `sparse_conv_dw` never), ms per iteration inside
     `train()`, the host batch build alone, the step alone on a fixed
     batch, peak memory, the checkpoints and `config.json` on disk; then the
     eval CLI's path on a fresh trainer: `resume()` (iteration, bests,
     neighbour lists and every model tensor as saved), `construct_test_graph`
     and a graph rebuild timed, `test_on` recomputed and with `cached_eval`
     (launch counts per request, ms per shape, predictions in [1, C-1], the
     two agreeing on >= 99.9 % of points and within 1e-3 in IoU: the cache
     is f16); then one f32 B=2 train step under CSN_DYNG=2 on the GPU against
     the plain step on the CPU, as in phase 5;
  9. the other model families and the MID-FC chain: `tasks/main_seg.
     build_trainer` with `--model Res16UNet34C` (bf16, B=8, the protocol
     below with five levels) and `SegTrainer.train()` for 2 epochs on the
     in-memory collection, exact launch counts per iteration (55 convs: K1
     109 times, `sparse_conv_dw` 55), one more validation through `test_on`,
     ms per train step and eval request in both conv forms, one f32 B=2 step
     against the CPU in both conv forms; a ResUNet14 and a ResNet14 f32
     forward (B=2) against the plain forward on the CPU; then an HRNetSeg3S
     trainer (1 epoch), `extract_split` of its train and test collections
     into a temporary directory, `midfc.run_training` `ssa`, `save_knn` and
     `csa` on those files (8 heads of 256, K=1, 10000 points in 500-point
     chunks, `--testing`: one batch per epoch), `get_csa_pred` on the result
     (f32 through the flash kernels, held to its own `--device cpu` run) and
     the launcher's `pred` mode; last the probes' own entry points
     (`probes.dyngather`, `dyngather2`, `iw_bwd` `main()`), which print the
     `timing onehot|smem|global` lines.
The line before the last is the kernel table as JSON: per kernel, its
launches in the train requests of phases 5, 6, 7, 8 and 9 (each phase sets
the counts to 0 before and reads them after; phase 9 counts the Res16UNet34C
train iterations, the chain and the probes' entry points), its worst error
over phase 3's checks, and four times summed over one train step's launches
of every path the kernel is on (bf16 at the HRNet and Res16UNet34C shapes,
f32 at the MID-FC shapes; the probe kernels: one call of
`probe_window_gather` at [384, 128] f32, the three modes of
`probe_gather_accum` with the bf16 window at 352 tiles x 9 offsets, the seven
variants of `probe_slot_load`):
the kernel's and the plain version's median ms, `bound_ms`, the least time
the card could take (the larger of bytes / 3.35 TB/s and operations / the
peak of the input type: 989 TFLOP/s bf16, 67 TFLOP/s f32, counting valid
rows and keys only), and `library_ms`, the time of the one PyTorch call
that computes the same function (`F.scaled_dot_product_attention` for the
attention kernels, timed here and used nowhere in the port; null where
there is no such call; `index_select` and `embedding_bag` for the two gather
probes). The last line is {"ok": true, "device": {...}}.

Protocol (the JAX package's bench.py): B=8 query shapes of 10000 points,
voxel 0.05, level-0 cap 5632, level caps shrinking 3x, k5 stem, d_model 256,
4 heads, 39 classes, activations in bf16; weights are random, drawn from a
seeded generator. Float32 products run without TF32 everywhere, in the
kernel-vs-plain checks as in the models.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from csn_tpu_torch import kernels
from csn_tpu_torch.config import Config
from csn_tpu_torch.core import (
    conv, interp, interp_window, native, window_conv,
)
from csn_tpu_torch.core.pyramid import concat_batches, map_levels, to_torch
from csn_tpu_torch.data import pipeline
from csn_tpu_torch.data.synthetic import (
    SurfaceShapeDataset, make_surface_shape,
)
from csn_tpu_torch.midfc import extraction, get_csa_pred, run_training
from csn_tpu_torch.midfc.training import (
    CHECKPOINT_NAME, MidfcConfig, MidfcRunner,
)
from csn_tpu_torch.models import (
    blocks, hrnet, load_model, res16unet, resnet, resunet,
)
from csn_tpu_torch.models.layers import SparseConv
from csn_tpu_torch.ops import attention, flash
from csn_tpu_torch.parallel.midfc import make_midfc_steps
from csn_tpu_torch.probes import dyngather, dyngather2, iw_bwd
from csn_tpu_torch.tasks import main_csn, main_seg
from csn_tpu_torch.train import optim
from csn_tpu_torch.train.steps import eval_step, train_step

B, P, VOXEL, K_NEIGHBORS = 8, 10000, 0.05, 1
LEVEL0_CAP, SHRINK, STEM_K = 5632, 3.0, 5
D_MODEL, N_HEAD, NUM_CLASSES = 256, 4, 39
N_REQUESTS, TIMED_STEPS, SEED = 3, 10, 0
ATTN_DROPOUT, LR = 0.1, 0.05
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max|ref|
# f32 train step, kernels on the GPU vs plain on the CPU: x max|ref| per
# gradient tensor
GRAD_TOL = 1e-3
# gradients that vanish analytically (a bias right before train-mode
# BatchNorm): held to GRAD_TOL x the largest gradient of the step
VANISHING = {"fc1.linear.bias"}

# the MID-FC protocol (the JAX package's bench.py, mode midfc)
MF_HEADS, MF_K, MF_B, MF_P, MF_D, MF_CHUNK = 8, 4, 4, 10000, 256, 500
MF_RING_B, MF_BLOCKS = 2, 4   # phase 7's batch; key blocks of phase 3's chain

HBM_BYTES_S = 3.35e12                       # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNELS = {
    "sparse_conv_fwd": ("csn_tpu_torch/csrc/sparse_conv.cu",
                        "csn_tpu/core/window_conv.py:973"),
    "sparse_conv_dw": ("csn_tpu_torch/csrc/sparse_conv_bwd.cu",
                       "csn_tpu/core/window_conv.py:1067"),
    "sparse_conv_im2col_fwd": ("csn_tpu_torch/csrc/sparse_conv_im2col.cu",
                               "csn_tpu/core/window_conv.py:1021"),
    "sparse_conv_im2col_bwd": ("csn_tpu_torch/csrc/sparse_conv_im2col_bwd.cu",
                               "csn_tpu/core/window_conv.py:1135"),
    "flash_attn_fwd": ("csn_tpu_torch/csrc/flash_attn.cu",
                       "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd": ("csn_tpu_torch/csrc/flash_attn_bwd.cu",
                       "csn_tpu/ops/flash.py:600"),
    "flash_attn_carry": ("csn_tpu_torch/csrc/flash_attn_carry.cu",
                         "csn_tpu/ops/flash.py:412"),
    "flash_attn_block_bwd": ("csn_tpu_torch/csrc/flash_attn_block_bwd.cu",
                             "csn_tpu/ops/flash.py:488"),
    "interp_fwd": ("csn_tpu_torch/csrc/interp.cu",
                   "csn_tpu/core/interp_window.py:288"),
    "interp_bwd": ("csn_tpu_torch/csrc/interp_bwd.cu",
                   "csn_tpu/core/interp_window.py:322"),
    "probe_window_gather": ("csn_tpu_torch/csrc/probe_gather.cu",
                            "scripts/probe_dyngather.py:37"),
    "probe_gather_accum": ("csn_tpu_torch/csrc/probe_gather.cu",
                           "scripts/probe_dyngather.py:109"),
    "probe_slot_load": ("csn_tpu_torch/csrc/probe_slots.cu",
                        "scripts/probe_iw_bwd.py:52"),
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


def build_requests(spec, dev, n_shapes=B, n_requests=N_REQUESTS, seed=SEED):
    """n_requests (query batch, key batch) pairs of n_shapes shapes each,
    each from its own seed."""
    reqs = []
    for r in range(n_requests):
        rng = np.random.default_rng(seed + 1000 * r)
        qb, kb = (pipeline.collate_shapes(
            [make_surface_shape(rng, P) for _ in range(n_shapes)],
            spec, rng=rng) for _ in range(K_NEIGHBORS + 1))
        reqs.append((qb, kb))
    if any(reqs[0][0].dropped[1:]):
        print(f"[batch] voxels dropped by the level caps in request 0's "
              f"query batch: {reqs[0][0].dropped}")
    return [(to_torch(q, dev), (to_torch(k, dev),)) for q, k in reqs]


class ReluDecisions:
    """Records which entries each masked ReLU of one forward passes, and
    makes another forward take the same decisions. A train step's gradient
    is only piecewise smooth: at full width a step has about 10^7 ReLU
    inputs, some within float32 rounding of zero, and each that falls on
    the other side on another device moves a conv's gradient by up to 1 %
    of its max (measured: a 1e-7 relative parameter noise moves the plain
    step's gradients by up to 1.2e-2 of their max, PERF.md). Replaying the
    GPU step's decisions on the CPU leaves only rounding between the two;
    `flips` counts the decisions the CPU forward would have taken
    otherwise."""

    def __init__(self):
        self.masks = []
        self.flips = 0
        self.inputs = 0

    def _record(self, x, mask):
        keep = mask[..., None] & (x > 0)
        self.masks.append(keep.cpu())
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    def _replay(self, x, mask):
        keep = self.masks[self._next].to(x.device)
        self._next += 1
        self.flips += int((keep != (mask[..., None] & (x > 0))).sum())
        self.inputs += int(mask.sum()) * x.shape[-1]
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    @contextlib.contextmanager
    def active(self, replay: bool):
        """Within: the models' masked ReLU records (replay False) or
        replays (replay True) the decisions."""
        self._next = 0
        fn = self._replay if replay else self._record
        mods = (blocks, hrnet, res16unet, resunet, resnet)
        saved = [m.relu_masked for m in mods]
        for m in mods:
            m.relu_masked = fn
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.relu_masked = f


def make_model(cls, dtype: str, attn_dropout: float):
    kw = {}
    if issubclass(cls, hrnet.HRNetSimCSN):
        kw = dict(d_model=D_MODEL, n_head=N_HEAD, k_neighbors=K_NEIGHBORS,
                  attn_dropout=attn_dropout)
    model = cls(out_channels=NUM_CLASSES, conv1_kernel_size=STEM_K,
                compute_dtype=dtype, **kw)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


class Table:
    """Per-kernel results for the JSON kernel line."""

    def __init__(self):
        self.err = {k: 0.0 for k in KERNELS}
        self.ms = {k: 0.0 for k in KERNELS}
        self.plain_ms = {k: 0.0 for k in KERNELS}
        self.bound_ms = {k: 0.0 for k in KERNELS}
        self.bound_bytes_ms = {k: 0.0 for k in KERNELS}
        self.bound_ops_ms = {k: 0.0 for k in KERNELS}
        self.library_ms = {k: None for k in KERNELS}

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

    def time(self, name, what, fn_kernel, fn_plain, count=1, reps=7, *,
             nbytes, flops, dtype=torch.bfloat16, fn_library=None):
        """Median ms of the kernel and its plain version, the call's bound
        (`nbytes` moved once over the memory rate, `flops` over the peak of
        `dtype`) and, with `fn_library`, the median ms of the one PyTorch
        call that computes the same function; all added `count` times to
        the train step's totals."""
        ms = median_ms(fn_kernel)
        pms = median_ms(fn_plain, warmup=1, reps=reps)
        b_ms = nbytes / HBM_BYTES_S * 1e3
        o_ms = flops / PEAK_FLOPS[dtype] * 1e3
        line = (f"[time] {name} {what} {str(dtype)[6:]}: kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms, bound {max(b_ms, o_ms):.4f} ms "
                f"({'bytes' if b_ms >= o_ms else 'operations'}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if fn_library is not None:
            lms = median_ms(fn_library, warmup=1, reps=reps)
            line += f", library {lms:.4f} ms"
            self.library_ms[name] = (self.library_ms[name] or 0.0) \
                + count * lms
        print(f"{line} (x{count} per train step)")
        self.ms[name] += count * ms
        self.plain_ms[name] += count * pms
        self.bound_ms[name] += count * max(b_ms, o_ms)
        self.bound_bytes_ms[name] += count * b_ms
        self.bound_ops_ms[name] += count * o_ms

    def bound(self, name):
        """(bound_ms, bound_by) of the kernel's launches of one train step:
        each call's bound is the larger of its two times; `bound_by` names
        the larger share of the total."""
        by = "bytes" if self.bound_bytes_ms[name] >= self.bound_ops_ms[name] \
            else "operations"
        return self.bound_ms[name], by


def conv_work(kmap, n_in, cin, cout, es, out_es):
    """(bytes, flops) of one sparse conv over `kmap` [K, N_out] from n_in
    source rows: features, map, weights and output moved once; two
    operations per (valid map entry, cin, cout). The same count holds for
    the dW reduction over the transpose map (out_es 4: dW is f32)."""
    k, n_out = kmap.shape
    nnz = int((kmap < n_in).sum())
    return (n_in * cin * es + k * n_out * 4 + k * cin * cout * out_es
            + n_out * cout * es, 2 * nnz * cin * cout)


def conv_bwd_work(kmap_t, n_g, cin, cout, es, input_grad):
    """(bytes, flops) of the fused im2col backward over `kmap_t` [K, N_in]
    from n_g gradient rows: features, gradient (once), map and f32 dW moved
    once, and with `input_grad` the stacked weights and d_feats; two
    operations per (valid map entry, cin, cout) for dW and two for
    d_feats."""
    k, n_in = kmap_t.shape
    nnz = int((kmap_t < n_g).sum())
    nbytes = (n_in * cin * es + n_g * cout * es + k * n_in * 4
              + k * cin * cout * 4)
    if input_grad:
        nbytes += k * cin * cout * es + n_in * cin * es
    return nbytes, 2 * nnz * cin * cout * (2 if input_grad else 1)


def check_convs(model, big, dev, table, g, timed=True):
    """K1 forward and on the transpose map, and `sparse_conv_dw`, at every
    (map, Cin, Cout) the model runs; on the same inputs the im2col pair
    (`CSN_DYNG=2/3`) against its plain versions and against K1 /
    `sparse_conv_dw`; with `timed`, each family's bf16 times are added to
    the table. Returns the number of convs."""
    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv):
            key = (m.map_name, *m.kernel.shape[1:])
            convs[key] = convs.get(key, 0) + 1
    stem = (model.conv0.map_name, *model.conv0.kernel.shape[1:])
    for (name, cin, cout), count in sorted(convs.items()):
        kmap = big.kmaps[name]
        t_name, mirror = conv.transpose_map_name(name)
        kmap_t = big.kmaps[t_name]
        n_in = big.masks[map_levels(name)[0]].numel()
        n_dfeats = count - int((name, cin, cout) == stem)  # stem: none
        feats = torch.randn(n_in, cin, generator=g).to(dev)
        w = ((torch.rand(kmap.shape[0], cin, cout, generator=g) * 2 - 1)
             / (cin * kmap.shape[0]) ** 0.5).to(dev)
        grad = torch.randn(kmap.shape[1], cout, generator=g).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            f, wt, gd = feats.to(dt), w.to(dt), grad.to(dt)
            w_t = (wt.flip(0) if mirror else wt).transpose(1, 2).contiguous()
            what = f"{name} {cin}->{cout} N_out={kmap.shape[1]}"
            table.check("sparse_conv_fwd", what,
                        window_conv.sparse_conv_fwd(f, kmap, wt),
                        conv.conv_plain(f, kmap, wt), dt)
            ref_df, ref_dw = conv.conv_bwd_plain(f, gd, kmap_t, wt.float(),
                                                 mirror, n_dfeats > 0)
            got_df, got_dw = conv.conv_bwd_kernels(f, gd, kmap_t, wt.float(),
                                                   mirror, n_dfeats > 0)
            if n_dfeats:
                table.check("sparse_conv_fwd", f"d_feats over {t_name} "
                            f"{cout}->{cin} N_out={n_in}", got_df, ref_df, dt)
            table.check("sparse_conv_dw", f"{what} ({t_name}, mirror "
                        f"{mirror})", got_dw, ref_dw, dt)
            # the im2col pair on the same inputs: against its plain versions
            # and against K1 / sparse_conv_dw (another order of the same sum)
            fwd = "sparse_conv_im2col_fwd"
            bwd = "sparse_conv_im2col_bwd"
            got = window_conv.sparse_conv_im2col_fwd(f, kmap, wt)
            table.check(fwd, what, got, conv.conv_im2col_plain(f, kmap, wt),
                        dt)
            table.check(fwd, f"{what} vs K1", got,
                        window_conv.sparse_conv_fwd(f, kmap, wt), dt)
            pl_df, pl_dw = conv.conv_im2col_bwd_plain(
                f, gd, kmap_t, wt.float(), mirror, n_dfeats > 0)
            im_df, im_dw = conv.conv_im2col_bwd_kernels(
                f, gd, kmap_t, wt.float(), mirror, n_dfeats > 0)
            btag = (f"{what} ({t_name}, mirror {mirror}, "
                    f"dw_only {n_dfeats == 0})")
            if n_dfeats:
                table.check(bwd, f"{btag} d_feats", im_df, pl_df, dt)
                table.check(bwd, f"{btag} d_feats vs K1", im_df, got_df, dt)
            else:
                require(im_df is None, f"{bwd} {btag}: d_feats under dw_only")
            table.check(bwd, f"{btag} dW", im_dw, pl_dw, dt)
            table.check(bwd, f"{btag} dW vs sparse_conv_dw", im_dw, got_dw,
                        dt)
            del ref_df, ref_dw, got_df, got_dw, got, pl_df, pl_dw, im_df, \
                im_dw
            if dt != torch.bfloat16 or not timed:
                continue
            nb, fl = conv_work(kmap, n_in, cin, cout, 2, 2)
            table.time("sparse_conv_fwd", what,
                       lambda: window_conv.sparse_conv_fwd(f, kmap, wt),
                       lambda: conv.conv_plain(f, kmap, wt), count,
                       nbytes=nb, flops=fl)
            if n_dfeats:
                nb, fl = conv_work(kmap_t, kmap.shape[1], cout, cin, 2, 2)
                table.time("sparse_conv_fwd", f"d_feats over {t_name}",
                           lambda: window_conv.sparse_conv_fwd(gd, kmap_t,
                                                               w_t),
                           lambda: conv.conv_plain(gd, kmap_t, w_t), n_dfeats,
                           nbytes=nb, flops=fl)
            # dW reads the features and the output gradient, writes f32
            nb, fl = conv_work(kmap_t, kmap.shape[1], cout, cin, 2, 4)
            table.time("sparse_conv_dw", what,
                       lambda: window_conv.sparse_conv_dw(f, gd, kmap_t),
                       lambda: conv.conv_bwd_plain(f, gd, kmap_t, wt.float(),
                                                   mirror, False), count,
                       reps=3, nbytes=nb, flops=fl)
            nb, fl = conv_work(kmap, n_in, cin, cout, 2, 2)
            table.time(fwd, what,
                       lambda: window_conv.sparse_conv_im2col_fwd(f, kmap,
                                                                  wt),
                       lambda: conv.conv_im2col_plain(f, kmap, wt), count,
                       reps=3, nbytes=nb, flops=fl)
            # stem: dW only; every other conv of the family: both gradients
            for with_df, n in ((True, n_dfeats), (False, count - n_dfeats)):
                if not n:
                    continue
                nb, fl = conv_bwd_work(kmap_t, kmap.shape[1], cin, cout, 2,
                                       with_df)
                table.time(bwd, f"{what} dw_only {not with_df}",
                           lambda: conv.conv_im2col_bwd_kernels(
                               f, gd, kmap_t, wt.float(), mirror, with_df),
                           lambda: conv.conv_im2col_bwd_plain(
                               f, gd, kmap_t, wt.float(), mirror, with_df),
                           n, reps=3, nbytes=nb, flops=fl)
        torch.cuda.empty_cache()
    return sum(convs.values())


def attention_work(qm, km, n_head, dk, es):
    """(bytes forward, bytes backward, flops forward, flops backward) of
    masked attention at q [b, H, Lq, dk], k / v [b, H, Lk, dk]: every
    tensor moved once (q, k, v, out and the f32 lse forward; q, k, v, dout,
    lse, delta, dq, dk, dv backward); two products of 2 * dk operations per
    (valid query, valid key, head) pair forward, five backward."""
    b, lq = qm.shape
    lk = km.shape[1]
    pairs = int((qm.sum(dim=1) * km.sum(dim=1)).sum()) * n_head
    rows_q, rows_k = b * n_head * lq, b * n_head * lk
    fwd_b = (2 * rows_q + 2 * rows_k) * dk * es + rows_q * 4 + b * (lq + lk)
    bwd_b = (3 * rows_q + 4 * rows_k) * dk * es + rows_q * 8 + b * (lq + lk)
    return fwd_b, bwd_b, 4 * pairs * dk, 10 * pairs * dk


def check_flash(table, dev, g, what, qm, km, n_head, dk, time_dt, count):
    """K2 at dropout 0 and ATTN_DROPOUT and its backward kernel at q
    [b, n_head, Lq, dk] against k, v [b, n_head, Lk, dk] under the masks qm,
    km, in f32 and bf16; timed in `time_dt` at dropout ATTN_DROPOUT (the
    train path's call, `count` per train step), beside the library call
    `F.scaled_dot_product_attention` with the key mask at dropout 0."""
    temp = float(dk) ** 0.5
    seed = 0x5EED_0F_C5A
    b, L = qm.shape
    q, dout = (torch.randn(b, n_head, L, dk, generator=g).to(dev)
               for _ in range(2))
    k, v = (torch.randn(b, n_head, km.shape[1], dk, generator=g).to(dev)
            for _ in range(2))
    valid = qm[:, None, :, None]
    dout = dout * valid   # padded query rows carry no gradient
    shape = f"{what} [{b},{n_head},{L},{dk}]"
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd, dod = (x.to(dt) for x in (q, k, v, dout))
        for drop in (0.0, ATTN_DROPOUT):
            sd = seed if drop else None
            tag = f"{shape} dropout {drop}"
            out, lse = flash.flash_attention(qd, kd, vd, km, qm, temp,
                                             drop, sd)
            ref, ref_lse = attention.scaled_dot_product_attention(
                qd, kd, vd, km, temp, dropout=drop, seed=sd,
                return_lse=True)
            table.check("flash_attn_fwd", tag, out, ref, dt, valid)
            table.check("flash_attn_fwd", tag + " lse", lse, ref_lse, dt,
                        valid[..., 0])
            del ref, ref_lse
            delta = (dod.float() * out.float()).sum(dim=-1)
            got = flash.flash_attention_bwd(qd, kd, vd, dod, lse, delta,
                                            km, qm, temp, drop, sd)
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (qd, kd, vd)]
            plain = attention.scaled_dot_product_attention(
                *leaves, km, temp, dropout=drop, seed=sd)
            refs = torch.autograd.grad(plain, leaves, dod,
                                       retain_graph=True)
            for nm, gk, gr, vm in zip(("dq", "dk", "dv"), got, refs,
                                      (valid, None, None)):
                table.check("flash_attn_bwd", f"{tag} {nm}", gk, gr, dt,
                            vm)
            del got, refs
            if dt == time_dt and drop:   # the train path's call
                fb, bb, ff, bf = attention_work(qm, km, n_head, dk,
                                                qd.element_size())
                # the library call: one fused attention with the key mask
                lib = F.scaled_dot_product_attention(
                    *leaves, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp)
                table.time(
                    "flash_attn_fwd", tag,
                    lambda: flash.flash_attention(qd, kd, vd, km, qm,
                                                  temp, drop, sd),
                    lambda: attention.scaled_dot_product_attention(
                        qd, kd, vd, km, temp, dropout=drop, seed=sd),
                    count, reps=3, nbytes=fb, flops=ff, dtype=dt,
                    fn_library=lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=km[:, None, None, :],
                        scale=1.0 / temp))
                table.time(
                    "flash_attn_bwd", tag,
                    lambda: flash.flash_attention_bwd(
                        qd, kd, vd, dod, lse, delta, km, qm, temp, drop,
                        sd),
                    lambda: torch.autograd.grad(plain, leaves, dod,
                                                retain_graph=True),
                    count, reps=3, nbytes=bb, flops=bf, dtype=dt,
                    fn_library=lambda: torch.autograd.grad(
                        lib, leaves, dod, retain_graph=True))
                del lib
            del out, lse, delta, plain, leaves
            torch.cuda.empty_cache()


def check_attention(qb, kb, big, dev, table, g):
    """K2 and its backward at the HRNet SSA (combined pass) and CSA (query
    against key) shapes, and at the MID-FC chunk shape (80 chunks of 500
    points, 8 heads of 256, 9 calls per CSA train step)."""
    dk = D_MODEL // N_HEAD
    bmask, qmask, kmask = big.masks[0], qb.masks[0], kb.masks[0]
    check_flash(table, dev, g, "SSA", bmask, bmask, N_HEAD, dk,
                torch.bfloat16, 1)
    check_flash(table, dev, g, "CSA", qmask, kmask, N_HEAD, dk,
                torch.bfloat16, 1)
    ones = torch.ones(MF_B * MF_P // MF_CHUNK, MF_CHUNK, dtype=torch.bool,
                      device=dev)
    check_flash(table, dev, g, "MID-FC chunks", ones, ones, MF_HEADS, MF_D,
                torch.float32, 2 * MF_K + 1)


def check_ring_kernels(dev, table, g):
    """`flash_attn_carry` chained over MF_BLOCKS key blocks at phase 7's
    shape against `online_block_update` chained the same way and against
    one K2 pass over all keys; `flash_attn_block_bwd` on every block
    against `block_backward_plain` on that block, and summed over the
    blocks against one `flash_attn_bwd` call. The backward's inputs (out,
    lse) are the plain chain's, so no kernel's output feeds a check of
    another. One chain cuts the keys unevenly, at columns that are no
    multiple of 4 (a block then starts inside a 4-column Philox group), and
    checks a slice of the query rows at its row offset. The one call over
    all keys that phase 7 makes (a ring of one) is held against the plain
    chains too, and timed in f32 at dropout ATTN_DROPOUT."""
    b, h, L, dk = MF_RING_B, MF_HEADS, MF_P, MF_D
    temp = float(dk) ** 0.5
    seed = 0x5EED_0F_C5A + 1
    lb = L // MF_BLOCKS
    even = tuple(range(0, L + 1, lb))
    uneven = (0, lb + 1, 2 * lb - 1, 3 * lb + 2, L)   # starts at 1, 3, 2 mod 4
    q, k, v, dout = (torch.randn(b, h, L, dk, generator=g).to(dev)
                     for _ in range(4))
    full = torch.ones(b, L, dtype=torch.bool, device=dev)
    ragged = full.clone()   # a masked tail, and one fully masked key block
    ragged[0, L - 777:] = False
    ragged[1, lb:2 * lb] = False
    for dt, drop, km, mtag, cuts in (
            (torch.float32, 0.0, full, "unmasked", even),
            (torch.float32, ATTN_DROPOUT, ragged, "masked", even),
            (torch.bfloat16, ATTN_DROPOUT, ragged, "masked", even),
            (torch.float32, ATTN_DROPOUT, ragged, "masked", uneven)):
        qd, kd, vd, dod = (x.to(dt) for x in (q, k, v, dout))
        sd = seed if drop else None
        sizes = f"{lb}" if cuts is even else f"cuts {cuts[1:-1]}"
        tag = (f"[{b},{h},{L},{dk}] x {MF_BLOCKS} blocks of {sizes} {mtag} "
               f"dropout {drop}")
        blocks_ = [(c0, kd[:, :, c0:c1].contiguous(),
                    vd[:, :, c0:c1].contiguous(), km[:, c0:c1].contiguous())
                   for c0, c1 in zip(cuts, cuts[1:])]
        carry = flash.flash_carry_init(b, h, L, dk, dev)
        plain = flash.flash_carry_init(b, h, L, dk, dev)
        qt = (qd / temp).float()
        for c0, kb_, vb_, mb_ in blocks_:
            carry = flash.flash_forward_carry(qd, kb_, vb_, mb_, None, carry,
                                              temp, drop, sd, col_offset=c0)
            plain = attention.online_block_update(plain, qt, kb_, vb_, mb_,
                                                  drop, sd, col_offset=c0)
        for nm, a, r in zip(("m", "l", "acc"), carry, plain):
            table.check("flash_attn_carry", f"{tag} carry {nm} vs plain "
                        f"chain", a, r, dt)
        out_c, lse_c = flash.flash_carry_finalize(carry)
        out_p, lse = flash.flash_carry_finalize(plain)
        out = out_p.to(dt)
        del carry, out_p
        out_k2, lse_k2 = flash.flash_attention(qd, kd, vd, km, full, temp,
                                               drop, sd)
        table.check("flash_attn_carry", f"{tag} out vs one K2 pass",
                    out_c.to(dt), out_k2, dt)
        table.check("flash_attn_carry", f"{tag} lse vs one K2 pass", lse_c,
                    lse_k2, dt)
        del out_c, lse_c, out_k2, lse_k2
        delta = (dod.float() * out.float()).sum(dim=-1)
        ref = flash.flash_attention_bwd(qd, kd, vd, dod, lse, delta, km,
                                        full, temp, drop, sd)
        dq = torch.zeros(qd.shape, dtype=torch.float32, device=dev)
        dq_p = torch.zeros_like(dq)
        dks, dvs, dks_p, dvs_p = [], [], [], []
        for i, (c0, kb_, vb_, mb_) in enumerate(blocks_):
            got = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0, delta=delta)
            want = flash.block_backward_plain(
                qd, kb_, vb_, mb_, lse, delta, dod, temp, drop, sd,
                col_offset=c0)
            for nm, a, r in zip(("dq", "dk", "dv"), got, want):
                table.check("flash_attn_block_bwd", f"{tag} block {i} at "
                            f"column {c0} {nm} vs plain", a, r, dt)
            dq += got[0]
            dq_p += want[0]
            dks.append(got[1])
            dvs.append(got[2])
            dks_p.append(want[1])
            dvs_p.append(want[2])
            del got, want
        sums = (dq, torch.cat(dks, 2), torch.cat(dvs, 2))
        sums_p = (dq_p, torch.cat(dks_p, 2), torch.cat(dvs_p, 2))
        for nm, a, r in zip(("dq", "dk", "dv"), sums, ref):
            table.check("flash_attn_block_bwd", f"{tag} {nm} vs one "
                        f"flash_attn_bwd call", a, r, dt)
        del dq, dks, dvs, dq_p, dks_p, dvs_p, ref, sums
        if cuts is uneven:
            # a slice of the query rows against one key block, both at
            # their offsets in the global score matrix
            r0, r1 = cuts[1], cuts[2]
            c0, kb_, vb_, mb_ = blocks_[2]
            otag = (f"[{b},{h},{r1 - r0},{dk}] rows at {r0} x keys at {c0} "
                    f"{mtag} dropout {drop}")
            qs, dos = (x[:, :, r0:r1].contiguous() for x in (qd, dod))
            init = flash.flash_carry_init(b, h, r1 - r0, dk, dev)
            got = flash.flash_forward_carry(
                qs, kb_, vb_, mb_, None, init, temp, drop, sd,
                row_offset=r0, col_offset=c0)
            want = attention.online_block_update(
                init, (qs / temp).float(), kb_, vb_, mb_, drop, sd,
                row_offset=r0, col_offset=c0)
            for nm, a, r in zip(("m", "l", "acc"), got, want):
                table.check("flash_attn_carry", f"{otag} carry {nm} vs "
                            f"plain", a, r, dt)
            lse_s = lse[:, :, r0:r1].contiguous()
            delta_s = delta[:, :, r0:r1].contiguous()
            got = flash.flash_block_backward(
                qs, kb_, vb_, mb_, out[:, :, r0:r1].contiguous(), lse_s, dos,
                temp, drop, sd, row_offset=r0, col_offset=c0, delta=delta_s)
            want = flash.block_backward_plain(
                qs, kb_, vb_, mb_, lse_s, delta_s, dos, temp, drop, sd,
                row_offset=r0, col_offset=c0)
            for nm, a, r in zip(("dq", "dk", "dv"), got, want):
                table.check("flash_attn_block_bwd", f"{otag} {nm} vs plain",
                            a, r, dt)
            del got, want, init, qs, dos
            # The f32 plain version and the kernel do the same operations
            # in the same order (sequential f32 FMAs over the reduced axis,
            # the same exp), so they can agree bit for bit. A float64
            # reference on batch row 0, heads 0-1 bounds both, and the
            # kernel given a wrong column offset must disagree.
            hs = (slice(0, 1), slice(0, 2))
            got = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0, delta=delta)
            want = flash.block_backward_plain(
                qd, kb_, vb_, mb_, lse, delta, dod, temp, drop, sd,
                col_offset=c0)
            ref64 = flash.block_backward_plain(
                qd[hs].double(), kb_[hs].double(), vb_[hs].double(), mb_[:1],
                lse[hs], delta[hs], dod[hs].double(), temp, drop, sd,
                col_offset=c0, compute_dtype=torch.float64)
            off = flash.flash_block_backward(
                qd, kb_, vb_, mb_, out, lse, dod, temp, drop, sd,
                col_offset=c0 + 1, delta=delta)
            for nm, a, r, r64, o in zip(("dq", "dk", "dv"), got, want, ref64,
                                        off):
                err = (a[hs].double() - r64).abs().max().item()
                perr = (r[hs].double() - r64).abs().max().item()
                oerr = (o - r).abs().max().item()
                scale = r64.abs().max().item()
                ok = err <= TOL[dt] * scale and oerr > 100 * TOL[dt] * scale
                print(f"[check] flash_attn_block_bwd block at column {c0} "
                      f"{nm} vs float64 (batch row 0, heads 0-1): kernel "
                      f"{err:.3e}, plain {perr:.3e}, tol "
                      f"{TOL[dt] * scale:.3e} (max|ref| {scale:.3e}); kernel "
                      f"at column offset {c0 + 1} vs plain at {c0}: "
                      f"{oerr:.3e}, must exceed {100 * TOL[dt] * scale:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                require(ok, f"flash_attn_block_bwd {nm}: float64 reference "
                        f"or wrong-offset check failed")
                table.err["flash_attn_block_bwd"] = max(
                    table.err["flash_attn_block_bwd"], err)
            del got, want, ref64, off
        if dt == torch.float32 and drop and cuts is even:   # phase 7's calls
            fb, bb, ff, bf = attention_work(full, km, h, dk, 4)
            cin = flash.flash_carry_init(b, h, L, dk, dev)
            c_bytes = 2 * sum(c.numel() * 4 for c in cin)  # carry in, out
            atag = f"[{b},{h},{L},{dk}] all keys {mtag} dropout {drop}"
            got = flash.flash_forward_carry(qd, kd, vd, km, None, cin, temp,
                                            drop, sd)
            for nm, a, r in zip(("m", "l", "acc"), got, plain):
                table.check("flash_attn_carry", f"{atag} one call, carry "
                            f"{nm} vs plain chain", a, r, dt)
            got = flash.flash_block_backward(qd, kd, vd, km, out, lse, dod,
                                             temp, drop, sd, delta=delta)
            for nm, a, r in zip(("dq", "dk", "dv"), got, sums_p):
                table.check("flash_attn_block_bwd", f"{atag} one call, {nm} "
                            f"vs plain chain", a, r, dt)
            del got

            def plain_chain():
                c = flash.flash_carry_init(b, h, L, dk, dev)
                for c0, kb_, vb_, mb_ in blocks_:
                    c = attention.online_block_update(c, qt, kb_, vb_, mb_,
                                                      drop, sd, col_offset=c0)
                return c

            def plain_bwd_chain():
                return [flash.block_backward_plain(
                    qd, kb_, vb_, mb_, lse, delta, dod, temp, drop, sd,
                    col_offset=c0) for c0, kb_, vb_, mb_ in blocks_]

            table.time(
                "flash_attn_carry", atag,
                lambda: flash.flash_forward_carry(qd, kd, vd, km, None, cin,
                                                  temp, drop, sd),
                plain_chain, reps=3,
                # q, k, v and the masks in; the carry in and out; no out, lse
                nbytes=fb - b * h * L * 4 * (dk + 1) + c_bytes,
                flops=ff, dtype=dt,
                fn_library=lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=km[:, None, None, :],
                    scale=1.0 / temp))
            print(f"[time] flash_attn_carry, flash_attn_block_bwd: the plain "
                  f"versions walk the keys in {MF_BLOCKS} blocks (all keys "
                  f"at once would hold a [{b},{h},{L},{L}] f32 score matrix)")
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (qd, kd, vd)]
            lib = F.scaled_dot_product_attention(
                *leaves, attn_mask=km[:, None, None, :], scale=1.0 / temp)
            table.time(
                "flash_attn_block_bwd", atag,
                lambda: flash.flash_block_backward(
                    qd, kd, vd, km, out, lse, dod, temp, drop, sd,
                    delta=delta),
                plain_bwd_chain, reps=3, nbytes=bb, flops=bf, dtype=dt,
                fn_library=lambda: torch.autograd.grad(
                    lib, leaves, dod, retain_graph=True))
            del lib, leaves, cin
        del out, lse, delta, blocks_, plain, sums_p
        torch.cuda.empty_cache()


def check_interp(qb, dev, table, g):
    """K3 and its backward kernel on the query batch's readout."""
    n0 = qb.masks[0].numel()
    flat = torch.randn(n0, NUM_CLASSES, generator=g).to(dev)
    idx = qb.interp_idx.reshape(-1, 8)
    w8 = qb.interp_w.reshape(-1, 8)
    grad = torch.randn(idx.shape[0], NUM_CLASSES, generator=g).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        fl, gd = flat.to(dt), grad.to(dt)
        what = f"[{n0},{NUM_CLASSES}] -> [{idx.shape[0]},{NUM_CLASSES}]"
        table.check("interp_fwd", what, interp_window.interp_fwd(fl, idx, w8),
                    interp.interpolate_to_points(fl, idx[None], w8[None])[0],
                    dt)
        bwd = f"[{idx.shape[0]},{NUM_CLASSES}] -> [{n0},{NUM_CLASSES}]"
        table.check("interp_bwd", bwd,
                    interp_window.interp_bwd(gd, qb.interp_ptr, qb.interp_ent,
                                             w8),
                    interp.interp_bwd_plain(gd, idx, w8, n0), dt)
        if dt == torch.bfloat16:
            # both move the voxel and point features once and the 8-corner
            # tables (int32 index or CSR entry + f32 weight per corner)
            nb = (n0 + idx.shape[0]) * NUM_CLASSES * 2 + idx.numel() * 8
            nnz = int((idx < n0).sum())
            table.time("interp_fwd", what,
                       lambda: interp_window.interp_fwd(fl, idx, w8),
                       lambda: interp.interpolate_to_points(fl, idx[None],
                                                            w8[None]),
                       nbytes=nb, flops=2 * nnz * NUM_CLASSES)
            table.time("interp_bwd", bwd,
                       lambda: interp_window.interp_bwd(
                           gd, qb.interp_ptr, qb.interp_ent, w8),
                       lambda: interp.interp_bwd_plain(gd, idx, w8, n0),
                       nbytes=nb + (n0 + 1) * 4, flops=2 * nnz * NUM_CLASSES)


def check_point_outputs(tag, loss, point_logits, pred, qb):
    valid = qb.point_mask
    require(bool(torch.isfinite(loss)), f"{tag}: loss {loss}")
    if point_logits is not None:
        require(point_logits.shape == (B, P, NUM_CLASSES)
                and bool(torch.isfinite(point_logits[valid]).all()),
                f"{tag}: bad point logits")
    require(pred.shape == (B, P), f"{tag}: predictions {tuple(pred.shape)}")
    p = pred[valid]
    require(int(p.min()) >= 1 and int(p.max()) <= NUM_CLASSES - 1,
            f"{tag}: predictions outside [1, {NUM_CLASSES - 1}]")
    return (f"loss {float(loss):.6f}, {int(valid.sum())} points, pred in "
            f"[{int(p.min())}, {int(p.max())}]")


def require_launches(tag, launches, expect, n_requests=N_REQUESTS):
    """Every kernel launched exactly as often as `expect` says per request
    (a kernel that `expect` does not name: never)."""
    print(f"[{tag}] launches over {n_requests} requests: {launches} "
          f"(expected per request: {expect})")
    for name, got in launches.items():
        want = n_requests * expect.get(name, 0)
        require(got == want,
                f"{tag}: {name} {got} launches, expected {want}")


def time_steps(tag, step, what=f"B={B}, K={K_NEIGHBORS}, bf16", n_shapes=B,
               timed_steps=TIMED_STEPS):
    """ms/step of `step()` over `timed_steps` after 2 warm-up steps, and the
    peak device memory of the timed steps."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {ms:.3f} ms/step over {timed_steps} steps ({what}), "
          f"{n_shapes / ms * 1e3:.3f} query shapes/s, peak memory "
          f"{peak / 2 ** 30:.3f} GiB")


def profile_steps(tag, step, n_steps=3):
    """Device busy share and device time by kernel over `n_steps` of
    `step()`, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    rows = [(e.device_time_total / 1e3 / n_steps, e.count // n_steps, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {tag}: {wall_ms:.1f} ms/step wall under the profiler, "
          f"{busy:.1f} ms/step device time ({100 * busy / wall_ms:.1f} % "
          f"busy)")
    for ms, n, key in rows[:12]:
        print(f"[profile] {tag}: {ms:9.3f} ms/step {100 * ms / busy:5.1f} % "
              f"x{n:<4d} {key[:90]}")


def eval_slice(cls, reqs, dev, n_convs):
    model = make_model(cls, "bfloat16", ATTN_DROPOUT).eval().to(dev)
    kernels.reset_launches()
    for r, (qb, keys) in enumerate(reqs):
        loss, point_logits, pred = eval_step(model, qb, keys)
        print(f"[slice] request {r}: "
              f"{check_point_outputs(f'eval {r}', loss, point_logits, pred, qb)}")
    torch.cuda.synchronize()
    require_launches("slice", dict(kernels.LAUNCHES),
                     {"sparse_conv_fwd": n_convs, "flash_attn_fwd": 2,
                      "interp_fwd": 1})
    qb, keys = reqs[0]
    time_steps("slice", lambda: eval_step(model, qb, keys))

    # the f32 forward through the kernels against the plain forward (CPU)
    m32 = make_model(cls, "float32", ATTN_DROPOUT).eval().to(dev)
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


def f32_step_check(cls, spec, dev, tag, mode=None):
    """One f32 train step at dropout 0 on B=2 shapes with the kernels on
    the GPU (under `CSN_DYNG=mode`) against the same step with the plain
    versions on the CPU (`CSN_DYNG` unset): loss and every gradient, the
    CPU step taking the GPU step's ReLU decisions (`ReluDecisions`)."""
    (qh, kh), = build_requests(spec, "cpu", n_shapes=2, n_requests=1,
                               seed=SEED + 7)
    if not issubclass(cls, hrnet.HRNetSimCSN):
        kh = ()   # a plain segmentation model takes no key batches
    init = make_model(cls, "float32", 0.0).state_dict()
    relus = ReluDecisions()
    res = []
    for replay, where in enumerate((dev, "cpu")):
        m32 = make_model(cls, "float32", 0.0)
        m32.load_state_dict(init)
        m32.to(where)
        opt = optim.make_optimizer(m32.parameters(), "SGD", lr=LR)
        t0 = time.perf_counter()
        kernels.reset_launches()
        with relus.active(replay=bool(replay)), \
                window_conv.dyng(None if replay else mode):
            loss, _ = train_step(m32, opt, qh.to(where),
                                 tuple(k.to(where) for k in kh),
                                 torch.Generator())
        res.append((float(loss), {n: p.grad.detach().cpu() for n, p in
                                  m32.named_parameters()}))
        print(f"[{tag}] f32 B=2 step on {where} (CSN_DYNG "
              f"{None if replay else mode}): loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s), launches "
              f"{ {k: n for k, n in kernels.LAUNCHES.items() if n} }")
    (lg, gg), (lc, gc) = res
    print(f"[{tag}] ReLU decisions of the GPU step replayed on the CPU: "
          f"{relus.flips} of {relus.inputs} would have differed")
    require(abs(lg - lc) <= GRAD_TOL * abs(lc),
            f"{tag} f32 train step: loss {lg} on the GPU, {lc} on the CPU")
    top = max(float(t.abs().max()) for t in gc.values())
    worst = (0.0, "")
    for name, ref in gc.items():
        scale = top if name in VANISHING else float(ref.abs().max())
        err = float((gg[name] - ref).abs().max())
        require(err <= GRAD_TOL * scale,
                f"{tag} f32 train step: gradient of {name} off by {err:.3e} "
                f"(tol {GRAD_TOL * scale:.3e})")
        worst = max(worst, (err / max(scale, 1e-30), name))
    print(f"[{tag}] f32 gradients, kernels on the GPU vs plain on the CPU: "
          f"{len(gc)} tensors, worst max_abs_err / max|ref| {worst[0]:.3e} "
          f"({worst[1]}), tol {GRAD_TOL:.0e}; loss {lg:.6f} vs {lc:.6f}")


def train_slice(cls, spec, reqs, dev, n_convs, n_stems):
    """Phase 5. Returns the launch counts of the 3 train requests."""
    model = make_model(cls, "bfloat16", ATTN_DROPOUT).to(dev)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR)
    gen = torch.Generator().manual_seed(SEED)
    kernels.reset_launches()
    for r, (qb, keys) in enumerate(reqs):
        loss, pred = train_step(model, opt, qb, keys, gen)
        print(f"[train] request {r}: "
              f"{check_point_outputs(f'train {r}', loss, None, pred, qb)}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require_launches("train", launches, {
        "sparse_conv_fwd": 2 * n_convs - n_stems, "sparse_conv_dw": n_convs,
        "flash_attn_fwd": 2, "flash_attn_bwd": 2, "interp_fwd": 1,
        "interp_bwd": 1})
    qb, keys = reqs[0]
    time_steps("train", lambda: train_step(model, opt, qb, keys, gen))
    del model, opt
    torch.cuda.empty_cache()

    f32_step_check(cls, spec, dev, "train")
    return launches


def midfc_data(n_shapes, seed):
    """Seeded numpy MID-FC inputs at the protocol's sizes: features
    [B, P, 256], neighbor features [B, K+1, P, 256], labels [B, P] in
    [0, C). Every shape's points are drawn around a mean of its own, as a
    backbone's features of different shapes are: the mean-pooled
    descriptors then differ between shapes and the compatibility softmax
    is not uniform."""
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(n_shapes, MF_P, MF_D))
             + rng.normal(size=(n_shapes, 1, MF_D))).astype(np.float32)
    neighbors = (rng.normal(size=(n_shapes, MF_K + 1, MF_P, MF_D))
                 + rng.normal(size=(n_shapes, MF_K + 1, 1, MF_D))
                 ).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES,
                          size=(n_shapes, MF_P)).astype(np.int32)
    return feats, labels, neighbors


def check_midfc_outputs(tag, logits, n_shapes):
    require(logits.shape == (n_shapes, MF_P, NUM_CLASSES)
            and bool(torch.isfinite(logits).all()), f"{tag}: bad logits")
    pred = logits.argmax(dim=-1)
    require(int(pred.min()) >= 0 and int(pred.max()) <= NUM_CLASSES - 1,
            f"{tag}: predictions outside [0, {NUM_CLASSES - 1}]")
    return (f"logits {tuple(logits.shape)} finite, pred in "
            f"[{int(pred.min())}, {int(pred.max())}]")


def compare_grads(tag, got, ref, loss_got, loss_ref):
    """Loss and every gradient of `got` (kernels, GPU) within GRAD_TOL x
    max|ref| of the same tensor of `ref` (plain, CPU)."""
    require(abs(loss_got - loss_ref) <= GRAD_TOL * abs(loss_ref),
            f"{tag}: loss {loss_got} on the GPU, {loss_ref} on the CPU")
    top = max(float(r.abs().max()) for r in ref.values())
    worst = (0.0, "")
    for name, r in ref.items():
        scale = float(r.abs().max())
        err = float((got[name].cpu() - r).abs().max())
        print(f"[{tag}] gradient of {name}: max|ref| {scale:.3e} "
              f"({scale / top:.1e} of the step's largest), max_abs_err "
              f"{err:.3e} = {err / max(scale, 1e-30):.3e} x max|ref|")
        require(scale > 0.0 and err <= GRAD_TOL * scale,
                f"{tag}: gradient of {name} off by {err:.3e} (tol "
                f"{GRAD_TOL * scale:.3e})")
        worst = max(worst, (err / scale, name))
    print(f"[{tag}] f32 gradients, kernels on the GPU vs plain on the CPU: "
          f"{len(ref)} tensors, worst max_abs_err / max|ref| {worst[0]:.3e} "
          f"({worst[1]}), tol {GRAD_TOL:.0e}; loss {loss_got:.6f} vs "
          f"{loss_ref:.6f}")


def midfc_config(batch_size, chunk_size):
    return MidfcConfig(num_classes=NUM_CLASSES, n_heads=MF_HEADS, K=MF_K,
                       batch_size=batch_size, d_model=MF_D,
                       chunk_size=chunk_size, num_points=MF_P,
                       weight_decay=5e-4, compute_dtype="float32",
                       seed=SEED)


def midfc_chunked_slice(dev, profile=False):
    """Phase 6. Returns the launch counts of the 3 train steps."""
    n_mha = 2 * MF_K + 1   # SSA of the query and of K neighbors, K cross
    runner = MidfcRunner(midfc_config(MF_B, MF_CHUNK), "csa", device=dev)
    runner.initialize()
    data = [midfc_data(MF_B, SEED + 100 * r) for r in range(N_REQUESTS)]
    kernels.reset_launches()
    for r, (feats, _labels, neighbors) in enumerate(data):
        logits = runner._eval(feats, neighbors)
        print(f"[midfc] eval request {r}: "
              f"{check_midfc_outputs(f'midfc eval {r}', logits, MF_B)}")
    torch.cuda.synchronize()
    require_launches("midfc eval", dict(kernels.LAUNCHES),
                     {"flash_attn_fwd": n_mha})
    kernels.reset_launches()
    for r, (feats, labels, neighbors) in enumerate(data):
        loss, grads = runner._grad(feats, labels, neighbors,
                                   runner.draw_step_seed())
        runner._apply(grads)
        require(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
            f"midfc train {r}: loss {loss} or a gradient not finite")
        print(f"[midfc] train step {r}: loss {float(loss):.6f}, "
              f"{len(grads)} finite gradients")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require_launches("midfc train", launches,
                     {"flash_attn_fwd": n_mha, "flash_attn_bwd": n_mha})
    feats, labels, neighbors = data[0]
    what = (f"CSA, B={MF_B}, K={MF_K}, P={MF_P}, chunks of {MF_CHUNK}, "
            f"{MF_HEADS} heads of {MF_D}, f32")
    time_steps("midfc eval", lambda: runner._eval(feats, neighbors), what,
               MF_B)

    def step():
        _, grads = runner._grad(feats, labels, neighbors,
                                runner.draw_step_seed())
        runner._apply(grads)

    time_steps("midfc train", step, what + ", dropout 0.1, Adam", MF_B)
    if profile:
        profile_steps("midfc train", step)
    del runner
    torch.cuda.empty_cache()

    # one f32 B=1 step at dropout 0: kernels (GPU) vs plain (CPU)
    feats, labels, neighbors = midfc_data(1, SEED + 7)
    res = []
    init = None
    for where in (dev, "cpu"):
        r1 = MidfcRunner(midfc_config(1, MF_CHUNK), "csa", device=where)
        r1.initialize()
        r1.model.attention.mha.dropout = 0.0
        if init is None:
            init = {k: v.cpu().clone() for k, v in r1.params.items()}
        r1.load_state(init)
        t0 = time.perf_counter()
        loss, grads = r1._grad(feats, labels, neighbors, 0)
        res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
        print(f"[midfc] f32 B=1 step on {where}: loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lg, gg), (lc, gc) = res
    compare_grads("midfc", gg, gc, lg, lc)
    return launches


def midfc_ring_slice(dev, profile=False):
    """Phase 7. Returns the launch counts of the train step."""
    port = socket.socket()
    port.bind(("localhost", 0))
    addr = f"tcp://localhost:{port.getsockname()[1]}"
    port.close()
    dist.init_process_group("gloo", init_method=addr, world_size=1, rank=0)
    try:
        feats, labels, _ = midfc_data(MF_RING_B, SEED + 11)
        ring = MidfcRunner(midfc_config(MF_RING_B, None), "ssa", device=dev)
        ring.initialize()
        # full attention through the sharded steps is a ring over the seq
        # group, here of one rank
        steps = make_midfc_steps(ring, 1, 1)
        kernels.reset_launches()
        logits = steps.eval(feats, None)
        print(f"[ring] eval request: "
              f"{check_midfc_outputs('ring eval', logits, MF_RING_B)}")
        torch.cuda.synchronize()
        require_launches("ring eval", dict(kernels.LAUNCHES),
                         {"flash_attn_carry": 1}, n_requests=1)

        plain = MidfcRunner(midfc_config(MF_RING_B, None), "ssa", device=dev)
        plain.initialize()
        plain.load_state(ring.params)
        kernels.reset_launches()
        ref = plain._eval(feats, None)
        require_launches("ring eval, same model without the group",
                         dict(kernels.LAUNCHES), {"flash_attn_fwd": 1},
                         n_requests=1)
        err = (logits - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"[ring] f32 logits, ring of one (carry kernel) vs the same "
              f"model without the group (K2): max_abs_err {err:.3e} tol "
              f"{TOL[torch.float32] * scale:.3e} (max|ref| {scale:.3e})")
        require(err <= TOL[torch.float32] * scale,
                "ring logits disagree with the unsharded model")
        del plain, ref

        kernels.reset_launches()
        loss, grads = steps.grad(feats, labels, None, ring.draw_step_seed())
        ring._apply(grads)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        require(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
            f"ring train: loss {loss} or a gradient not finite")
        print(f"[ring] train step: loss {float(loss):.6f}, {len(grads)} "
              f"finite gradients")
        require_launches("ring train", launches,
                         {"flash_attn_carry": 1, "flash_attn_block_bwd": 1},
                         n_requests=1)
        what = (f"SSA, full attention, ring of one, B={MF_RING_B}, "
                f"P={MF_P}, {MF_HEADS} heads of {MF_D}, f32")
        time_steps("ring eval", lambda: steps.eval(feats, None), what,
                   MF_RING_B, timed_steps=3)

        def step():
            _, grads = steps.grad(feats, labels, None, ring.draw_step_seed())
            ring._apply(grads)

        time_steps("ring train", step, what + ", dropout 0.1, Adam",
                   MF_RING_B, timed_steps=3)
        if profile:
            profile_steps("ring train", step)
        del ring, steps
        torch.cuda.empty_cache()

        # one f32 B=1 step at dropout 0: the ring's kernels (GPU) vs the
        # plain blocked attention without a group (CPU)
        feats, labels, _ = midfc_data(1, SEED + 13)
        res = []
        init = None
        for where in (dev, "cpu"):
            r1 = MidfcRunner(midfc_config(1, None), "ssa", device=where)
            r1.initialize()
            r1.model.attention.mha.dropout = 0.0
            if init is None:
                init = {k: v.cpu().clone() for k, v in r1.params.items()}
            r1.load_state(init)
            grad = make_midfc_steps(r1, 1, 1).grad if where == dev \
                else r1._grad
            t0 = time.perf_counter()
            kernels.reset_launches()
            loss, grads = grad(feats, labels, None, 0)
            res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
            print(f"[ring] f32 B=1 step on {where}: loss {float(loss):.6f} "
                  f"({time.perf_counter() - t0:.1f} s), launches "
                  f"{ {k: n for k, n in kernels.LAUNCHES.items() if n} }")
            if where == dev:
                require_launches(
                    "ring B=1 step", dict(kernels.LAUNCHES),
                    {"flash_attn_carry": 1, "flash_attn_block_bwd": 1},
                    n_requests=1)
            del r1
        (lg, gg), (lc, gc) = res
        compare_grads("ring", gg, gc, lg, lc)
    finally:
        dist.destroy_process_group()
    return launches


TR_TRAIN, TR_VAL, TR_TEST, TR_EPOCHS = 16, 8, 8, 2
# the cached eval keeps its key features in f16
CACHED_AGREE, CACHED_IOU_TOL = 0.999, 1e-3


def trainer_config(log_dir, dev, **kw):
    return Config(
        model="HRNetSimCSN3S", partnet_category="Chair",
        conv1_kernel_size=STEM_K, d_model=D_MODEL, n_head=N_HEAD,
        k_neighbors=K_NEIGHBORS, batch_size=B, val_batch_size=B,
        test_batch_size=B, num_points=P, level0_cap=LEVEL0_CAP,
        level_shrink=SHRINK, compute_dtype="bfloat16", optimizer="SGD",
        lr=LR, max_epoch=TR_EPOCHS, stat_freq=1, log_dir=log_dir,
        seed=SEED, device=str(dev), **kw).normalized()


def trainer_datasets():
    """(train, val, test) in-memory collections, each from its own seed."""
    return tuple(SurfaceShapeDataset(n, P, SEED + 31 * i) for i, n in
                 enumerate((TR_TRAIN, TR_VAL, TR_TEST)))


def spy_launches(obj, method, log):
    """Wrap `obj.method` so that each call runs from zeroed launch counts
    and appends (counts, seconds, result) to `log`."""
    inner = getattr(obj, method)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((dict(kernels.LAUNCHES), time.perf_counter() - t0, out))
        return out

    setattr(obj, method, wrapped)


def trainer_slice(dev, n_convs, do_profile=False):
    """Phase 8: `tasks/main_csn.build_trainer` + `CSNTrainer.train()` at
    full width under CSN_DYNG=2, then the eval CLI's path on a fresh
    trainer. Returns the launch counts summed over the train iterations."""
    C = NUM_CLASSES
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        with window_conv.dyng(2):
            return _trainer_slice(dev, n_convs, log_dir, C, do_profile)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _trainer_slice(dev, n_convs, log_dir, C, do_profile):
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = trainer_config(log_dir, dev)
    trainer = main_csn.build_trainer(cfg, datasets=(train_ds, val_ds))
    trainer.MAX_PATIENCE = trainer.MAX_COOLDOWN = 1
    trainer.patience = trainer.cooldown = 1
    graphs, iters = [], []
    build_graph = trainer.construct_shape_graph

    def graph_spy(recalculate):
        graphs.append(recalculate)
        return build_graph(recalculate)

    trainer.construct_shape_graph = graph_spy
    spy_launches(trainer, "_train_iter", iters)
    saved = {}
    save = trainer.save_checkpoint

    def save_spy(postfix=None):
        if postfix is None:   # the file `weights.pt` links to
            saved["host"] = trainer._host_state()
            saved["model"] = {k: v.clone() for k, v in
                              trainer.model.state_dict().items()}
        return save(postfix)

    trainer.save_checkpoint = save_spy
    losses = []
    update = trainer.losses.update
    trainer.losses.update = lambda v, n=1: (losses.append(v), update(v, n))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val = trainer.train()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iters = TR_EPOCHS * (TR_TRAIN // B)
    require(len(iters) == n_iters and len(losses) == n_iters,
            f"trainer: {len(iters)} iterations, expected {n_iters}")
    require(all(np.isfinite(losses)) and all(np.isfinite(val)),
            f"trainer: losses {losses}, final validation {val}")
    require(graphs and graphs[0] is False,
            f"trainer: graph constructions {graphs}")
    expect = {"sparse_conv_im2col_fwd": n_convs,
              "sparse_conv_im2col_bwd": n_convs, "flash_attn_fwd": 2,
              "flash_attn_bwd": 2, "interp_fwd": 1, "interp_bwd": 1}
    total = {k: 0 for k in kernels.LAUNCHES}
    for counts, _, _ in iters:
        for name, got in counts.items():
            require(got == expect.get(name, 0),
                    f"trainer: {name} {got} launches in a train iteration, "
                    f"expected {expect.get(name, 0)}")
            total[name] += got
    print(f"[trainer] train(): {n_iters} iterations of B={B}, K={K_NEIGHBORS} "
          f"over {TR_EPOCHS} epochs in {train_s:.1f} s with 2 validations "
          f"and {len(graphs)} graph construction(s) {graphs}; losses "
          f"{[round(v, 4) for v in losses]}; final validation loss "
          f"{val[0]:.4f}, part IoU {val[2]:.2f}, shape IoU {val[3]:.2f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB")
    print(f"[trainer] launches per train iteration under CSN_DYNG=2: "
          f"{ {k: n for k, n in iters[0][0].items() if n} } (K1 and "
          f"sparse_conv_dw: 0)")
    it_ms = [1e3 * sec for _, sec, _ in iters]
    print(f"[trainer] ms per train iteration inside train(), host batch "
          f"wait included: {[round(t, 1) for t in it_ms]} (the first waits "
          f"for its batch; median of the rest "
          f"{statistics.median(it_ms[1:]):.1f})")
    for name in ("", "best_part_iou"):
        path = os.path.join(log_dir, f"checkpoint_{cfg.model}{name}.pt")
        require(os.path.isfile(path) and os.path.isfile(path + ".json"),
                f"trainer: {path} or its sidecar missing")
    require(os.path.isfile(os.path.join(log_dir, "config.json")),
            "trainer: config.json missing")

    # the host batch build alone, and the step alone on a batch held fixed
    t0 = time.perf_counter()
    qb, keys = trainer._fetch_data()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[trainer] host batch build (query + {K_NEIGHBORS} key batch of "
          f"{B} shapes, built in 2 threads, moved to the card): "
          f"{build_ms:.1f} ms; the prefetch thread overlaps it with the step")
    gen = torch.Generator().manual_seed(SEED)

    def step():
        train_step(trainer.model, trainer.optimizer, qb, keys, gen)

    time_steps("trainer", step, f"B={B}, K={K_NEIGHBORS}, bf16, CSN_DYNG=2, "
               f"batch held fixed: no host batch build", timed_steps=5)
    if do_profile:
        profile_steps("trainer step, CSN_DYNG=2", step)
        # whole iterations as train() runs them: prefetch thread, batch
        # wait, step, the predictions' copy back for the score
        profile_steps("trainer iteration, CSN_DYNG=2", trainer._train_iter)
        trainer._close_prefetch()
    del qb, keys

    # the eval CLI's path on a fresh trainer: resume, test graph, test_on
    want, want_model = saved["host"], saved["model"]
    del trainer
    torch.cuda.empty_cache()
    train2, val2, _ = trainer_datasets()
    res, preds = {}, {}
    for cached in (False, True):
        cfg2 = trainer_config(log_dir, dev, resume=log_dir, is_train=False,
                              cached_eval=cached)
        ev = main_csn.build_trainer(cfg2, datasets=(train2, val2))
        ev.initialize()
        ev.resume()
        if not cached:
            got = ev._host_state()
            for key in ("best_val_part_iou", "best_val_shape_iou",
                        "best_val_loss", "best_val_acc",
                        "best_val_part_iou_iter", "csn_data"):
                require(got[key] == want[key],
                        f"resume: {key} {got[key]} != {want[key]}")
            require(ev.curr_iter == want["iteration"] + 1,
                    f"resume: iteration {ev.curr_iter}")
            for k, v in ev.model.state_dict().items():
                require(torch.equal(v, want_model[k]),
                        f"resume: {k} differs from the saved model")
            print(f"[trainer] resume(): iteration {ev.curr_iter}, epoch "
                  f"{ev.epoch}, bests, patience/cooldown and both neighbour "
                  f"lists restored exactly; {len(want_model)} model tensors "
                  f"bit-equal")
            t0 = time.perf_counter()
            ev.construct_test_graph(test_ds)
            torch.cuda.synchronize()
            print(f"[trainer] construct_test_graph: {TR_TEST} test x "
                  f"{TR_TRAIN} train shapes (SSA descriptors + retrieval "
                  f"measure) in {time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            ev.construct_shape_graph(recalculate=True)
            torch.cuda.synchronize()
            print(f"[trainer] construct_shape_graph(recalculate=True): "
                  f"{TR_TRAIN} train + {TR_VAL} val shapes in "
                  f"{time.perf_counter() - t0:.2f} s")
        reqs = []
        spy_launches(ev, "_eval_forward", reqs)
        t0 = time.perf_counter()
        res[cached] = ev.test_on(test_ds)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        preds[cached] = torch.cat([out[2].cpu() for _, _, out in reqs])
        want_req = {"sparse_conv_im2col_fwd": n_convs, "flash_attn_fwd": 2,
                    "interp_fwd": 1}
        for counts, _, _ in reqs:
            for name, n in counts.items():
                require(n == want_req.get(name, 0),
                        f"test_on cached={cached}: {name} {n} launches in a "
                        f"request, expected {want_req.get(name, 0)}")
        fwd_ms = statistics.median(1e3 * s_ for _, s_, _ in reqs)
        first = f", cache of {TR_TRAIN} shapes built first" if cached else ""
        fwd = "query pass + cached keys" if cached \
            else "combined query + key pass"
        print(f"[trainer] test_on cached_eval={cached}: loss "
              f"{res[cached][0]:.4f}, part IoU {res[cached][2]:.3f}, shape "
              f"IoU {res[cached][3]:.3f}; {1e3 * sec / TR_TEST:.1f} ms per "
              f"test shape all in ({TR_TEST} shapes, {len(reqs)} request(s)"
              f"{first}), {fwd_ms / B:.1f} ms per shape in the request's "
              f"forward ({fwd}); launches per request "
              f"{ {k: n for k, n in reqs[0][0].items() if n} }")
        p = preds[cached]
        require(int(p.min()) >= 1 and int(p.max()) <= C - 1,
                f"test_on cached={cached}: predictions outside [1, {C - 1}]")
        require(all(np.isfinite(res[cached])), f"test_on: {res[cached]}")
        del ev
        torch.cuda.empty_cache()
    agree = float((preds[False] == preds[True]).float().mean())
    d_iou = max(abs(res[False][i] - res[True][i]) / 100 for i in (2, 3))
    print(f"[trainer] cached vs recomputed test_on: predictions equal on "
          f"{100 * agree:.3f} % of points (>= {100 * CACHED_AGREE} %), IoUs "
          f"within {d_iou:.2e} (<= {CACHED_IOU_TOL})")
    require(agree >= CACHED_AGREE and d_iou <= CACHED_IOU_TOL,
            "cached and recomputed test_on disagree")
    return total



def check_probes(dev, table):
    """The three probe kernels against their plain versions, and their times
    at the probe scripts' shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    # probe_window_gather: both layouts, both types, W = 384 and 256, the
    # matched call, a row id outside the window (a zero row)
    for w, t in ((384, 256), (256, 256)):
        win_np, rel_np, want = dyngather.probe_inputs(w, t, dyngather.C)
        rel = torch.from_numpy(rel_np).to(dev)
        for dt in (f32, bf16):
            win = torch.from_numpy(win_np).to(device=dev, dtype=dt)
            plain = dyngather.window_gather_plain(win, rel)
            for layout in (0, 1):
                what = f"W={w} T={t} layout {layout}"
                table.check("probe_window_gather", what,
                            dyngather.window_gather(win, rel, layout), plain,
                            dt)
                table.check("probe_window_gather", what + " matched",
                            dyngather2.matched_gather(win, rel, layout),
                            plain, dt)
            if dt == f32:
                require(np.array_equal(plain.cpu().numpy(), want),
                        "window_gather_plain != numpy's win[rel]")
        bad = rel.clone()
        bad[5] = w + 3
        got = dyngather.window_gather(win, bad, 0)
        require(float(got[5].float().abs().max()) == 0.0 and torch.equal(
            got[6], plain[6]), "probe_window_gather: row id outside the "
            "window must give a zero row")
    win_np, rel_np, _ = dyngather.probe_inputs()
    win = torch.from_numpy(win_np).to(dev)
    rel = torch.from_numpy(rel_np).to(dev)
    nb = (dyngather.W + dyngather.T) * dyngather.C * 4 + dyngather.T * 4
    for layout in (0, 1):
        table.time("probe_window_gather", f"W=384 T=256 C=128 layout "
                   f"{layout}", lambda: dyngather.window_gather(win, rel,
                                                                layout),
                   lambda: dyngather.window_gather_plain(win, rel),
                   count=1 - layout, nbytes=nb, flops=0, dtype=f32,
                   fn_library=lambda: torch.index_select(win, 0, rel))

    # probe_gather_accum: the three modes against the plain version and
    # against each other, at the scripts' timing geometry
    k, n_tiles = 9, 352
    for dt, w in ((bf16, 384), (f32, 384), (f32, 256)):
        rows, win = dyngather.timing_inputs(w, dyngather.T, dyngather.C,
                                            n_tiles, k, dt, dev)
        rows[1, :9] = -1          # row ids outside the window add nothing
        rows[5, 100:140] = w
        rows[k + 2, ::7] = w + 1000
        plain = dyngather.gather_accum_plain(rows, win, k)
        outs = {}
        for mode in dyngather.MODES:
            outs[mode] = dyngather.gather_accum(rows, win, k, mode)
            # the accumulation itself is f32 in every mode and type
            table.check("probe_gather_accum", f"{mode} W={w} "
                        f"{str(dt)[6:]} window", outs[mode], plain, f32)
        for mode in ("onehot", "smem"):
            table.check("probe_gather_accum", f"{mode} vs global W={w} "
                        f"{str(dt)[6:]} window", outs[mode], outs["global"],
                        f32)
        del outs, plain
        if w != 384:
            continue
        es = win.element_size()
        gather_b = rows.numel() * 4 + w * dyngather.C * es \
            + n_tiles * dyngather.T * dyngather.C * 4
        # the function is K gathered rows added per output row: one
        # bound for every mode, whatever the mode computes on the way
        accum_f = n_tiles * k * dyngather.T * dyngather.C
        bags = rows.reshape(n_tiles, k, -1).transpose(1, 2).reshape(
            -1, k).clamp(0, w - 1).contiguous().long()
        win32 = win.float()
        for mode in dyngather.MODES:
            # the JSON line sums the three modes with the bf16 window
            table.time("probe_gather_accum", f"{mode} W={w} "
                       f"{str(dt)[6:]} window, {n_tiles} tiles x {k} offsets",
                       lambda: dyngather.gather_accum(rows, win, k, mode),
                       lambda: dyngather.gather_accum_plain(rows, win, k),
                       count=int(dt == bf16), reps=3, nbytes=gather_b,
                       flops=accum_f, dtype=f32,
                       fn_library=lambda: F.embedding_bag(bags, win32,
                                                          mode="sum"))
        del bags, win32
    torch.cuda.empty_cache()

    # probe_slot_load: every variant
    for v, (name, shape, _) in iw_bwd.VARIANTS.items():
        x = torch.from_numpy(iw_bwd.probe_input(v)).to(dev) * 3.0
        plain = iw_bwd.slot_load_plain(v, x)
        table.check("probe_slot_load", name, iw_bwd.slot_load(v, x), plain,
                    f32)
        require(float(plain.abs().max()) > 1.0, f"slot probe {v}: dead load")
        table.time("probe_slot_load", name, lambda: iw_bwd.slot_load(v, x),
                   lambda: iw_bwd.slot_load_plain(v, x),
                   nbytes=x.numel() * 4 + 8 * 128 * 4, flops=0, dtype=f32)


def family_spec(name):
    """(class, pyramid spec) of a model family at the protocol's sizes."""
    cls = load_model(name)
    return cls, pipeline.pyramid_spec_for_model(
        cls, num_points=P, voxel_size=VOXEL, conv1_kernel_size=STEM_K,
        level0_cap=LEVEL0_CAP, shrink=SHRINK)


def family_batches(name, dev, n_shapes, seed):
    """(class, spec, one device batch of n_shapes shapes) of a plain
    segmentation family at the protocol's sizes."""
    cls, spec = family_spec(name)
    rng = np.random.default_rng(seed)
    hb = pipeline.collate_shapes(
        [make_surface_shape(rng, P) for _ in range(n_shapes)], spec, rng=rng)
    print(f"[batch] {name}: level caps {spec.level_caps}, occupied voxels "
          f"per shape and level (max) "
          f"{[int(n.max()) for n in hb.num_voxels]}, dropped {hb.dropped}, "
          f"{len(spec.maps)} maps")
    return cls, spec, to_torch(hb, dev)


def check_family_convs(dev, table, g):
    """Phase 3 on the new families' convs. Returns Res16UNet34C's number of
    convs."""
    n_unet = 0
    for name, n_shapes, timed in (("Res16UNet34C", B, True),
                                  ("ResUNet14", 2, False),
                                  ("ResNet14", 2, False)):
        cls, _, tb = family_batches(name, dev, n_shapes, SEED + 50)
        n = check_convs(make_model(cls, "bfloat16", 0.0), tb, dev, table, g,
                        timed=timed)
        print(f"[check] {name}: {n} sparse convs, every (map, Cin, Cout) "
              f"family checked in f32 and bf16"
              f"{', and timed in bf16' if timed else ''}")
        if timed:
            n_unet = n
        del tb
        torch.cuda.empty_cache()
    return n_unet


def forward_vs_cpu(name, dev):
    """A full-width f32 forward (B=2, eval mode) through the kernels against
    the plain forward on the CPU."""
    cls, _, tb = family_batches(name, dev, 2, SEED + 60)
    model = make_model(cls, "float32", 0.0).eval().to(dev)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(tb).cpu()
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        t0 = time.perf_counter()
        ref = model.cpu()(tb.to("cpu"))
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[families] {name} f32 forward B=2, logits {tuple(got.shape)}: "
          f"kernels on the GPU {launched} vs plain on the CPU "
          f"({time.perf_counter() - t0:.1f} s): max_abs_err {err:.3e} tol "
          f"{1e-3 * scale:.3e} (max|ref| {scale:.3e})")
    require(bool(torch.isfinite(got).all()) and scale > 0
            and err <= 1e-3 * scale,
            f"{name} f32 forward: kernels disagree with plain")


UNET = "Res16UNet34C"


def unet_slice(dev, n_convs, log_dir):
    """Phase 9, first part: the Res16UNet34C trainer. Returns the launch
    counts summed over the train iterations."""
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = Config(
        model=UNET, partnet_category="Chair", conv1_kernel_size=STEM_K,
        batch_size=B, val_batch_size=B, test_batch_size=B, num_points=P,
        level0_cap=LEVEL0_CAP, level_shrink=SHRINK, compute_dtype="bfloat16",
        optimizer="SGD", lr=LR, scheduler="StepLR", max_epoch=TR_EPOCHS,
        stat_freq=1, log_dir=log_dir, seed=SEED, device=str(dev)).normalized()
    trainer = main_seg.build_trainer(cfg, datasets=(train_ds, val_ds))
    require(type(trainer.model).__name__ == UNET
            and trainer.spec.num_levels == 5, "phase 9: wrong model or spec")
    iters, losses = [], []
    spy_launches(trainer, "_train_iter", iters)
    update = trainer.losses.update
    trainer.losses.update = lambda v, n=1: (losses.append(v), update(v, n))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    val = trainer.train()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iters = TR_EPOCHS * (TR_TRAIN // B)
    require(len(iters) == n_iters and all(np.isfinite(losses))
            and all(np.isfinite(val)),
            f"unet trainer: {len(iters)} iterations, losses {losses}, "
            f"validation {val}")
    expect = {"sparse_conv_fwd": 2 * n_convs - 1, "sparse_conv_dw": n_convs,
              "interp_fwd": 1, "interp_bwd": 1}
    total = {k: 0 for k in kernels.LAUNCHES}
    for counts, _, _ in iters:
        for name, got in counts.items():
            require(got == expect.get(name, 0),
                    f"unet trainer: {name} {got} launches in a train "
                    f"iteration, expected {expect.get(name, 0)}")
            total[name] += got
    it_ms = [1e3 * sec for _, sec, _ in iters]
    print(f"[unet] {UNET} train(): {n_iters} iterations of B={B} over "
          f"{TR_EPOCHS} epochs in {train_s:.1f} s with 2 validations; losses "
          f"{[round(v, 4) for v in losses]}; final validation loss "
          f"{val[0]:.4f}, part IoU {val[2]:.2f}, shape IoU {val[3]:.2f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB; launches per iteration "
          f"{ {k: n for k, n in iters[0][0].items() if n} }; ms per "
          f"iteration inside train() {[round(t, 1) for t in it_ms]}")
    reqs = []
    spy_launches(trainer, "_eval_forward", reqs)
    res = trainer.test_on(test_ds)
    require(all(np.isfinite(res)), f"unet test_on: {res}")
    preds = torch.cat([out[2].cpu() for _, _, out in reqs])
    require(int(preds.min()) >= 1 and int(preds.max()) <= NUM_CLASSES - 1,
            f"unet test_on: predictions outside [1, {NUM_CLASSES - 1}]")
    for counts, _, _ in reqs:
        for name, n in counts.items():
            want = {"sparse_conv_fwd": n_convs, "interp_fwd": 1}.get(name, 0)
            require(n == want, f"unet test_on: {name} {n} launches in a "
                    f"request, expected {want}")
    print(f"[unet] test_on: loss {res[0]:.4f}, part IoU {res[2]:.3f}, shape "
          f"IoU {res[3]:.3f}; predictions in [{int(preds.min())}, "
          f"{int(preds.max())}]; launches per request "
          f"{ {k: n for k, n in reqs[0][0].items() if n} }")

    # the step and the eval request on a batch held fixed, in both forms
    qb, keys = trainer._fetch_data()
    trainer._close_prefetch()
    gen = torch.Generator().manual_seed(SEED)
    for mode in (None, 2):
        with window_conv.dyng(mode):
            tag = f"B={B}, bf16, CSN_DYNG={mode}, batch held fixed"
            time_steps("unet train", lambda: train_step(
                trainer.model, trainer.optimizer, qb, keys, gen), tag,
                timed_steps=5)
            time_steps("unet eval", lambda: eval_step(trainer.model, qb,
                                                      keys), tag,
                       timed_steps=5)
    return total


MF_CAT, MF_CHAIN_K = "Bed", 1   # a category of the launcher's table: 15 classes


def chain_slice(dev, base):
    """Phase 9, second part: HRNetSeg3S extractor -> fc_1 dumps -> SSA ->
    kNN graphs -> CSA -> get_csa_pred. Returns the launch counts of the
    whole chain."""
    train_ds, val_ds, test_ds = trainer_datasets()
    cfg = Config(
        model="HRNetSeg3S", partnet_category="Chair",
        conv1_kernel_size=STEM_K, d_model=D_MODEL, batch_size=B,
        val_batch_size=B, test_batch_size=B, num_points=P,
        level0_cap=LEVEL0_CAP, level_shrink=SHRINK, compute_dtype="bfloat16",
        optimizer="SGD", lr=LR, scheduler="StepLR", max_epoch=1, stat_freq=1,
        log_dir=os.path.join(base, "seg_logs"), seed=SEED,
        device=str(dev)).normalized()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = main_seg.build_trainer(cfg, datasets=(train_ds, val_ds))
    val = trainer.train()
    require(all(np.isfinite(val)), f"extractor training: {val}")
    feats = os.path.join(base, "features")
    counts = {}
    for split, ds in (("train", train_ds), ("test", test_ds)):
        counts[split] = extraction.extract_split(
            trainer.model, ds, trainer.spec,
            os.path.join(feats, split, MF_CAT), batch_size=B)
    torch.cuda.synchronize()
    require(counts == {"train": TR_TRAIN, "test": TR_TEST},
            f"extract_split wrote {counts}")
    f0 = np.load(os.path.join(feats, "train", MF_CAT, "fc_1", "00000.npy"))
    l0 = np.load(os.path.join(feats, "train", MF_CAT, "point_labels",
                              "00000.npy"))
    require(f0.shape == (1, D_MODEL, P, 1) and l0.shape == (P,)
            and bool(np.isfinite(f0).all()),
            f"extract_split: fc_1 {f0.shape}, labels {l0.shape}")
    require(kernels.LAUNCHES["interp_fwd"] >= 2 * (TR_TRAIN + TR_TEST) // B,
            "extract_split did not run the readout kernel")
    print(f"[chain] HRNetSeg3S trained 1 epoch (validation loss "
          f"{val[0]:.4f}) and {counts} shapes extracted (fc_1 "
          f"{f0.shape}, 4 npy directories per split) in "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer
    torch.cuda.empty_cache()

    logs = os.path.join(base, "logs")
    k = run_training.NAMES.index(MF_CAT)
    common = ["--data_root", feats, "--logs_root", logs, "--start", str(k),
              "--end", str(k), "--testing", "--d_model", str(D_MODEL),
              "--num_points", str(P), "--chunk_size", str(MF_CHUNK),
              "--n_heads", str(MF_HEADS), "--K", str(MF_CHAIN_K),
              "--batch_size", "2", "--device", str(dev)]
    for at in ("ssa", "save_knn", "csa"):
        t0 = time.perf_counter()
        ious = run_training.main(common + ["--attention_type", at])
        torch.cuda.synchronize()
        print(f"[chain] run_training {at}: {ious} in "
              f"{time.perf_counter() - t0:.1f} s")
    graph_dir = os.path.join(logs, "knn_graphs", f"n_heads_{MF_HEADS}",
                             MF_CAT)
    tr_graph = np.load(os.path.join(graph_dir, "train.npy"))
    require(tr_graph.shape == (TR_TRAIN, MF_CHAIN_K + 1)
            and bool((tr_graph[:, 0] == np.arange(TR_TRAIN)).all()),
            f"chain: train graph {tr_graph.shape}, {tr_graph[:, 0]}")
    ckpt = os.path.join(logs, f"sgd_csa_n_heads_{MF_HEADS}_K_{MF_CHAIN_K}",
                        "run_1", MF_CAT, CHECKPOINT_NAME)
    require(os.path.isfile(ckpt), f"chain: {ckpt} missing")
    launches = dict(kernels.LAUNCHES)
    require(launches["flash_attn_fwd"] > 0 and launches["flash_attn_bwd"] > 0,
            f"chain: the MID-FC training launched no flash kernel: "
            f"{launches}")

    # get_csa_pred pins f32 and takes the attention of its device: the f32
    # flash kernels on the card, held to the plain attention of a CPU run
    pred_args = [
        "--data_root", feats, "--partname", MF_CAT, "--num_classes",
        str(run_training.SEG_NUM[k]), "--n_heads", str(MF_HEADS), "--K",
        str(MF_CHAIN_K), "--chunk_size", str(MF_CHUNK), "--d_model",
        str(D_MODEL), "--num_points", str(P), "--batch_size", "2", "--ckpt",
        ckpt, "--knn_graph_dir", graph_dir]
    kernels.reset_launches()
    t0 = time.perf_counter()
    iou = get_csa_pred.main(pred_args + [
        "--logs_dir", os.path.join(base, "csa_pred"), "--save_pred_dir",
        os.path.join(base, "pred_gpu"), "--device", str(dev)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    pred_launches = dict(kernels.LAUNCHES)
    # chunked eval: one flash launch per attention layer of a batch
    require(0.0 <= iou <= 1.0 and pred_launches["flash_attn_fwd"] > 0
            and os.path.isfile(os.path.join(base, "csa_pred",
                                            "part_IoU_summaries.csv")),
            f"get_csa_pred: IoU {iou}, launches {pred_launches}")
    t0 = time.perf_counter()
    iou_cpu = get_csa_pred.main(pred_args + [
        "--logs_dir", os.path.join(base, "csa_pred_cpu"), "--save_pred_dir",
        os.path.join(base, "pred_cpu"), "--device", "cpu"])
    require(kernels.LAUNCHES == pred_launches,
            "get_csa_pred --device cpu launched a kernel")
    sub = f"midfc_csa_K_{MF_CHAIN_K}"
    agree = float(np.mean([
        (np.load(os.path.join(base, "pred_gpu", sub, f"shape_{i}.npy"))
         == np.load(os.path.join(base, "pred_cpu", sub, f"shape_{i}.npy"))
         ).mean() for i in range(TR_TEST)]))
    print(f"[chain] get_csa_pred on {TR_TEST} test shapes: part IoU "
          f"{100 * iou:.4f} in {sec:.1f} s (f32 flash kernels, launches "
          f"{ {n: c for n, c in pred_launches.items() if c} }) vs "
          f"{100 * iou_cpu:.4f} with --device cpu (plain attention, "
          f"{time.perf_counter() - t0:.1f} s): IoUs within "
          f"{abs(iou - iou_cpu):.2e} (<= {CACHED_IOU_TOL}), predictions "
          f"equal on {100 * agree:.3f} % of points (>= "
          f"{100 * CACHED_AGREE} %)")
    require(abs(iou - iou_cpu) <= CACHED_IOU_TOL and agree >= CACHED_AGREE,
            "get_csa_pred on the card disagrees with its CPU run")
    cat_dir = os.path.join(logs, "pretrained_models", "run_1", MF_CAT)
    os.makedirs(cat_dir)
    shutil.copy(ckpt, cat_dir)
    shutil.copytree(graph_dir, os.path.join(
        logs, "pretrained_models", "knn_graphs", f"n_heads_{MF_HEADS}",
        MF_CAT))
    kernels.reset_launches()
    ious = run_training.main(common + ["--attention_type", "pred"])
    # the call above went over the test set twice (validation, then the
    # prediction dump); `pred` validates only
    require(abs(ious[MF_CAT] - 100 * iou) < 1e-9
            and 2 * kernels.LAUNCHES["flash_attn_fwd"]
            == pred_launches["flash_attn_fwd"],
            f"run_training pred: {ious} vs get_csa_pred {100 * iou}, "
            f"launches {kernels.LAUNCHES}")
    print(f"[chain] run_training pred: {ious}, "
          f"{kernels.LAUNCHES['flash_attn_fwd']} flash_attn_fwd launches")
    for name in launches:
        launches[name] += pred_launches[name] + kernels.LAUNCHES[name]
    return launches


def probes_slice(dev):
    """Phase 9, last part: the probes' own entry points. Returns the launch
    counts."""
    kernels.reset_launches()
    times = dyngather.main(["--device", str(dev)])
    times2 = dyngather2.main(["--device", str(dev)])
    errs = iw_bwd.main(["--device", str(dev), "--extra"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(all(e == 0.0 for e in errs.values()) and len(errs) == 7,
            f"slot probes differ from their plain versions: {errs}")
    require(all(np.isfinite(t) and t > 0 for t in (*times.values(),
                                                   *times2.values())),
            f"probe timings: {times}, {times2}")
    print(f"[probes] launches of the three entry points: "
          f"{ {k: n for k, n in launches.items() if n} }")
    return launches


def families_slice(dev, n_convs):
    """Phase 9. Returns the launch counts of its main paths, summed."""
    base = tempfile.mkdtemp(prefix="chip_smoke_families_")
    try:
        total = unet_slice(dev, n_convs, os.path.join(base, "unet_logs"))
        cls, spec = family_spec(UNET)
        for mode in (None, 2):
            f32_step_check(cls, spec, dev, "unet", mode=mode)
        for name in ("ResUNet14", "ResNet14"):
            forward_vs_cpu(name, dev)
        chain = chain_slice(dev, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    probes = probes_slice(dev)
    return {k: total[k] + chain[k] + probes[k] for k in total}


def main() -> int:
    do_profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 3-7 run the K1 form whatever the caller's environment says;
    # phase 8 sets the im2col form for its own block
    os.environ.pop("CSN_DYNG", None)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(msg):
        print(f"[phase] {msg} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

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
    print(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}, "
          f"{len(list(kernels.CSRC.glob('*.cu')))} sources: {build_s:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with loading)")

    cls, spec = family_spec("HRNetSimCSN3S")
    print(f"[batch] level caps {spec.level_caps}, maps {spec.map_names()}")
    t0 = time.perf_counter()
    reqs = build_requests(spec, dev)
    print(f"[batch] {N_REQUESTS} requests x (1 + {K_NEIGHBORS}) batches of "
          f"{B} shapes built and moved in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    phase("3 kernels")
    table = Table()
    model = make_model(cls, "bfloat16", ATTN_DROPOUT)
    qb, (kb,) = reqs[0]
    big = concat_batches([qb, kb])
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n_convs = check_convs(model, big, dev, table, g)
    n_stems = 1   # conv0 reads the raw voxel features: no d_feats
    check_attention(qb, kb, big, dev, table, g)
    check_interp(qb, dev, table, g)
    del big
    check_ring_kernels(dev, table, g)
    n_unet_convs = check_family_convs(dev, table, g)
    check_probes(dev, table)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. the eval slice
    phase("4 eval slice")
    eval_slice(cls, reqs, dev, n_convs)

    # 5. the train slice
    phase("5 train slice")
    launches = train_slice(cls, spec, reqs, dev, n_convs, n_stems)
    del reqs
    torch.cuda.empty_cache()

    # 6. MID-FC, chunked attention
    phase("6 MID-FC chunked")
    launches_6 = midfc_chunked_slice(dev, do_profile)

    # 7. MID-FC, full attention through the ring
    phase("7 MID-FC ring")
    launches_7 = midfc_ring_slice(dev, do_profile)

    # 8. the trainer and the eval CLI's path under CSN_DYNG=2
    phase("8 trainer")
    launches_8 = trainer_slice(dev, n_convs, do_profile)
    f32_step_check(cls, spec, dev, "trainer", mode=2)

    # 9. the other model families, the MID-FC chain, the probes
    phase("9 families, chain, probes")
    launches_9 = families_slice(dev, n_unet_convs)
    phase("done")

    total = {k: launches[k] + launches_6[k] + launches_7[k] + launches_8[k]
             + launches_9[k] for k in KERNELS}
    for name, n in total.items():
        require(n > 0, f"{name} was launched on no main path")
    rows = []
    for name, (src, rep) in KERNELS.items():
        bound_ms, bound_by = table.bound(name)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": total[name],
                     "max_abs_err": table.err[name], "ms": table.ms[name],
                     "plain_ms": table.plain_ms[name], "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "library_ms": table.library_ms[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
