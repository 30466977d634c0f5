"""Smoke run of the PyTorch port on one CUDA GPU: build the kernels, check
each against its plain version at the main path's shapes, then serve a few
eval requests and take a few train steps of HRNetSimCSN3S (K=1) at full
width.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi), the C++ host
     engine;
  2. build: nvcc of csn_tpu_torch/csrc/*.cu, one process per source;
  3. kernels, each in f32 and bf16 against its plain version on the same
     inputs, with median times of both (bf16, the main path's type):
     K1 (sparse conv) on every map and width of the model, and on every
     transpose map with the weights transposed (the backward's d_feats);
     `sparse_conv_dw` (dW) at the same convs, random asymmetric weights,
     against `conv_bwd_plain`; K2 (flash attention) at the SSA and CSA
     shapes with masks, at dropout 0 and 0.1 (same seed as the plain
     version); `flash_attn_bwd` at dropout 0 and 0.1 against autograd of
     the plain version; K3 (voxel -> point interpolation) and `interp_bwd`
     against `index_add_`;
  4. eval slice: 3 eval requests (query batch + 1 key batch each) through
     `eval_step`, launch counts per kernel, ms/step, shapes/s, peak memory,
     and the f32 forward with kernels against the plain forward on the CPU;
  5. train slice: 3 train requests through `train_step` (bf16, attention
     dropout 0.1, SGD lr 0.05), launch counts per kernel and step, ms/step
     over 10 steps, shapes/s, peak memory; then one f32 train step at
     dropout 0 on B=2 shapes with the kernels on the GPU against the same
     step with the plain versions on the CPU (loss and every gradient),
     the CPU step taking the GPU step's ReLU decisions (`ReluDecisions`).
The line before the last is the kernel table as JSON: per kernel, its
launches in phase 5, its worst error over phase 3's checks, and kernel and
plain median ms summed over one train step's launches in bf16; the last
line is {"ok": true, "device": {...}}.

Protocol (the JAX package's bench.py): B=8 query shapes of 10000 points,
voxel 0.05, level-0 cap 5632, level caps shrinking 3x, k5 stem, d_model 256,
4 heads, 39 classes, activations in bf16; weights are random, drawn from a
seeded generator.
"""

from __future__ import annotations

import contextlib
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
from csn_tpu_torch.models import blocks, hrnet, load_model
from csn_tpu_torch.models.layers import SparseConv
from csn_tpu_torch.ops import attention, flash
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

KERNELS = {
    "sparse_conv_fwd": ("csn_tpu_torch/csrc/sparse_conv.cu",
                        "csn_tpu/core/window_conv.py:973"),
    "sparse_conv_dw": ("csn_tpu_torch/csrc/sparse_conv_bwd.cu",
                       "csn_tpu/core/window_conv.py:1067"),
    "flash_attn_fwd": ("csn_tpu_torch/csrc/flash_attn.cu",
                       "csn_tpu/ops/flash.py:262"),
    "flash_attn_bwd": ("csn_tpu_torch/csrc/flash_attn_bwd.cu",
                       "csn_tpu/ops/flash.py:600"),
    "interp_fwd": ("csn_tpu_torch/csrc/interp.cu",
                   "csn_tpu/core/interp_window.py:288"),
    "interp_bwd": ("csn_tpu_torch/csrc/interp_bwd.cu",
                   "csn_tpu/core/interp_window.py:322"),
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
            [bench.make_surface_shape(rng, P) for _ in range(n_shapes)],
            spec, rng=rng) for _ in range(K_NEIGHBORS + 1))
        reqs.append((qb, kb))
    if reqs[0][0].dropped[1] or reqs[0][0].dropped[2]:
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
        saved = blocks.relu_masked, hrnet.relu_masked
        blocks.relu_masked = hrnet.relu_masked = fn
        try:
            yield
        finally:
            blocks.relu_masked, hrnet.relu_masked = saved


def make_model(cls, dtype: str, attn_dropout: float):
    model = cls(out_channels=NUM_CLASSES, conv1_kernel_size=STEM_K,
                d_model=D_MODEL, n_head=N_HEAD, k_neighbors=K_NEIGHBORS,
                compute_dtype=dtype, attn_dropout=attn_dropout)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model


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

    def time(self, name, what, fn_kernel, fn_plain, count=1, reps=7):
        """Median ms of the kernel and its plain version (bf16 inputs),
        added `count` times to the train step's totals."""
        ms = median_ms(fn_kernel)
        pms = median_ms(fn_plain, warmup=1, reps=reps)
        print(f"[time] {name} {what} bf16: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms (x{count} per train step)")
        self.ms[name] += count * ms
        self.plain_ms[name] += count * pms


def check_convs(model, big, dev, table, g):
    """K1 forward and on the transpose map, and `sparse_conv_dw`, at every
    (map, Cin, Cout) the model runs. Returns the number of convs."""
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
            del ref_df, ref_dw, got_df, got_dw
            if dt != torch.bfloat16:
                continue
            table.time("sparse_conv_fwd", what,
                       lambda: window_conv.sparse_conv_fwd(f, kmap, wt),
                       lambda: conv.conv_plain(f, kmap, wt), count)
            if n_dfeats:
                table.time("sparse_conv_fwd", f"d_feats over {t_name}",
                           lambda: window_conv.sparse_conv_fwd(gd, kmap_t,
                                                               w_t),
                           lambda: conv.conv_plain(gd, kmap_t, w_t), n_dfeats)
            table.time("sparse_conv_dw", what,
                       lambda: window_conv.sparse_conv_dw(f, gd, kmap_t),
                       lambda: conv.conv_bwd_plain(f, gd, kmap_t, wt.float(),
                                                   mirror, False), count,
                       reps=3)
        torch.cuda.empty_cache()
    return sum(convs.values())


def check_attention(qb, kb, big, dev, table, g):
    """K2 at dropout 0 and ATTN_DROPOUT and its backward kernel, at the SSA
    (combined pass) and CSA (query against key) shapes."""
    dk = D_MODEL // N_HEAD
    temp = float(dk) ** 0.5
    seed = 0x5EED_0F_C5A
    bmask, qmask, kmask = big.masks[0], qb.masks[0], kb.masks[0]
    for what, qm, km in (("SSA", bmask, bmask), ("CSA", qmask, kmask)):
        b, L = qm.shape
        q, k, v, dout = (torch.randn(b, N_HEAD, L, dk, generator=g).to(dev)
                         for _ in range(4))
        valid = qm[:, None, :, None]
        dout = dout * valid   # padded query rows carry no gradient
        shape = f"{what} [{b},{N_HEAD},{L},{dk}]"
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
                if dt == torch.bfloat16 and drop:   # the train path's call
                    table.time(
                        "flash_attn_fwd", tag,
                        lambda: flash.flash_attention(qd, kd, vd, km, qm,
                                                      temp, drop, sd),
                        lambda: attention.scaled_dot_product_attention(
                            qd, kd, vd, km, temp, dropout=drop, seed=sd),
                        reps=3)
                    table.time(
                        "flash_attn_bwd", tag,
                        lambda: flash.flash_attention_bwd(
                            qd, kd, vd, dod, lse, delta, km, qm, temp, drop,
                            sd),
                        lambda: torch.autograd.grad(plain, leaves, dod,
                                                    retain_graph=True),
                        reps=3)
                del out, lse, delta, plain, leaves
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
            table.time("interp_fwd", what,
                       lambda: interp_window.interp_fwd(fl, idx, w8),
                       lambda: interp.interpolate_to_points(fl, idx[None],
                                                            w8[None]))
            table.time("interp_bwd", bwd,
                       lambda: interp_window.interp_bwd(
                           gd, qb.interp_ptr, qb.interp_ent, w8),
                       lambda: interp.interp_bwd_plain(gd, idx, w8, n0))


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


def require_launches(tag, launches, expect):
    print(f"[{tag}] launches over {N_REQUESTS} requests: {launches} "
          f"(expected per request: {expect})")
    for name, n in expect.items():
        require(launches[name] == N_REQUESTS * n,
                f"{tag}: {name} {launches[name]} launches, expected "
                f"{N_REQUESTS * n}")


def time_steps(tag, step):
    """ms/step of `step()` over TIMED_STEPS after 2 warm-up steps, and the
    peak device memory of the timed steps."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {ms:.3f} ms/step over {TIMED_STEPS} steps (B={B}, "
          f"K={K_NEIGHBORS}, bf16), {B / ms * 1e3:.3f} query shapes/s, peak "
          f"memory {peak / 2 ** 30:.3f} GiB")


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

    # one f32 step at dropout 0 on B=2 shapes: kernels (GPU) vs plain (CPU)
    (qh, kh), = build_requests(spec, "cpu", n_shapes=2, n_requests=1,
                               seed=SEED + 7)
    init = make_model(cls, "float32", 0.0).state_dict()
    relus = ReluDecisions()
    res = []
    for replay, where in enumerate((dev, "cpu")):
        m32 = make_model(cls, "float32", 0.0)
        m32.load_state_dict(init)
        m32.to(where)
        opt = optim.make_optimizer(m32.parameters(), "SGD", lr=LR)
        t0 = time.perf_counter()
        with relus.active(replay=bool(replay)):
            loss, _ = train_step(m32, opt, qh.to(where),
                                 tuple(k.to(where) for k in kh),
                                 torch.Generator())
        res.append((float(loss), {n: p.grad.detach().cpu() for n, p in
                                  m32.named_parameters()}))
        print(f"[train] f32 B=2 step on {where}: loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lg, gg), (lc, gc) = res
    print(f"[train] ReLU decisions of the GPU step replayed on the CPU: "
          f"{relus.flips} of {relus.inputs} would have differed")
    require(abs(lg - lc) <= GRAD_TOL * abs(lc),
            f"f32 train step: loss {lg} on the GPU, {lc} on the CPU")
    top = max(float(t.abs().max()) for t in gc.values())
    worst = (0.0, "")
    for name, ref in gc.items():
        scale = top if name in VANISHING else float(ref.abs().max())
        err = float((gg[name] - ref).abs().max())
        require(err <= GRAD_TOL * scale,
                f"f32 train step: gradient of {name} off by {err:.3e} "
                f"(tol {GRAD_TOL * scale:.3e})")
        worst = max(worst, (err / max(scale, 1e-30), name))
    print(f"[train] f32 gradients, kernels on the GPU vs plain on the CPU: "
          f"{len(gc)} tensors, worst max_abs_err / max|ref| {worst[0]:.3e} "
          f"({worst[1]}), tol {GRAD_TOL:.0e}; loss {lg:.6f} vs {lc:.6f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    cls = load_model("HRNetSimCSN3S")
    spec = pipeline.pyramid_spec_for_model(
        cls, num_points=P, voxel_size=VOXEL, conv1_kernel_size=STEM_K,
        level0_cap=LEVEL0_CAP, shrink=SHRINK, use_windows=False,
        dense_stem_grid=0)
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
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. the eval slice
    phase("4 eval slice")
    eval_slice(cls, reqs, dev, n_convs)

    # 5. the train slice
    phase("5 train slice")
    launches = train_slice(cls, spec, reqs, dev, n_convs, n_stems)
    phase("done")

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
