"""Gather probe: where should a kernel's row gather read from on this card?

Counterpart of `scripts/probe_dyngather.py`. The TPU script asked whether a
Pallas kernel can gather rows from a window held in fast memory
(`out[i] = win[rel[i]]`) or must emulate the gather with a [T, W] one-hot
product, and timed the two inside the windowed conv's inner loop. Here the
kernels of `csn_tpu_torch/csrc/probe_gather.cu` compute the same functions:

* `window_gather`: one block stages the window in shared memory and gathers
  from it, the window as [W, C] (`layout=0`, the script's `take` /
  `take_along_axis` over rows) or staged transposed with the gather along
  the fast axis (`layout=1`, the script's transposed form);
* `gather_accum`: per tile, K offsets' row gathers from one window,
  accumulated in f32, by the one-hot product (`onehot`, the TPU's production
  form), from the window staged in shared memory (`smem`), or straight from
  device memory / L2 (`global`, what the port's conv kernels do today).

There is no compiler lowering to probe on this card, so a line reads
"LAUNCHES max_err=" where the script printed "COMPILES max_err=", and the
timing of the three modes is the result that matters.

    python -m csn_tpu_torch.probes.dyngather [--device cpu]

`window_gather` / `gather_accum` launch the kernels on CUDA tensors and take
the plain versions beside them only for tensors that lie on the CPU; any
other device raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from csn_tpu_torch import kernels

T, W, C = 256, 384, 128
MODES = {"onehot": 0, "smem": 1, "global": 2}
SMEM_BYTES = 232448     # shared memory one block can have on the H100
ACCUM_ROWS = 8          # the accumulate kernel's rows per thread


def window_gather_plain(win: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Plain version of `window_gather`: `win[rel]`."""
    return win[rel.long()]


def window_gather(win: torch.Tensor, rel: torch.Tensor,
                  layout: int = 0) -> torch.Tensor:
    """win [W, C] f32 or bf16, rel [T] int32 in [0, W) -> win[rel] [T, C],
    gathered from the window staged in shared memory as [W, C] (`layout` 0)
    or transposed, along the fast axis (`layout` 1). A row id outside the
    window gives a zero row on the card. Tensors on the CPU take the plain
    version."""
    what = "probe_window_gather"
    if layout not in (0, 1):
        raise ValueError(f"{what}: layout must be 0 or 1, got {layout}")
    if win.dim() != 2 or rel.dim() != 1:
        raise ValueError(f"{what}: want win [W, C], rel [T]; got "
                         f"{tuple(win.shape)}, {tuple(rel.shape)}")
    if rel.dtype != torch.int32:
        raise TypeError(f"{what}: rel must be int32, got {rel.dtype}")
    if win.device.type == "cpu":
        return window_gather_plain(win, rel)
    kernels.require_cuda(what, win, rel)
    w, c = win.shape
    if w * c * win.element_size() > SMEM_BYTES:
        raise ValueError(f"{what}: a window of {w} x {c} {win.dtype} does not "
                         f"fit in {SMEM_BYTES} bytes of shared memory")
    out = torch.empty((rel.shape[0], c), dtype=win.dtype, device=win.device)
    code = kernels.library().csn_probe_window_gather(
        kernels.dtype_code(win), layout, win.data_ptr(), rel.data_ptr(),
        out.data_ptr(), w, rel.shape[0], c, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out


def gather_accum_plain(rows: torch.Tensor, win: torch.Tensor,
                       k_offsets: int) -> torch.Tensor:
    """Plain version of `gather_accum`: rows [n_tiles * K, T] int, win
    [W, C] -> [n_tiles * T, C] f32, out[t*T + i] = sum_k valid * win[rows[t*K
    + k, i]] with row ids outside [0, W) adding nothing."""
    n, t = rows.shape
    r = rows.reshape(n // k_offsets, k_offsets, t).long()
    valid = (r >= 0) & (r < win.shape[0])
    g = win.float()[torch.where(valid, r, 0)]              # [tiles, K, T, C]
    g = g * valid[..., None].float()
    return g.sum(dim=1).reshape(-1, win.shape[1])


def gather_accum(rows: torch.Tensor, win: torch.Tensor, k_offsets: int,
                 mode: str = "smem") -> torch.Tensor:
    """rows [n_tiles * K, T] int32, win [W, C] f32 or bf16 -> [n_tiles * T,
    C] f32, by `mode` 'onehot', 'smem' or 'global' (the three compute one
    function). Tensors on the CPU take the plain version, one for all
    modes."""
    what = "probe_gather_accum"
    if mode not in MODES:
        raise ValueError(f"{what}: mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    if rows.dim() != 2 or win.dim() != 2 or k_offsets < 1 \
            or rows.shape[0] % k_offsets:
        raise ValueError(f"{what}: want rows [n_tiles * {k_offsets}, T], win "
                         f"[W, C]; got {tuple(rows.shape)}, "
                         f"{tuple(win.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"{what}: rows must be int32, got {rows.dtype}")
    if win.device.type == "cpu":
        return gather_accum_plain(rows, win, k_offsets)
    kernels.require_cuda(what, rows, win)
    w, c = win.shape
    t = rows.shape[1]
    if t % ACCUM_ROWS:
        raise ValueError(f"{what}: T = {t} must be a multiple of "
                         f"{ACCUM_ROWS}")
    if mode != "global" and w * c * win.element_size() > SMEM_BYTES:
        raise ValueError(f"{what}: a window of {w} x {c} {win.dtype} does not "
                         f"fit in {SMEM_BYTES} bytes of shared memory")
    n_tiles = rows.shape[0] // k_offsets
    out = torch.empty((n_tiles * t, c), dtype=torch.float32,
                      device=win.device)
    code = kernels.library().csn_probe_gather_accum(
        kernels.dtype_code(win), MODES[mode], rows.data_ptr(),
        win.data_ptr(), out.data_ptr(), n_tiles, k_offsets, w, t, c,
        kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out


def probe_inputs(w: int = W, t: int = T, c: int = C):
    """The script's inputs: a normal window from seed 0, row ids from seed
    1, and `want = win[rel]`, as numpy arrays."""
    win = np.random.default_rng(0).normal(size=(w, c)).astype(np.float32)
    rel = np.random.default_rng(1).integers(0, w, size=(t,)).astype(np.int32)
    return win, rel, win[rel]


def run(name: str, layout: int, dtype=torch.float32, device="cuda") -> float:
    """One gather form on the script's inputs; prints its line and returns
    the worst error against numpy's `win[rel]`."""
    win, rel, want = probe_inputs()
    out = window_gather(torch.from_numpy(win).to(device=device, dtype=dtype),
                        torch.from_numpy(rel).to(device), layout)
    err = float(np.abs(out.float().cpu().numpy() - want).max())
    print(f"{name:40s} LAUNCHES  max_err={err:.2e}")
    return err


def timing_inputs(w: int, t: int, c: int, n_tiles: int, k_offsets: int,
                  dtype, device):
    """Row ids and window of the script's `time_modes` (seed 2)."""
    rng = np.random.default_rng(2)
    rows = rng.integers(0, w, size=(n_tiles * k_offsets, t)).astype(np.int32)
    win = rng.normal(size=(w, c)).astype(np.float32)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(win).to(device=device, dtype=dtype))


def time_call(fn, iters: int, device) -> float:
    """ms per call of `fn` over `iters` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def time_modes(n_tiles: int = 352, k_offsets: int = 9, iters: int = 20,
               dtype=torch.bfloat16, device="cuda", w: int = W, t: int = T,
               c: int = C):
    """The three modes on one set of inputs: ms per call and us per (tile x
    K offsets), and the worst difference between the modes' outputs.
    Returns {mode: ms}."""
    rows, win = timing_inputs(w, t, c, n_tiles, k_offsets, dtype, device)
    ref = gather_accum(rows, win, k_offsets, "global")
    res = {}
    for mode in MODES:
        out = gather_accum(rows, win, k_offsets, mode)
        diff = float((out - ref).abs().max())
        ms = time_call(lambda: gather_accum(rows, win, k_offsets, mode),
                       iters, device)
        res[mode] = ms
        print(f"timing {mode:8s} W={w} {str(dtype)[6:]:8s} {ms:7.3f} ms/call  "
              f"{ms / n_tiles * 1e3:6.2f} us/(tile x {k_offsets} offsets)  "
              f"max_diff_vs_global={diff:.2e}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    print(f"backend=torch devices=[{name}]")
    run("take(axis=0) f32", 0, torch.float32, args.device)
    run("take_along_axis(axis=0) f32", 0, torch.float32, args.device)
    run("take(axis=0) bf16", 0, torch.bfloat16, args.device)
    run("take_along_axis lane-dim via T", 1, torch.float32, args.device)
    return time_modes(device=args.device)


if __name__ == "__main__":
    main()
