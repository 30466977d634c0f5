"""Gather probe: where should a kernel's row gather read from on this card?

Counterpart of `scripts/probe_dyngather.py`. The TPU script asked whether a
Pallas kernel can gather rows from a window held in fast memory
(`out[i] = win[rel[i]]`) or must emulate the gather with a [T, W] one-hot
product, and timed the two inside the windowed conv's inner loop. Here the
kernels of `csn_tpu_torch/csrc/probe_gather.cu` compute the same functions:

* `window_gather`: the channels split into slabs of `WINDOW_SLAB`, one
  block each; a block stages its slab of the window in shared memory and
  gathers from it, the slab as [W, slab] (`layout=0`, the script's `take` /
  `take_along_axis` over rows) or staged transposed at an odd pitch with
  the gather along the fast axis (`layout=1`, the script's transposed form);
* `gather_accum`: per tile, K offsets' row gathers from one window,
  accumulated in f32, by the one-hot product on the tensor cores (`onehot`,
  the TPU's production form; an f32 window as three bf16 parts, see
  `gather_accum_onehot`), from the window staged once per persistent block
  in shared memory (`smem`), or straight from device memory / L2
  (`global`, what the port's conv kernels do today); the gathers move
  16-byte vectors.

There is no compiler lowering to probe on this card, so a line reads
"LAUNCHES max_err=" where the script printed "COMPILES max_err=", and the
timing of the three modes is the result that matters: on the card, device
time from CUDA graphs (`tools/timing.py::graph_ms`), on the CPU the host
clock.

    python -m csn_tpu_torch.probes.dyngather [--device cpu]

`window_gather` / `gather_accum` launch the kernels on CUDA tensors and take
the plain versions beside them only for tensors that lie on the CPU; any
other device raises, and so does anything the kernels' bodies do not take
(a row of a width that is no multiple of 16 bytes, a window off a 16-byte
boundary, a window that does not fit in shared memory).
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from csn_tpu_torch import kernels
from csn_tpu_torch.tools.timing import graph_ms

T, W, C = 256, 384, 128
MODES = {"onehot": 0, "smem": 1, "global": 2}
SMEM_BYTES = 232448     # shared memory one block can have on the H100
SMEM_PER_SM = 233472    # shared memory of one SM, all its blocks together
SMEM_RESERVED = 1024    # shared memory the runtime keeps per block
SMS = 132               # streaming multiprocessors of the H100 SXM
ACCUM_ROWS = 8          # T is a multiple of this (the kernels' contract)
WINDOW_SLAB = 32        # channels of a window-gather block (at most 32)
GATHER_GROUP = 32       # output rows of a gather warp's group
# the gather bodies' blocks: (threads, blocks per SM); the global mode's
# third block is its best (more warps evict the window from L1), the smem
# mode stages the window once per SM
GATHER = {"global": (256, 3), "smem": (1024, 1)}
# the one-hot body per window type: warps per block, blocks per SM its
# register bound allows, row padding of the staged window (elements), and
# a warp's item: m-tiles of 16 output rows, channels
ONEHOT = {torch.bfloat16: (8, 2, 8, 2, 64), torch.float32: (12, 1, 4, 4, 32)}


def _vector_checks(what: str, win: torch.Tensor, onehot: bool = False):
    """The bodies move 16-byte pieces of a window row: refuse a row whose
    width is no multiple of 16 bytes (of 16 channels for the one-hot
    product's column pairs) and a window that starts off a 16-byte
    boundary."""
    c, es = win.shape[1], win.element_size()
    if (c * es) % 16 or (onehot and c % 16):
        raise ValueError(f"{what}: C = {c} {win.dtype} channels are no "
                         f"multiple of {16 if onehot else 16 // es}")
    if win.data_ptr() % 16:
        raise ValueError(f"{what}: the window must start on a 16-byte "
                         f"boundary")


def lane_pitch(w: int, es: int) -> int:
    """Row pitch, in elements, of the transposed slab (`layout` 1): an odd
    number of 4-byte words, at least W elements (W + 1 words at an even
    count), so that 32 threads reading 32 channels of one row hit 32
    banks."""
    words = -(-w * es // 4)
    return (words | 1) * 4 // es


def window_launch(w: int, c: int, es: int, layout: int):
    """(blocks, slab channels, shared-memory bytes per block) of
    `window_gather`: one block per slab of WINDOW_SLAB channels (the last
    may be narrower), holding the slab of every window row."""
    slab = min(WINDOW_SLAB, c)
    smem = w * slab * es if layout == 0 else slab * lane_pitch(w, es) * es
    return -(-c // slab), slab, smem


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the card `device` lies on (SMS for other devices)."""
    return _device_sms(device.index or 0) if device.type == "cuda" else SMS


def accum_smem(mode: str, dtype, w: int, c: int) -> int:
    """Shared-memory bytes of one `gather_accum` block: the window staged
    at its padded pitch (one-hot: rows to a multiple of 16, PAD elements
    per row), as it is (smem), or none (global)."""
    es = torch.empty((), dtype=dtype).element_size()
    if mode == "onehot":
        return -(-w // 16) * 16 * (c + ONEHOT[dtype][2]) * es
    return w * c * es if mode == "smem" else 0


def accum_launch(mode: str, dtype, w: int, c: int, n_rows: int,
                 sms: int = SMS):
    """(grid, threads, shared-memory bytes) of `gather_accum`'s persistent
    blocks for `n_rows` output rows: as many blocks as the SMs hold at once
    (by shared memory and by the body's register bound), no more than the
    work has items (one-hot: 16 x MT rows x COLS channels; the gathers:
    GATHER_GROUP rows), which the kernel deals to the blocks in turn, a
    warp's at a time."""
    smem = accum_smem(mode, dtype, w, c)
    if mode == "onehot":
        warps, per_sm, _, mt, cols = ONEHOT[dtype]
        threads = 32 * warps
        items = -(-n_rows // (16 * mt)) * -(-c // cols)
    else:
        threads, per_sm = GATHER[mode]
        items = -(-n_rows // GATHER_GROUP)
    if smem:
        per_sm = min(per_sm, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return max(1, min(sms * per_sm, items)), threads, smem


def window_gather_plain(win: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Plain version of `window_gather`: `win[rel]`."""
    return win[rel.long()]


def window_gather(win: torch.Tensor, rel: torch.Tensor,
                  layout: int = 0) -> torch.Tensor:
    """win [W, C] f32 or bf16, rel [T] int32 in [0, W) -> win[rel] [T, C],
    gathered from slabs of the window staged in shared memory as [W, slab]
    (`layout` 0) or transposed, along the fast axis (`layout` 1). A row id
    outside the window gives a zero row on the card. Tensors on the CPU
    take the plain version."""
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
    _vector_checks(what, win)
    w, c = win.shape
    _, slab, smem = window_launch(w, c, win.element_size(), layout)
    if smem > SMEM_BYTES:
        raise ValueError(f"{what}: a window of {w} rows does not fit in "
                         f"{SMEM_BYTES} bytes of shared memory ({smem} for "
                         f"a slab of {slab} {win.dtype} channels)")
    out = torch.empty((rel.shape[0], c), dtype=win.dtype, device=win.device)
    code = kernels.library().csn_probe_window_gather(
        kernels.dtype_code(win), layout, win.data_ptr(), rel.data_ptr(),
        out.data_ptr(), w, rel.shape[0], c, slab, kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out


def gather_accum_plain(rows: torch.Tensor, win: torch.Tensor,
                       k_offsets: int) -> torch.Tensor:
    """Plain version of `gather_accum`: rows [n_tiles * K, T] int, win
    [W, C] -> [n_tiles * T, C] f32 (float64 for a float64 window), out[t*T
    + i] = sum_k valid * win[rows[t*K + k, i]] with row ids outside [0, W)
    adding nothing."""
    n, t = rows.shape
    r = rows.reshape(n // k_offsets, k_offsets, t).long()
    valid = (r >= 0) & (r < win.shape[0])
    acc = torch.promote_types(win.dtype, torch.float32)
    g = win.to(acc)[torch.where(valid, r, 0)]              # [tiles, K, T, C]
    g = g * valid[..., None].to(acc)
    return g.sum(dim=1).reshape(-1, win.shape[1])


def split_bf16(win: torch.Tensor, parts: int = 3) -> list:
    """The window as `parts` bf16 tensors whose sum is its f32 value: hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), rounded to
    nearest as the one-hot kernel splits its B fragments. Three parts hold
    an f32 value's 24 significant bits exactly."""
    rest = win.float()
    out = []
    for _ in range(parts):
        p = rest.bfloat16()
        out.append(p)
        rest = rest - p.float()
    return out


def gather_accum_onehot(rows: torch.Tensor, win: torch.Tensor,
                        k_offsets: int, parts: int = 3) -> torch.Tensor:
    """A plain emulation of the one-hot kernel's arithmetic: per offset, the
    [T, W] one-hot matrix in bf16 times each of the window's `parts` bf16
    parts (`split_bf16`), the products added to an f32 sum in the order
    offset by offset, hi, mid, lo. Row ids outside [0, W) match no column.
    With three parts it computes `gather_accum_plain`'s function; with one,
    the window rounded to bf16."""
    n, t = rows.shape
    w, c = win.shape
    r = rows.reshape(n // k_offsets, k_offsets, t).long()
    cols = torch.arange(w, device=rows.device)
    split = [p.float() for p in split_bf16(win, parts)]
    out = torch.zeros((n // k_offsets, t, c), dtype=torch.float32,
                      device=win.device)
    for k in range(k_offsets):
        onehot = (r[:, k, :, None] == cols).to(torch.bfloat16).float()
        for p in split:
            out += onehot @ p
    return out.reshape(-1, c)


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
    dt = kernels.dtype_code(win)
    _vector_checks(what, win, onehot=mode == "onehot")
    w, c = win.shape
    t = rows.shape[1]
    if t % ACCUM_ROWS:
        raise ValueError(f"{what}: T = {t} must be a multiple of "
                         f"{ACCUM_ROWS}")
    n_tiles = rows.shape[0] // k_offsets
    grid, _, smem = accum_launch(mode, win.dtype, w, c, n_tiles * t,
                                 sm_count(win.device))
    if smem > SMEM_BYTES:
        raise ValueError(f"{what}: a window of {w} x {c} {win.dtype} does not "
                         f"fit in {SMEM_BYTES} bytes of shared memory ({mode}: "
                         f"{smem})")
    out = torch.empty((n_tiles * t, c), dtype=torch.float32,
                      device=win.device)
    code = kernels.library().csn_probe_gather_accum(
        dt, MODES[mode], rows.data_ptr(), win.data_ptr(), out.data_ptr(),
        n_tiles, k_offsets, w, t, c, grid, kernels.stream())
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
    """ms per call of `fn`: on the card its device time from CUDA graphs of
    `iters` calls (warm L2, `tools/timing.py::graph_ms`); on the CPU the
    host clock over `iters` calls after one warm-up."""
    if torch.device(device).type == "cuda":
        return graph_ms(fn, calls=iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def time_modes(n_tiles: int = 352, k_offsets: int = 9, iters: int = 20,
               dtype=torch.bfloat16, device="cuda", w: int = W, t: int = T,
               c: int = C):
    """The three modes on one set of inputs: ms per call (device time on the
    card) and us per (tile x K offsets), and the worst difference between
    the modes' outputs. Returns {mode: ms}."""
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
