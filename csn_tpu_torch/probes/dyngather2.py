"""Gather probe, matched shapes: indices padded to the window's height.

Counterpart of `scripts/probe_dyngather2.py`. The TPU's dynamic gather
wanted input, indices and output of one shape, so the script gathered W rows
from a W-row window (the T < W wanted rows first, the padding pointing at row
0) and kept the first T. On this card the gather has no such constraint; the
matched call is `probes.dyngather.window_gather` with T = W and padded
indices, from the window as [W, C] or staged transposed, and the timing runs
the three modes of `gather_accum` with the script's f32 window at W = 384,
T = 256.

    python -m csn_tpu_torch.probes.dyngather2 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from csn_tpu_torch.probes import dyngather

C = dyngather.C


def matched_gather(win: torch.Tensor, rel: torch.Tensor,
                   layout: int = 0) -> torch.Tensor:
    """win [W, C], rel [T <= W] int32 -> win[rel] [T, C] through the matched
    call: the indices padded with zeros to W, W rows gathered, the first T
    kept."""
    w, t = win.shape[0], rel.shape[0]
    if t > w:
        raise ValueError(f"matched gather: {t} row ids for a window of {w} "
                         f"rows")
    rel_pad = torch.zeros(w, dtype=torch.int32, device=rel.device)
    rel_pad[:t] = rel
    return dyngather.window_gather(win, rel_pad, layout)[:t]


def run(name: str, layout: int, w: int, t: int, dtype=torch.float32,
        device="cuda") -> float:
    """One matched form on the script's inputs; prints its line and returns
    the worst error against numpy's `win[rel]`."""
    win, rel, want = dyngather.probe_inputs(w, t, C)
    out = matched_gather(
        torch.from_numpy(win).to(device=device, dtype=dtype),
        torch.from_numpy(rel).to(device), layout)
    err = float(np.abs(out.float().cpu().numpy() - want).max())
    print(f"{name:44s} LAUNCHES  max_err={err:.2e}")
    return err


def time_modes(W: int = 384, T: int = 256, n_tiles: int = 352,
               k_offsets: int = 9, iters: int = 20, device="cuda"):
    """The script's timing geometry with its f32 window. Returns
    {mode: ms}."""
    return dyngather.time_modes(n_tiles=n_tiles, k_offsets=k_offsets,
                                iters=iters, dtype=torch.float32,
                                device=device, w=W, t=T, c=C)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    print(f"backend=torch devices=[{name}]")
    run("matched sublane gather W=384", 0, 384, 256, device=args.device)
    run("matched sublane gather W=256", 0, 256, 256, device=args.device)
    run("matched sublane gather bf16", 0, 384, 256, torch.bfloat16,
        args.device)
    run("matched lane gather (transposed)", 1, 256, 256, device=args.device)
    return time_modes(device=args.device)


if __name__ == "__main__":
    main()
