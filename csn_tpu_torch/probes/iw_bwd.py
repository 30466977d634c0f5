"""Slot-load probe: value loads from a scratch at a run-time slot index.

Counterpart of `scripts/probe_iw_bwd.py`. The TPU script isolated which load
of a small `[slots, 8, window]` scratch at a dynamic slot its compiler
refused (the interpolation backward's double-buffered tables). The kernel of
`csn_tpu_torch/csrc/probe_slots.cu` runs the same seven bodies on a
shared-memory scratch; each must equal its plain version, which shows that
run-time indexing of shared memory needs no work-around on this card.

Every variant zeroes a scratch of two slots, fills slot 0 from `x` cast to
the scratch's type, and returns `out[8, 128] = sum_{j<3} body(scratch[j % 2])`:

    P1  int32 [2, 8, 512]    slot[:, :128]
    P2  f32   [2, 8, 512]    slot[:, :128]
    P3  f32   [2, 256, 128]  slot[:8, :128]   (the control: the conv shape)
    P4  int32 [2, 8, 512]    row slot[3, :128], broadcast
    P5  int32 [2, 8, 512]    a select over the slots
    P6  int32 [2, 8, 512]    the slice slot[3:4, :128], broadcast
    P7  int32 [2, 8, 512]    the whole slot loaded, then row 3

    python -m csn_tpu_torch.probes.iw_bwd [--extra] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from csn_tpu_torch import kernels

NB, W, CP = 2, 512, 128
N_JOBS = 3
# variant -> (name, scratch shape, scratch dtype)
VARIANTS = {
    1: ("P1 i32 [2,8,512] load s[j%2]", (NB, 8, W), torch.int32),
    2: ("P2 f32 [2,8,512] load s[j%2]", (NB, 8, W), torch.float32),
    3: ("P3 control f32 [2,256,128] load s[j%2]", (NB, 256, CP),
        torch.float32),
    4: ("P4 i32 [2,8,512] row load s[j%2][k]", (NB, 8, W), torch.int32),
    5: ("P5 fix i32 [2,8,512] where-select slots", (NB, 8, W), torch.int32),
    6: ("P6 fix i32 [2,8,512] slice load s[j%2][k:k+1]", (NB, 8, W),
        torch.int32),
    7: ("P7 full-slot load then lax.slice", (NB, 8, W), torch.int32),
}


def slot_load_plain(variant: int, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `slot_load`: the scratch as a tensor, the slot
    index as a Python integer."""
    _, shape, dtype = VARIANTS[variant]
    s = torch.zeros(shape, dtype=dtype, device=x.device)
    s[0] = x.to(dtype)          # float -> int32 truncates toward zero
    acc = torch.zeros((8, 128), dtype=torch.float32, device=x.device)
    for j in range(N_JOBS):
        slot = s[j % NB]
        if variant in (1, 2, 5):
            acc += slot[:, :128].float()
        elif variant == 3:
            acc += slot[:8, :128]
        else:                   # 4, 6, 7: row 3, broadcast over the 8 rows
            acc += slot[3:4, :128].float().expand(8, 128)
    return acc


def slot_load(variant: int, x: torch.Tensor) -> torch.Tensor:
    """x f32 [8, 512] (variant 3: [256, 128]) -> out [8, 128] f32 by the
    variant's body. A tensor on the CPU takes the plain version."""
    what = "probe_slot_load"
    if variant not in VARIANTS:
        raise ValueError(f"{what}: variant must be one of "
                         f"{sorted(VARIANTS)}, got {variant}")
    shape = VARIANTS[variant][1][1:]
    if tuple(x.shape) != shape or x.dtype != torch.float32:
        raise ValueError(f"{what}: variant {variant} wants x f32 "
                         f"{list(shape)}, got {x.dtype} {list(x.shape)}")
    if x.device.type == "cpu":
        return slot_load_plain(variant, x)
    kernels.require_cuda(what, x)
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    code = kernels.library().csn_probe_slot_load(
        variant, x.data_ptr(), out.data_ptr(), kernels.stream())
    kernels.check(code, what)
    kernels.LAUNCHES[what] += 1
    return out


def probe_input(variant: int) -> np.ndarray:
    """The script's input of the variant's slot shape (seed 0)."""
    shape = VARIANTS[variant][1][1:]
    return np.random.default_rng(0).normal(size=shape).astype(np.float32)


def probe(variant: int, device="cuda") -> float:
    """One variant on the script's input; prints its line and returns the
    worst difference from the plain version."""
    x = torch.from_numpy(probe_input(variant)).to(device)
    out = slot_load(variant, x)
    err = float((out - slot_load_plain(variant, x)).abs().max())
    print(f"{VARIANTS[variant][0]:55s} LAUNCHES  max_err={err:.2e}")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--extra", action="store_true",
                    help="also the bodies P6 and P7 (the script's "
                    "PROBE_EXTRA run)")
    args = ap.parse_args(argv)
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    print(f"backend=torch devices=[{name}]")
    res = {v: probe(v, args.device) for v in (3, 1, 2, 4, 5)}
    if args.extra:
        res.update(extra(args.device))
    return res


def extra(device="cuda"):
    """The script's two further bodies (its PROBE_EXTRA run)."""
    return {v: probe(v, device) for v in (6, 7)}


if __name__ == "__main__":
    main()
