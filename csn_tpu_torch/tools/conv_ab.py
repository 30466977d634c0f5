"""Two checkouts' sparse conv kernels side by side on one card.

    python -m csn_tpu_torch.tools.conv_ab OTHER_ROOT

OTHER_ROOT is another checkout of this repo, for example `git archive` of
the parent commit unpacked into a git-ignored directory. Each checkout runs
in its own process with its own kernel build, in the order other, this,
this, other. A run times K1 (`sparse_conv_fwd`), `sparse_conv_dw` and the
im2col pair (`sparse_conv_im2col_fwd`, and the backward through
`conv_im2col_bwd_kernels`) on seeded bf16 inputs at conv shapes of
HRNetSimCSN3S and Res16UNet34C (CUDA-event medians per call over batches of
calls), and hashes every output. The script prints each run's times,
whether each kernel's outputs are bitwise equal across the checkouts, and
the registers ptxas reports for the kernels of `csrc/sparse_conv.cu` and
`csrc/sparse_conv_bwd.cu` in each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

# (rows, offsets, Cin, Cout): HRNetSimCSN3S's levels at 64, 128 and 256
# channels and its k5 stem, Res16UNet34C's widest k2 conv
SHAPES = ((90112, 27, 64, 64), (30208, 27, 128, 128), (10240, 27, 256, 256),
          (90112, 125, 3, 32), (5000, 8, 96, 384))
LIVE = 0.35      # share of map entries that name a row
SEED = 7
REGISTER_SOURCES = ("sparse_conv.cu", "sparse_conv_bwd.cu")


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


def _digest(t) -> str:
    import torch
    t = t.contiguous()
    raw = t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def worker(reps: int) -> dict:
    """The current checkout's kernels at every shape: {shape: {kernel:
    [ms, digest]}}."""
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
            name: [_median_ms(fn, reps), _digest(fn())]
            for name, fn in calls.items()}
    return res


def registers(root: Path) -> list:
    """(kernel, registers) of every kernel ptxas compiles in
    REGISTER_SOURCES of the checkout at `root`."""
    from csn_tpu_torch import kernels
    filt = shutil.which("cu++filt", path=str(Path(kernels.nvcc()).parent))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in REGISTER_SOURCES:
            res = subprocess.run(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(root / "csn_tpu_torch" / "csrc" / src), "-o",
                 str(Path(tmp) / "k.o")], capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc {src} in {root}:\n{res.stderr}")
            name = None
            for line in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                    if filt:
                        name = subprocess.run([filt, name], capture_output=True,
                                              text=True).stdout.strip()
                        # kernel<(int)2, (int)4, false>(args) -> kernel<2, 4,
                        # false>
                        name = re.sub(r"\((?:int|bool|anonymous namespace)\)",
                                      "", name)
                        name = name.split("(")[0].split("::")[-1]
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    out.append((f"{src} {name}", int(m.group(1))))
                    name = None
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.reps)))
        return 0
    this = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    runs = {}
    for tag, root in (("other", other), ("this", this), ("this", this),
                      ("other", other)):
        # the worker imports the package of `root`; this file drives it
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run(
            [sys.executable, __file__, str(other), "--worker", "--reps",
             str(args.reps)], cwd=root, env=env, capture_output=True,
            text=True)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.setdefault(tag, []).append(run)
        for shape, kern in run.items():
            print(f"[ab {tag}{len(runs[tag])}] {shape}: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, (ms, _) in kern.items()))
    for shape, kern in runs["this"][0].items():
        same = {name: all(r[shape][name][1] == digest
                          for r in runs["this"] + runs["other"])
                for name, (_, digest) in kern.items()}
        print(f"[ab] {shape}: bitwise equal across the checkouts: "
              + ", ".join(f"{name} {v}" for name, v in same.items()))
    for tag, root in (("other", other), ("this", this)):
        for name, regs in registers(root):
            print(f"[ab registers {tag}] {name}: {regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
