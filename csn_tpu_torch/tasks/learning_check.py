"""End-to-end learning evidence on synthetic data with the port's real
trainers, on the card.

The port's own form of the JAX package's `scripts/learning_check.py`: the
same flags and defaults, the same configurations and the same check. It
drives `CSNTrainer` (the product path: the combined (K+1)B backbone, the
sparse conv kernels, flash attention, SGD with weight decay) on a synthetic
PartNet category and asserts that the train loss falls substantially:

    python -m csn_tpu_torch.tasks.learning_check [--task csn|seg|midfc] \
        [--device cuda|cpu] [--epochs 40] [--dtype auto] ...

* csn: HRNetSimCSN2S, K=1, B=4, k5 stem, d_model 64 in 2 heads (head dim
  32: the bf16 flash kernels' D=32 tensor-core body on the card),
  level_shrink 2.0, seed 0, category Display; `_train_iter` and
  `losses.val` as the JAX script drives them.
* seg: the same through `SegTrainer` and HRNetSeg2S, K=0.
* midfc: the `MidfcRunner` CSA step (B=4, 10000 points, 256 channels, K=4,
  8 heads, 15 classes, `--steps` steps, the `MidfcConfig` default dtype)
  on a learnable task, labels a fixed random projection of the features.

The data is the synthetic category of `write_synthetic_partnet`, built in
memory from the same seed (`data.synthetic.synthetic_partnet_splits`), so
the card's machine needs no h5py. The run prints `RESULT ...` and
`LEARNING CHECK PASSED`, and exits nonzero when `last < 0.8 * first` fails.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Optional

import numpy as np

# the MID-FC task's data: batch, points, channels, neighbours
MIDFC_SHAPE = (4, 10000, 256, 4)
MIDFC_CLASSES, MIDFC_HEADS = 15, 8
CATEGORY, N_VAL, N_TEST = "Display", 4, 4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--dtype", default="auto")
    ap.add_argument("--use_flash", default="auto")
    ap.add_argument("--use_windows", default="auto")
    ap.add_argument("--num_points", type=int, default=2048)
    ap.add_argument("--shapes", type=int, default=16)
    ap.add_argument("--task", default="csn", choices=["csn", "seg", "midfc"])
    ap.add_argument("--steps", type=int, default=150,
                    help="midfc: training steps")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    return ap


def trainer_config(args, log_dir: str):
    """The JAX script's `Config` for the csn and seg tasks, on
    `args.device`."""
    from csn_tpu_torch.config import Config

    model, k = ("HRNetSeg2S", 0) if args.task == "seg" \
        else ("HRNetSimCSN2S", 1)
    return Config(
        model=model, partnet_path="", partnet_category=CATEGORY,
        batch_size=4, val_batch_size=4, test_batch_size=4, k_neighbors=k,
        conv1_kernel_size=5, d_model=64, n_head=2, max_epoch=args.epochs,
        stat_freq=1000, num_points=args.num_points, level_shrink=2.0,
        seed=0, compute_dtype=args.dtype, use_flash=args.use_flash,
        use_windows=args.use_windows, log_dir=log_dir,
        device=args.device).normalized()


def midfc_config(args):
    """The JAX script's `MidfcConfig`. 'auto' is the shipped `MidfcConfig`
    default (f32), not `Config`'s device rule."""
    from csn_tpu_torch.midfc.training import MidfcConfig

    b, p, c, k = MIDFC_SHAPE
    dt = MidfcConfig.compute_dtype if args.dtype == "auto" else args.dtype
    return MidfcConfig(num_classes=MIDFC_CLASSES, n_heads=MIDFC_HEADS, K=k,
                       batch_size=b, num_points=p, d_model=c, seed=0,
                       compute_dtype=dt)


def _report(task: str, dtype: str, first: float, last: float) -> dict:
    print(f"RESULT task={task} dtype={dtype} "
          f"first_loss={first:.4f} last_loss={last:.4f}", flush=True)
    passed = last < 0.8 * first
    if passed:
        print("LEARNING CHECK PASSED", flush=True)
    return {"task": task, "dtype": dtype, "first": first, "last": last,
            "passed": passed}


def trainer_check(args, inspect: Optional[Callable] = None) -> dict:
    """The csn and seg tasks: `args.epochs` epochs of `_train_iter` on the
    in-memory synthetic category. `inspect(trainer)`, if given, runs before
    the trainer's directory goes; its value is the result's 'inspect'."""
    from csn_tpu_torch.data.synthetic import synthetic_partnet_splits

    if args.task == "seg":
        from csn_tpu_torch.tasks.main_seg import build_trainer
    else:
        from csn_tpu_torch.tasks.main_csn import build_trainer
    splits = synthetic_partnet_splits(
        CATEGORY, n_train=args.shapes, n_val=N_VAL, n_test=N_TEST,
        num_points=args.num_points)
    with tempfile.TemporaryDirectory(prefix="learning_check_") as tmp:
        cfg = trainer_config(args, tmp)
        cfg.check_supported()
        trainer = build_trainer(cfg, datasets=(splits["train"],
                                               splits["val"]))
        trainer.initialize()
        if args.task == "csn":
            trainer.construct_shape_graph(recalculate=False)
        first = last = None
        iters_per_epoch = max(args.shapes // cfg.batch_size, 1)
        try:
            for i in range(args.epochs * iters_per_epoch):
                trainer._train_iter()
                loss = trainer.losses.val   # the last batch's loss
                if first is None:
                    first = loss
                last = loss
                if i % (10 * iters_per_epoch) == 0:
                    print(f"iter {i:4d} loss {loss:.4f}", flush=True)
        finally:
            trainer._close_prefetch()
        res = _report(args.task, args.dtype, first, last)
        if inspect is not None:
            res["inspect"] = inspect(trainer)
    return res


def midfc_check(args, inspect: Optional[Callable] = None) -> dict:
    """MID-FC CSA: the runner's own step (`_grad_step`, `_apply`: flash on
    500-point chunks, Adam(0.5, 0.999), NaN zeroing) on labels correlated
    with the features through a fixed random projection, drawn with numpy
    in the JAX script's order."""
    from csn_tpu_torch.midfc.training import MidfcRunner

    cfg = midfc_config(args)
    b, p, c, k = MIDFC_SHAPE
    runner = MidfcRunner(cfg, "csa", device=args.device)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(b, p, c)).astype(np.float32)
    w = rng.normal(size=(c, MIDFC_CLASSES)).astype(np.float32)
    labels = (feats @ w).argmax(-1).astype(np.int32) + 1   # 1..15
    # 15 classes and positive labels only: the masked CE (label 0 =
    # unlabeled is absent here)
    labels = np.minimum(labels, MIDFC_CLASSES - 1)
    neighbors = np.stack(
        [feats] + [rng.normal(size=(b, p, c)).astype(np.float32)
                   for _ in range(k)], axis=1)
    runner.initialize()
    first = last = None
    for i in range(args.steps):
        loss, grads = runner._grad_step(feats, labels, neighbors,
                                        runner.draw_step_seed())
        runner._apply(grads)
        if i % 25 == 0 or i == args.steps - 1:
            lv = float(loss)
            print(f"step {i:4d} loss {lv:.4f}", flush=True)
            if first is None:
                first = lv
            last = lv
    res = _report("midfc", cfg.compute_dtype, first, last)
    if inspect is not None:
        res["inspect"] = inspect(runner)
    return res


def run(args, inspect: Optional[Callable] = None) -> dict:
    """One task of `args` (`build_parser`'s): {'task', 'dtype', 'first',
    'last', 'passed'}."""
    if args.task == "midfc":
        return midfc_check(args, inspect)
    return trainer_check(args, inspect)


def main(argv=None) -> int:
    res = run(build_parser().parse_args(argv))
    if not res["passed"]:
        raise SystemExit(f"train loss did not fall substantially "
                         f"({res['first']:.3f} -> {res['last']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
