"""Evaluate a (possibly reference-pretrained) CSA model on the test split.

Counterpart of `csn_tpu/midfc/get_csa_pred.py` (port of
`MID-FC/get_csa_pred.py` with its defects fixed). Loads either a converted
reference torch checkpoint (`--torch_ckpt trained_layers.pth`, through
`midfc/convert.py`) or one of the port's own checkpoints (`--ckpt
trained_layers.pt`, where the JAX package takes `--msgpack_ckpt`),
builds or loads the test kNN graph, and writes `part_IoU_summaries.csv`.

The model is pinned to float32, as the JAX entry point pins it: this
surface reproduces a reference checkpoint's numbers. The attention follows
the device like every other surface of the runner: on the card the flash
kernels in f32 (online softmax is exact, so the numbers agree with the dense
form to rounding), with `--device cpu` the plain dense attention, which is
what the JAX entry point pins with `use_flash=False`.

Usage:
  python -m csn_tpu_torch.midfc.get_csa_pred --data_root <root> \
      --partname Chair --num_classes 39 --n_heads 8 --K 4 \
      --torch_ckpt <trained_layers.pth> \
      --knn_graph_dir logs/knn_graphs/n_heads_8/Chair [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from csn_tpu_torch.midfc import chunk_size_arg
from csn_tpu_torch.midfc.data import CSAFeaturesDataset, FeaturesDataset
from csn_tpu_torch.midfc.training import (
    MidfcConfig, MidfcRunner, compute_knn_graphs, load_params,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--logs_dir", type=str, default="logs/csa_pred")
    ap.add_argument("--partname", type=str, default="Chair")
    ap.add_argument("--num_classes", type=int, default=39)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--torch_ckpt", type=str, default="",
                    help="a reference trained_layers.pth")
    ap.add_argument("--ckpt", type=str, default="",
                    help="a trained_layers.pt written by this package")
    ap.add_argument("--knn_graph_dir", type=str, default="")
    ap.add_argument("--chunk_size", type=chunk_size_arg, default=500,
                    help="attention chunk (reference checkpoints: 500); "
                    "0 = FULL attention (only for checkpoints trained so)")
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--num_points", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--save_pred_dir", type=str, default="",
                    help="also dump per-shape CSA argmax predictions "
                         "(midfc_csa_K_{K}/, an input of the paper-figure "
                         "accumulators, csn_tpu_torch/midfc/paper.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = MidfcConfig(
        logs_dir=args.logs_dir, partname=args.partname,
        num_classes=args.num_classes, n_heads=args.n_heads, K=args.K,
        batch_size=args.batch_size,
        chunk_size=args.chunk_size if args.chunk_size > 0 else None,
        d_model=args.d_model, num_points=args.num_points,
        # pinned f32: this surface reproduces the reference checkpoint's
        # numbers; bf16 is the training paths' default. The attention is
        # the device's: the f32 flash kernels on the card, dense on the CPU
        compute_dtype="float32")
    runner = MidfcRunner(cfg, "csa", device=args.device)

    train_root = os.path.join(args.data_root, "train", args.partname)
    test_root = os.path.join(args.data_root, "test", args.partname)
    train_ds = FeaturesDataset(train_root, cfg.num_points)
    test_ds = FeaturesDataset(test_root, cfg.num_points)

    runner.initialize()
    if args.torch_ckpt:
        from csn_tpu_torch.midfc.convert import load_torch_checkpoint

        runner.load_state(load_torch_checkpoint(args.torch_ckpt,
                                                after_fc=True), strict=False)
        logging.info("loaded torch checkpoint %s", args.torch_ckpt)
    elif args.ckpt:
        runner.load_state(load_params(args.ckpt))
        logging.info("loaded %s", args.ckpt)

    if args.knn_graph_dir:
        te_graph = np.load(os.path.join(args.knn_graph_dir, "test.npy"))
    else:
        _, te_graph = compute_knn_graphs(runner, train_ds, test_ds, cfg.K,
                                         args.partname)

    csa_test = CSAFeaturesDataset(test_root, train_root, te_graph, cfg.K,
                                  cfg.num_points, same_collection=False)
    iou, loss = runner.validate(csa_test, is_csa=True)
    if args.save_pred_dir:
        from csn_tpu_torch.midfc.paper import save_predictions

        n = save_predictions(
            runner, csa_test,
            os.path.join(args.save_pred_dir, f"midfc_csa_K_{cfg.K}"),
            is_csa=True)
        logging.info("dumped %d per-shape CSA predictions to %s", n,
                     args.save_pred_dir)
    os.makedirs(args.logs_dir, exist_ok=True)
    out_csv = os.path.join(args.logs_dir, "part_IoU_summaries.csv")
    with open(out_csv, "w") as f:
        f.write(f",{args.partname}\n0,{iou * 100}\n")
    print(f"{args.partname}: part IoU {iou * 100:.2f} (loss {loss:.4f}) "
          f"-> {out_csv}")
    return iou


if __name__ == "__main__":
    main()
