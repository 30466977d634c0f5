"""Per-category MID-FC launcher + summary aggregation.

Counterpart of `csn_tpu/midfc/run_training.py` (port of `MID-FC/
run_training.py`: SSA/CSA per-category launches with the hyperparameter
tables at `run_training.py:7-23`; `run_save_knn.py`: kNN graph
precomputation; and the summary collection). One process per category, like
the reference's one-job-per-category scheme. Same arguments and output
files as the JAX package's launcher, except that checkpoints are
`trained_layers.pt` (a `state_dict` written by `torch.save`), plus
`--device`. `--attention_type pred` is the pretrained-eval loop
(`MID-FC/run_csa_pred.py`): per-category `get_csa_pred` over
`logs_root/pretrained_models/run_{run}/<Cat>` checkpoints
(`trained_layers.pt`, else the reference's `trained_layers.pth`) and the
`pretrained_models/knn_graphs/n_heads_{n}/<Cat>` graphs when present.

Usage:
  python -m csn_tpu_torch.midfc.run_training --attention_type ssa \
      --data_root <root with {train,test}/<Cat>/{fc_1,point_labels}> \
      --start 0 --end 16
  python -m csn_tpu_torch.midfc.run_training --attention_type save_knn ...
  python -m csn_tpu_torch.midfc.run_training --attention_type csa --K 4 ...
  python -m csn_tpu_torch.midfc.run_training --attention_type pred --K 4 ...

With --data_parallel / --seq_parallel, start one process per rank with the
usual RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT environment (and
LOCAL_RANK for the card); every rank reads the same data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

NAMES = ["Bed", "Bottle", "Chair", "Clock", "Dishwasher", "Display", "Door",
         "Earphone", "Faucet", "Knife", "Lamp", "Microwave", "Refrigerator",
         "StorageFurniture", "Table", "TrashCan", "Vase"]
TRAIN_NUM = [133, 315, 4489, 406, 111, 633, 149, 147, 435, 221, 1554, 133,
             136, 1588, 5707, 221, 741]
MAX_ITERS = [3000, 3000, 20000, 5000, 3000, 5000, 3000, 3000, 5000, 3000,
             10000, 3000, 3000, 10000, 20000, 3000, 10000]
TEST_NUM = [37, 84, 1217, 98, 51, 191, 51, 53, 132, 77, 419, 39, 31, 451,
            1668, 63, 233]
VAL_NUM = [24, 37, 617, 50, 19, 104, 25, 28, 81, 29, 234, 12, 20, 230, 843,
           37, 102]
SEG_NUM = [15, 9, 39, 11, 7, 4, 5, 10, 12, 10, 41, 6, 7, 24, 51, 11, 6]


def _init_distributed(n_ranks: int, device: str) -> str:
    """Join the torch.distributed world described by the environment;
    returns this rank's device."""
    import torch.distributed as dist

    from csn_tpu_torch.parallel.collectives import join_world

    device = join_world(device)
    if dist.get_world_size() != n_ranks:
        raise SystemExit(
            f"--data_parallel x --seq_parallel = {n_ranks} ranks, but the "
            f"world has {dist.get_world_size()}")
    return device


def main(argv=None):
    from csn_tpu_torch.midfc import chunk_size_arg
    from csn_tpu_torch.midfc.data import FeaturesDataset
    from csn_tpu_torch.midfc.training import (
        CHECKPOINT_NAME, MidfcConfig, MidfcRunner, load_params,
        save_knn_graphs, train_csa, train_ssa,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, required=True,
                    help="root with {train,test}/<Category>/{fc_1,point_labels}")
    ap.add_argument("--logs_root", type=str, default="logs")
    ap.add_argument("--attention_type", type=str, default="ssa",
                    choices=["ssa", "csa", "save_knn", "pred"])
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--n_heads", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=2)
    ap.add_argument("--run", type=int, default=1)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=16)
    ap.add_argument("--testing", action="store_true")
    ap.add_argument("--chunk_size", type=chunk_size_arg, default=500,
                    help="attention chunk (reference: 500); 0 = FULL "
                    "attention over the point set (under --seq_parallel it "
                    "runs ring attention)")
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--num_points", type=int, default=10000)
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="shard the batch over this many ranks (gradients "
                    "all-reduced)")
    ap.add_argument("--seq_parallel", type=int, default=1,
                    help="shard the point axis over this many ranks "
                    "(block-diagonal chunked attention is point-parallel)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    chunk_size = args.chunk_size if args.chunk_size > 0 else None

    at = args.attention_type
    device = args.device
    if args.data_parallel * args.seq_parallel > 1:
        device = _init_distributed(args.data_parallel * args.seq_parallel,
                                   device)
    if at == "ssa":
        logs_base = os.path.join(
            args.logs_root, f"ssa_n_heads_{args.n_heads}", f"run_{args.run}")
    elif at == "pred":
        logs_base = os.path.join(args.logs_root, "pretrained_models",
                                 f"run_{args.run}")
    else:
        logs_base = os.path.join(
            args.logs_root,
            f"sgd_csa_n_heads_{args.n_heads}_K_{args.K}", f"run_{args.run}")

    ious = {}
    for k, name in enumerate(NAMES):
        if k < args.start or k > args.end:
            continue
        train_root = os.path.join(args.data_root, "train", name)
        test_root = os.path.join(args.data_root, "test", name)
        if at == "pred":
            from csn_tpu_torch.midfc import get_csa_pred

            cat_dir = os.path.join(logs_base, name)
            pred_argv = [
                "--data_root", args.data_root,
                "--logs_dir", cat_dir,
                "--partname", name,
                "--num_classes", str(SEG_NUM[k]),
                "--n_heads", str(args.n_heads),
                "--K", str(args.K),
                "--batch_size", str(args.batch_size),
                "--chunk_size", str(args.chunk_size),
                "--d_model", str(args.d_model),
                "--num_points", str(args.num_points),
                "--device", device,
            ]
            own = os.path.join(cat_dir, CHECKPOINT_NAME)
            pth = os.path.join(cat_dir, "trained_layers.pth")
            if os.path.exists(own):
                pred_argv += ["--ckpt", own]
            elif os.path.exists(pth):
                pred_argv += ["--torch_ckpt", pth]
            graph_dir = os.path.join(args.logs_root, "pretrained_models",
                                     "knn_graphs", f"n_heads_{args.n_heads}",
                                     name)
            if os.path.exists(os.path.join(graph_dir, "test.npy")):
                pred_argv += ["--knn_graph_dir", graph_dir]
            ious[name] = get_csa_pred.main(pred_argv) * 100
            continue
        cfg = MidfcConfig(
            logs_dir=os.path.join(logs_base, name), partname=name,
            num_classes=SEG_NUM[k], n_heads=args.n_heads, K=args.K,
            batch_size=args.batch_size, lr=args.lr,
            weight_decay=args.weight_decay,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            testing=args.testing, chunk_size=chunk_size,
            d_model=args.d_model, num_points=args.num_points,
            data_parallel=args.data_parallel,
            seq_parallel=args.seq_parallel)
        ssa_path = os.path.join(args.logs_root,
                                f"ssa_n_heads_{args.n_heads}",
                                f"run_{args.run}", name, CHECKPOINT_NAME)

        if at == "ssa":
            best, _ = train_ssa(cfg, FeaturesDataset(train_root,
                                                     cfg.num_points),
                                FeaturesDataset(test_root, cfg.num_points),
                                device=device)
            ious[name] = best * 100
        elif at == "save_knn":
            runner = MidfcRunner(cfg, "ssa", device=device)
            tr_ds = FeaturesDataset(train_root, cfg.num_points)
            te_ds = FeaturesDataset(test_root, cfg.num_points)
            runner.initialize()
            if os.path.exists(ssa_path):
                runner.load_state(load_params(ssa_path))
            save_knn_graphs(runner, tr_ds, te_ds, args.K, name,
                            logs_root=args.logs_root)
        else:  # csa
            graph_dir = os.path.join(args.logs_root, "knn_graphs",
                                     f"n_heads_{args.n_heads}", name)
            tr_graph = np.load(os.path.join(graph_dir, "train.npy"))
            te_graph = np.load(os.path.join(graph_dir, "test.npy"))
            best, _ = train_csa(cfg, train_root, test_root, tr_graph,
                                te_graph,
                                ssa_params_path=ssa_path
                                if os.path.exists(ssa_path) else None,
                                device=device)
            ious[name] = best * 100

    if ious:
        mean_iou = sum(ious.values()) / len(ious)
        for name, iou in ious.items():
            print(f"name: {name}, iou: {iou}")
        print(f"\n mean_IoU: {mean_iou}\n")
        if at == "pred":
            os.makedirs(logs_base, exist_ok=True)
            out_csv = os.path.join(logs_base, "part_IoU_summaries.csv")
            with open(out_csv, "w") as f:
                f.write("," + ",".join(ious) + ",mean\n")
                f.write("0," + ",".join(f"{v}" for v in ious.values())
                        + f",{mean_iou}\n")
            print(f"-> {out_csv}")
    return ious


if __name__ == "__main__":
    main()
