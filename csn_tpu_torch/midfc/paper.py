"""MID-FC paper-figure tooling (reference `MID-FC/utils.py:41-105`;
counterpart of `csn_tpu/midfc/paper.py`).

The reference's figure pipeline concatenates, per shape, render-ready
`[pts | gt | midfc_pred | ssa_pred | csa_pred]` arrays out of the per-shape
`.npy` dump directories, and `[pts | labels]` arrays for neighbor renders.
It depends on per-shape SSA/CSA prediction dumps (`midfc_ssa/`,
`midfc_csa_K_{K}/`) that the reference never ships a writer for (its
`*forPaper` dataset variants only read them); `save_predictions` below is
that missing writer, driven by the port's `MidfcRunner`.

Layout produced/consumed (matching `utils.py:55-60`):
    <data_root>/<split>/<part>/{pts,point_labels,midfc_pred}/shape_{i}.npy
    <pred_root>/<part>/midfc_ssa/shape_{i}.npy
    <pred_root>/<part>/midfc_csa_K_{K}/shape_{i}.npy
    <render_root>/<part>/shape_{i}.npy   (concatenated columns)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_predictions(runner, dataset, out_dir: str, is_csa: bool) -> int:
    """Per-shape argmax prediction dumps (`shape_{i}.npy`, one [P] int row
    per point of the UNPADDED shape). Returns the number of shapes
    written."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = runner.cfg
    i = 0
    for data in dataset.batches(cfg.batch_size):
        if is_csa:
            feats, labels, neighbors, valid = data
        else:
            feats, labels, valid = data
            neighbors = None
        logits = runner._eval(feats, neighbors)[:valid].float().cpu().numpy()
        pred = np.argmax(logits, axis=-1)
        for b in range(valid):
            np.save(os.path.join(out_dir, f"shape_{i}.npy"), pred[b])
            i += 1
    return i


def _load_col(path: str) -> np.ndarray:
    a = np.load(path)
    a = np.asarray(a)
    if a.ndim == 1:
        a = a[:, None]
    elif a.ndim > 2:
        a = a.reshape(a.shape[0] if a.shape[0] > 4 else -1, -1)
    return a


def accumulate_predictions(data_root: str, partname: str, render_root: str,
                           pred_root: Optional[str] = None, K: int = 4,
                           split: str = "test") -> int:
    """`utils.py:45-80`: per shape, concatenate
    [pts(3) | gt(1) | midfc_pred(1) | ssa_pred(1) | csa_pred(1)] columns
    into `<render_root>/<part>/shape_{i}.npy`. Rows are truncated to the
    shortest column (prediction dumps are unpadded point counts)."""
    droot = os.path.join(data_root, split, partname)
    proot = os.path.join(pred_root or droot, partname) \
        if pred_root else droot
    render_dir = os.path.join(render_root, partname)
    os.makedirs(render_dir, exist_ok=True)

    pts_path = os.path.join(droot, "pts")
    n_shapes = len(os.listdir(pts_path))
    for i in range(n_shapes):
        name = f"shape_{i}.npy"
        cols = [_load_col(os.path.join(pts_path, name)),
                _load_col(os.path.join(droot, "point_labels", name)),
                _load_col(os.path.join(droot, "midfc_pred", name)),
                _load_col(os.path.join(proot, "midfc_ssa", name)),
                _load_col(os.path.join(proot, f"midfc_csa_K_{K}", name))]
        n = min(c.shape[0] for c in cols)
        a = np.concatenate([c[:n].astype(np.float32) for c in cols], axis=1)
        np.save(os.path.join(render_dir, name), a)
    return n_shapes


def accumulate_neigh(data_root: str, partname: str, render_root: str,
                     split: str = "train") -> int:
    """`utils.py:82-105`: per shape, concatenate [pts(3) | labels(1)] into
    `<render_root>/<part>/shape_{i}.npy` (neighbor-shape renders)."""
    droot = os.path.join(data_root, split, partname)
    render_dir = os.path.join(render_root, partname)
    os.makedirs(render_dir, exist_ok=True)
    pts_path = os.path.join(droot, "pts")
    shapes = sorted(os.listdir(pts_path))
    for name in shapes:
        pts = _load_col(os.path.join(pts_path, name))
        lab = _load_col(os.path.join(droot, "point_labels", name))
        n = min(pts.shape[0], lab.shape[0])
        a = np.concatenate([pts[:n].astype(np.float32),
                            lab[:n].astype(np.float32)], axis=1)
        np.save(os.path.join(render_dir, name), a)
    return len(shapes)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["predictions", "neighbors"],
                    default="predictions")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--partname", required=True)
    ap.add_argument("--render_root", default="logs/rendering")
    ap.add_argument("--pred_root", default="")
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--split", default="")
    args = ap.parse_args(argv)
    if args.mode == "predictions":
        n = accumulate_predictions(args.data_root, args.partname,
                                   args.render_root,
                                   args.pred_root or None, args.K,
                                   args.split or "test")
    else:
        n = accumulate_neigh(args.data_root, args.partname,
                             args.render_root, args.split or "train")
    print(f"{args.partname}: {n} shapes -> {args.render_root}")


if __name__ == "__main__":
    main()
