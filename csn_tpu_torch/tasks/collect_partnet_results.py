"""Aggregate per-category evaluation results.

Counterpart of `csn_tpu/tasks/collect_partnet_results.py` (port of
`MinkowskiNet/lib/collect_partnet_results.py`): scans
`<root>/<Category>*/results/results_log.txt` (the files written by
`test_on(save_pred_dir=...)`), prints per-category Shape/Part IoU rows and
the 17-category averages.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

from csn_tpu_torch.data.partnet import CATEGORIES


def parse_results_log(path: str):
    shape_iou = part_iou = None
    with open(path) as f:
        for line in f:
            m = re.match(r"Shape IoU:\s*([\d.]+)", line)
            if m:
                shape_iou = float(m.group(1))
            m = re.match(r"Part IoU:\s*([\d.]+)", line)
            if m:
                part_iou = float(m.group(1))
    return shape_iou, part_iou


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results_root", type=str, required=True)
    ap.add_argument("--pattern", type=str,
                    default="{cat}*/results/results_log.txt")
    args = ap.parse_args(argv)

    rows = []
    for cat in CATEGORIES:
        hits = sorted(glob.glob(
            os.path.join(args.results_root, args.pattern.format(cat=cat))))
        if not hits:
            print(f"{cat}: MISSING")
            continue
        s, p = parse_results_log(hits[-1])
        if s is None or p is None:
            # a results_log.txt that exists but doesn't parse (e.g. a killed
            # eval run) must not silently deflate the 17-category average
            print(f"{cat}: UNPARSEABLE ({hits[-1]})")
            continue
        rows.append((cat, s, p))
        print(f"{cat}\tShapeIoU={s}\tPartIoU={p}")
    if rows:
        avg_s = sum(r[1] for r in rows) / len(rows)
        avg_p = sum(r[2] for r in rows) / len(rows)
        print(f"AVG({len(rows)} cats)\tShapeIoU={avg_s:.2f}\t"
              f"PartIoU={avg_p:.2f}")
    return rows


if __name__ == "__main__":
    main()
