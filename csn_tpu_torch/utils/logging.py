"""Observability: hostname-prefixed logging (`tasks/main_csn.py:23-27`),
scalar/histogram/mesh logging to JSONL with optional tensorboardX
(`lib/trainer_csn.py:229-232,295-313`, `lib/csn_utils.py:99-109`).

The port's own copy of `csn_tpu/utils/logging.py` (no JAX in either).
"""

from __future__ import annotations

import json
import logging
import os
import time
import numpy as np


def setup_logging(level: str = "INFO"):
    ch = logging.StreamHandler()
    logging.getLogger().setLevel(getattr(logging, level.upper(), logging.INFO))
    fmt = "%(asctime)s %(message)s"
    logging.basicConfig(
        format=os.uname()[1].split(".")[0] + " " + fmt,
        datefmt="%m/%d %H:%M:%S",
        handlers=[ch],
        force=True,
    )


class MetricsWriter:
    """Scalars -> `<log_dir>/metrics.jsonl` (+ tensorboardX if available).

    Mesh logging (`add_mesh`) mirrors the reference's point-cloud logging at
    graph-construction time. An inactive writer (`active=False`: every rank
    of a multi-rank run but rank 0) writes nothing."""

    def __init__(self, log_dir: str, active: bool = True):
        self.log_dir = log_dir
        self.active = active
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        if not active:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        if not self.active:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"t": time.time(), "tag": tag,
                                "value": float(value), "step": int(step)})
                    + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int):
        if not self.active:
            return
        v = np.asarray(values).reshape(-1)
        if self._tb is not None:
            self._tb.add_histogram(tag, v, step)
        else:
            with open(self.path, "a") as f:
                f.write(json.dumps({
                    "t": time.time(), "tag": tag + "/hist", "step": int(step),
                    "mean": float(v.mean()), "std": float(v.std()),
                    "min": float(v.min()), "max": float(v.max())}) + "\n")

    def add_mesh(self, tag: str, vertices: np.ndarray, global_step: int = 0):
        if not self.active:
            return
        if self._tb is not None:
            try:
                self._tb.add_mesh(tag, vertices=vertices,
                                  global_step=global_step)
                return
            except Exception:
                pass
        out = os.path.join(self.log_dir, "meshes")
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, f"{tag.replace('/', '_')}_{global_step}.npy"),
                np.asarray(vertices))

    def close(self):
        if self._tb is not None:
            self._tb.close()
