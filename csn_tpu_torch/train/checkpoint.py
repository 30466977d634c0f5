"""Checkpoint / resume (counterpart of `csn_tpu/train/checkpoint.py`).

The reference contract (`MinkowskiNet/lib/utils.py:11-61`,
`lib/trainer_csn.py:315-387`): one file per checkpoint holding the model
(parameters and BatchNorm running statistics) and the optimizer state, with
epoch/iteration, the best-metric quadruple and, for CSN, `csn_data`
(patience, cooldown, n_graph_construction, train/val neighbor lists), so a
resumed run keeps its shape graph. A `weights.pt` symlink always points at
the latest. `config.json` is dumped alongside and reloaded on resume.

Format: `torch.save` of {"model": state_dict, "optimizer": state_dict} to
`checkpoint_<model><postfix>.pt`, and the same json sidecar of host scalars
as the JAX package writes (`<file>.json`), so the host state of the two
packages' checkpoints compares key by key. Every file is written to a
temporary sibling and `os.replace`d.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

EXT = ".pt"
LATEST = "weights" + EXT


def _to_jsonable(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def checkpoint_name(name: str, postfix: Optional[str] = None) -> str:
    return f"checkpoint_{name}{postfix or ''}{EXT}"


def save_checkpoint(
    log_dir: str,
    name: str,
    tree_state: Dict[str, Any],     # {"model": ..., "optimizer": ...}
    host_state: Dict[str, Any],     # epoch, iteration, bests, csn_data, ...
    config: Optional[Dict[str, Any]] = None,
    postfix: Optional[str] = None,
    overwrite: bool = True,
    link_latest: bool = True,
) -> str:
    os.makedirs(log_dir, exist_ok=True)
    if overwrite:
        filename = checkpoint_name(name, postfix)
    else:
        it = host_state.get("iteration", 0)
        filename = checkpoint_name(name, f"_iter_{it}")
    path = os.path.join(log_dir, filename)
    # overwrite=True rewrites the same path every epoch: a crash mid-write
    # must not truncate the only copy of the latest checkpoint
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(tree_state, f)
        f.flush()
        os.fsync(f.fileno())   # the data before the rename
    os.replace(tmp, path)
    _fsync_dir(path)
    _atomic_write_text(path + ".json",
                       json.dumps(_to_jsonable(host_state), indent=2))
    if config is not None:
        _atomic_write_text(os.path.join(log_dir, "config.json"),
                           json.dumps(_to_jsonable(config), indent=4))
    if postfix is None and link_latest:
        link = os.path.join(log_dir, LATEST)
        _atomic_symlink(filename, link)
        _atomic_symlink(filename + ".json", link + ".json")
    return path


def _fsync_dir(path: str):
    """fsync the directory so the rename itself is durable. Best effort: not
    every file system allows it."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _atomic_write_text(path: str, text: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def _atomic_symlink(target: str, link: str):
    tmp = link + ".tmp"
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


def load_checkpoint(path: str, device="cpu", require_host: bool = True):
    """Returns (tree_state, host_state), tensors mapped to `device`.
    `require_host=False` for weights-only loads (`--weights foo.pt`): a bare
    file shared without its `.json` sidecar is a legitimate artifact there,
    while resume paths keep failing loudly on a missing sidecar."""
    tree_state = torch.load(path, map_location=device, weights_only=True)
    host_state: Dict[str, Any] = {}
    if require_host or os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            host_state = json.load(f)
    return tree_state, host_state
