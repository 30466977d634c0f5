"""flax variables of the JAX package -> `state_dict` of the port's models.

The port's module attributes follow the flax module names, so the mapping
is a renaming, applied to each '/'-joined flax path in this order:

  .../MaskedBatchNorm_0/x        -> .../x  (the norm module is the BN)
  SparseConv_i, Norm_i           -> conv_i, norm_i  (inside BasicBlock)
  Conv1x1_i/Dense_0              -> conv1x1_i/linear
  stages_i_j_b                   -> stages/i/j/b
  exchange_i_j_k_s_0 / _1        -> exchange/i/j/k/s/conv / norm
  trans_i_s_0 / _1               -> trans/i/s/conv / norm
  fc1|fc2|out_head/Dense_0       -> fc1|fc2|out_head/linear
  LayerNorm_0/scale              -> layer_norm/weight

Sparse-conv kernels `[K, Cin, Cout]` keep their layout and offset order.
Dense kernels are `[in, out]` in flax and are TRANSPOSED into the
`[out, in]` `weight` of `nn.Linear`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RULES = (
    (r"/MaskedBatchNorm_0/", "/"),
    (r"(^|/)SparseConv_(\d+)/", r"\1conv_\2/"),
    (r"(^|/)Norm_(\d+)/", r"\1norm_\2/"),
    (r"(^|/)Conv1x1_(\d+)/Dense_0/", r"\1conv1x1_\2/linear/"),
    (r"(^|/)stages_(\d+)_(\d+)_(\d+)/", r"\1stages/\2/\3/\4/"),
    (r"(^|/)exchange_(\d+)_(\d+)_(\d+)_(\d+)_0/", r"\1exchange/\2/\3/\4/\5/conv/"),
    (r"(^|/)exchange_(\d+)_(\d+)_(\d+)_(\d+)_1/", r"\1exchange/\2/\3/\4/\5/norm/"),
    (r"(^|/)trans_(\d+)_(\d+)_0/", r"\1trans/\2/\3/conv/"),
    (r"(^|/)trans_(\d+)_(\d+)_1/", r"\1trans/\2/\3/norm/"),
    (r"(^|/)(fc1|fc2|out_head)/Dense_0/", r"\1\2/linear/"),
    (r"(^|/)LayerNorm_0/scale$", r"\1layer_norm/weight"),
    (r"(^|/)LayerNorm_0/", r"\1layer_norm/"),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, path + "/")
        else:
            yield path, v


def _torch_name(flax_path: str, ndim: int) -> str:
    """Port `state_dict` key of one flax leaf path (without the
    params/batch_stats collection)."""
    name = flax_path
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    if name.endswith("/kernel") and ndim == 2:  # Dense: nn.Linear weight
        name = name[:-len("kernel")] + "weight"
    return name.replace("/", ".")


def flax_to_torch(params: Mapping, batch_stats: Mapping
                  ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (the flax `params` and `batch_stats`
    collections) -> a `state_dict` for `model.load_state_dict(strict=True)`."""
    sd = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree):
            arr = np.asarray(leaf, dtype=np.float32)
            name = _torch_name(path, arr.ndim)
            if name.endswith(".weight") and arr.ndim == 2:
                arr = arr.T
            sd[name] = torch.tensor(arr)
    return sd


def load_jax_trainer_state(trainer, params: Mapping, batch_stats: Mapping,
                           momentum: Optional[Mapping] = None,
                           adam: Optional[Tuple[Mapping, Mapping]] = None,
                           opt_steps: int = 0,
                           host: Optional[Mapping] = None) -> None:
    """Put an initialized port trainer at the point of a JAX trainer whose
    state is given as numpy trees: `params` and `batch_stats` (the flax
    collections), the optimizer's `momentum` tree (SGD: the `TraceState`
    buffer) or `adam` = (mu, nu) trees, all shaped like `params`, after
    `opt_steps` optimizer steps, and `host`, the dict the JAX trainer's
    `_host_state()` returns. With `opt_steps == 0` the optimizer state stays
    empty: both packages then start SGD's buffer from the first gradient."""
    trainer.model.load_state_dict(flax_to_torch(params, batch_stats),
                                  strict=True)
    trainer.model.to(trainer.device)
    opt = trainer.optimizer
    opt.state.clear()
    named = dict(trainer.model.named_parameters())
    if opt_steps > 0 and momentum is not None:
        for name, buf in flax_to_torch(momentum, {}).items():
            opt.state[named[name]] = {
                "momentum_buffer": buf.to(trainer.device)}
    if opt_steps > 0 and adam is not None:
        mu, nu = (flax_to_torch(t, {}) for t in adam)
        for name in mu:
            opt.state[named[name]] = {
                "step": torch.tensor(float(opt_steps)),
                "exp_avg": mu[name].to(trainer.device),
                "exp_avg_sq": nu[name].to(trainer.device)}
    if host is None:
        return
    trainer.curr_iter = host["iteration"]
    trainer.epoch = host["epoch"] - 1
    for k in ("best_val_part_iou", "best_val_shape_iou", "best_val_loss",
              "best_val_acc"):
        setattr(trainer, k, host[k])
        setattr(trainer, k + "_iter", host[k + "_iter"])
    if "plateau" in host and hasattr(trainer, "plateau"):
        trainer.plateau.load_state_dict(dict(host["plateau"]))
    if "csn_data" in host:
        cd = host["csn_data"]
        trainer.patience = cd["patience"]
        trainer.cooldown = cd["cooldown"]
        trainer.n_graph_construction = cd["n_graph_construction"]
        trainer.train_dataset.neighbors = [
            (int(a), [int(x) for x in b]) for a, b in cd["train_neighbors"]]
        trainer.val_dataset.neighbors = [
            (int(a), [int(x) for x in b]) for a, b in cd["val_neighbors"]]
