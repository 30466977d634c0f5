"""Parameter conversion for the MID-FC head.

Two sources map onto the `state_dict` of `csn_tpu_torch.midfc.model.
CrossShapeAt`:

* `convert_state_dict` / `load_torch_checkpoint`: the reference's pretrained
  `trained_layers.pth` (the state_dict of `MID-FC/csa_models.py:146-180`;
  BASELINE.md: MID-FC + CSA, n_heads=8, K=4). Counterpart of
  `csn_tpu/midfc/convert.py`:

    attention.w_qs.weight [H*dk, dm]  -> attention.mha.w_qs.weight
    attention.fc.weight               -> attention.mha.fc.weight
    attention.norm.{weight,bias}      -> attention.mha.layer_norm.{weight,bias}
    logit.weight [C, 256, 1, 1]       -> logit.weight [C, 256]
    compatibility_{q,k}.{weight,bias} -> compatibility_{q,k}.{weight,bias}
    fc_1.0.0.weight [256, 928, 1, 1]  -> fc_1.weight (only for after_fc=False)
    fc_1.0.1.{weight,bias,running_*}  -> fc_1_bn.{scale,bias,mean,var}

  Both sides are torch `[out, in]` layouts, so nothing is transposed.

* `flax_to_torch_midfc`: the JAX package's MID-FC `params` (and
  `batch_stats`) as nested dicts of numpy arrays. Dense kernels `[in, out]`
  are transposed into `nn.Linear` weights; the biases of
  `compatibility_q/k` are kept. It extends `models/convert.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from csn_tpu_torch.models.convert import flax_to_torch


def convert_state_dict(sd: Mapping[str, object], after_fc: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """sd: reference name -> array-like (torch tensors or numpy). Returns
    the port's `state_dict` (f32)."""

    def a(name):
        v = sd[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.tensor(np.asarray(v, dtype=np.float32))

    out = {f"attention.mha.{n}.weight": a(f"attention.{n}.weight")
           for n in ("w_qs", "w_ks", "w_vs", "fc")}
    out["attention.mha.layer_norm.weight"] = a("attention.norm.weight")
    out["attention.mha.layer_norm.bias"] = a("attention.norm.bias")
    out["logit.weight"] = a("logit.weight")[:, :, 0, 0].contiguous()
    if "compatibility_q.weight" in sd:
        for n in ("compatibility_q", "compatibility_k"):
            out[f"{n}.weight"] = a(f"{n}.weight")
            out[f"{n}.bias"] = a(f"{n}.bias")
    if not after_fc and "fc_1.0.0.weight" in sd:
        out["fc_1.weight"] = a("fc_1.0.0.weight")[:, :, 0, 0].contiguous()
        out["fc_1_bn.scale"] = a("fc_1.0.1.weight")
        out["fc_1_bn.bias"] = a("fc_1.0.1.bias")
        out["fc_1_bn.mean"] = a("fc_1.0.1.running_mean")
        out["fc_1_bn.var"] = a("fc_1.0.1.running_var")
    return out


def load_torch_checkpoint(path: str, after_fc: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Load a reference `.pth` and convert it."""
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_state_dict(sd, after_fc=after_fc)


def flax_to_torch_midfc(params: Mapping,
                        batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's MID-FC variables (nested dicts of numpy arrays) ->
    a `state_dict` for `CrossShapeAt.load_state_dict(strict=True)`. The flax
    module names are the port's attribute names (`attention/mha/w_qs`,
    `logit`, `compatibility_q`, `fc_1`, `fc_1_bn`), so this is
    `models.convert.flax_to_torch`'s renaming: Dense kernels transposed,
    `LayerNorm_0/scale` -> `layer_norm.weight`, biases kept."""
    return flax_to_torch(params, batch_stats or {})
