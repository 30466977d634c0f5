"""Model registry of the port (counterpart of `csn_tpu/models/__init__.py`):
name -> class, discovered by introspection over the model modules."""

from __future__ import annotations

import inspect

from csn_tpu_torch.models import hrnet, res16unet, resnet, resunet
from csn_tpu_torch.models.layers import NormType

_MODULES = [hrnet, res16unet, resunet, resnet]

MODELS = {}
for _mod in _MODULES:
    for _name, _obj in vars(_mod).items():
        if (inspect.isclass(_obj) and _name[0] != "_"
                and ("Net" in _name or "CSN" in _name)
                and hasattr(_obj, "pyramid_requirements")):
            MODELS[_name] = _obj


def load_model(name: str):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name]
