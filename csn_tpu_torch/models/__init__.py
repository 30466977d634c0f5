"""Model registry of the port (counterpart of `csn_tpu/models/__init__.py`):
name -> class, for the model families ported so far."""

from __future__ import annotations

from csn_tpu_torch.models.hrnet import (
    HRNetSeg2S, HRNetSeg3S, HRNetSeg4S, HRNetSimCSN2S, HRNetSimCSN3S,
    HRNetSimCSN4S,
)

MODELS = {cls.__name__: cls
          for cls in (HRNetSeg2S, HRNetSeg3S, HRNetSeg4S, HRNetSimCSN2S,
                      HRNetSimCSN3S, HRNetSimCSN4S)}


def load_model(name: str):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; the port has {sorted(MODELS)}")
    return MODELS[name]
