"""The port's one way into `csn_tpu`'s framework-neutral host code.

The batch builder — `csn_tpu/core/pyramid.py`, `core/native.py` (the C++
engine in `csrc/coords.cpp`) and `data/pipeline.py` — is numpy and C++, and
the port reuses it as it is. But `csn_tpu/core/__init__.py` imports
`core/conv.py`, which imports `jax`, so on a machine without JAX a plain
`import csn_tpu.core.pyramid` fails in the package `__init__`.

This module works around that: if `csn_tpu.core` is not imported yet, it
registers a bare package module under that name, with `__path__` set to the
`csn_tpu/core` directory, so the submodules import without running
`core/__init__.py`. Nothing in the repo imports names from the
`csn_tpu.core` package namespace itself (only submodules), so the JAX
package still imports and runs afterwards in the same process. The shim
goes away once `csn_tpu/core/__init__.py` imports its submodules lazily.
"""

from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path


def _register_bare_core() -> None:
    if "csn_tpu.core" in sys.modules:
        return
    import csn_tpu  # the package __init__ holds only a docstring

    core = types.ModuleType("csn_tpu.core")
    core.__path__ = [str(Path(csn_tpu.__file__).resolve().parent / "core")]
    core.__package__ = "csn_tpu.core"
    sys.modules["csn_tpu.core"] = core
    csn_tpu.core = core


_register_bare_core()

pyramid = importlib.import_module("csn_tpu.core.pyramid")
native = importlib.import_module("csn_tpu.core.native")
pipeline = importlib.import_module("csn_tpu.data.pipeline")
