"""Profiling / tracing utilities.

Counterpart of `csn_tpu/utils/profiling.py` (which replaces the reference's
`TFSolver.timeline()` Chrome traces and `TFSolver.param_stats()`,
`MID-FC/ocnn_extraction/tfsolver.py:148-195`), over `torch.profiler`.
Wall-clock data/iter timers live in utils/timer.py.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the CPU and, where there is one, the card:
    `with trace('outputs/trace'): step()` writes `<log_dir>/trace.json`
    (Chrome trace format; open in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace written to %s", path)


def param_stats(params) -> Dict[str, int]:
    """Per-tensor parameter counts + total (tfsolver param_stats analogue).
    `params`: an `nn.Module` or a `state_dict`-like mapping of tensors; the
    keys are '/'-joined as in the JAX package."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    stats: Dict[str, int] = {}
    total = 0
    for name, leaf in params.items():
        n = int(leaf.numel()) if hasattr(leaf, "numel") else 1
        stats[name.replace(".", "/")] = n
        total += n
    stats["__total__"] = total
    for k, v in sorted(stats.items()):
        logging.info("%s: %d", k, v)
    return stats


def annotate(name: str):
    """Named region for traces: `with annotate('graph-rebuild'): ...`."""
    import torch

    return torch.profiler.record_function(name)
