"""Device times of short calls on a CUDA card, from CUDA graphs.

A kernel of a few tens of microseconds takes less time on the card than
its wrapper's host work (checks, `ctypes`), so timing single calls between
two events measures the host. `graph_ms` captures a batch of calls in a
CUDA graph and times its replays, which launch the captured kernels back to
back: the device's time alone.

Replayed calls read the same inputs, so they run with a warm L2 (50 MB on
the H100) wherever the inputs fit there. With `cold`, each captured call
follows a read of a buffer twice the L2's size, and the time is that of the
graph of (read, call) pairs less that of the reads alone: the call's time
from device memory, its output's write-back included.
"""

from __future__ import annotations

import statistics

FLUSH_BYTES = 2 * 50 * 2 ** 20   # twice the H100's L2


def _replay_ms(graph, reps: int) -> list:
    import torch
    graph.replay()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return times


def _capture(calls: int, *fns):
    """A CUDA graph of `calls` rounds of `fns`, one after another."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            for fn in fns:
                fn()
    return graph


def graph_ms(fn, calls: int = 20, reps: int = 7, cold: bool = False) -> float:
    """Median device ms of one call of `fn`, from `reps` replays of a CUDA
    graph that holds `calls` calls; with `cold`, from device memory (see
    the module's doc). `fn` must be capturable (no host synchronisation);
    its outputs come from the graph's own memory pool."""
    import torch
    fns = [fn]
    if cold:
        buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
        fns.append(buf.sum)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the capture
        for _ in range(2):
            for f in fns:
                f()
    torch.cuda.current_stream().wait_stream(side)
    if not cold:
        return statistics.median(_replay_ms(_capture(calls, fn), reps)) / calls
    flush = buf.sum
    both = _replay_ms(_capture(calls, flush, fn), reps)
    alone = _replay_ms(_capture(calls, flush), reps)
    return (statistics.median(both) - statistics.median(alone)) / calls
