"""Background batch prefetching.

The reference overlaps data loading with compute via torch DataLoader worker
processes (`lib/dataset.py:296-308`, num_workers); here it is a
small thread pool that runs the host-side pyramid/kernel-map construction
(numpy or the C++ engine — both release the GIL in their hot loops) while the
device executes the previous step, keeping a bounded queue of ready batches.

The port's own copy of `csn_tpu/data/prefetch.py` (no JAX in either).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Runs `make_batch()` in a worker thread, `depth` batches ahead."""

    def __init__(self, make_batch: Callable[[], object], depth: int = 2):
        self.make_batch = make_batch
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.make_batch()
            except BaseException as e:  # surfaced on next __next__
                self._exc = e
                self.q.put(None)
                return
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        item = self.q.get()
        if item is None and self._exc is not None:
            raise self._exc
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        # Join (bounded): a daemon thread killed at interpreter exit while
        # inside native code aborts the process ("FATAL: exception not
        # rethrown"); draining above unblocks a worker stuck in q.put.
        self._thread.join(timeout=60.0)
        try:  # drop anything produced between drain and join
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
