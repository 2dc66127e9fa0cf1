"""Data pipeline: deterministic sharded batching with background prefetch —
a copy of ``repro/data/loader.py`` (numpy and threading only), so a batch's
example ids are the reference's for the same seed, host and step.

Host-side pipeline feeding the train steps:

- ``ShardedBatcher``: deterministic per-host slicing of a global batch
  (host h of H takes rows [h·B/H, (h+1)·B/H)) with an epoch-seeded
  permutation — restartable from any step (fault tolerance: the RNG is
  (seed, epoch)-keyed, so a resumed job regenerates the identical stream);
- ``Prefetcher``: a background thread keeps ``depth`` batches ready so host
  data prep overlaps device compute (the standard single-host analogue of
  per-host input pipelines).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class ShardedBatcher:
    def __init__(
        self,
        n_examples: int,
        global_batch: int,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        if global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.n = n_examples
        self.gb = global_batch
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.per_host = global_batch // n_hosts

    def epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n)

    def batch_indices(self, step: int) -> np.ndarray:
        """Global step -> this host's example ids (deterministic, resumable)."""
        per_epoch = self.n // self.gb
        epoch, within = divmod(step, max(per_epoch, 1))
        order = self.epoch_order(epoch)
        lo = (within % max(per_epoch, 1)) * self.gb
        rows = order[lo : lo + self.gb]
        return rows[self.host_id * self.per_host : (self.host_id + 1) * self.per_host]


class Prefetcher:
    """Wrap a batch-producing callable; keep ``depth`` batches ready."""

    def __init__(self, make_batch: Callable[[int], object], depth: int = 2,
                 start_step: int = 0):
        self.make_batch = make_batch
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.make_batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
