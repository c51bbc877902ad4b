"""Host -> card streaming: threaded decode into pinned memory, async copy.

Stands where adaptsegnet_tpu/data/pipeline.py::PrefetchIterator (`:54`)
stands, and the reference's DataLoader (train_gta2cityscapes_multi.py:
235-238, num_workers=4, pin_memory): a feeder thread decodes batches with a
pool of `num_workers` threads, collates them to numpy, and stages them as
pinned CPU tensors `prefetch` batches ahead; `next()` copies the next batch
to the device with `non_blocking=True`, so the copy is enqueued behind the
running step and the host never waits on decode at these batch sizes.
Batch order is `epoch_batches`' (a seeded reshuffle per pass, the JAX
package's order). In a data-parallel group every rank draws the same
shuffle and takes its interleaved slice (`process_index`,
`process_count`), so the union of the ranks' batches is the global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch


def epoch_batches(n_items: int, batch_size: int, seed: int = 1338,
                  process_index: int = 0,
                  process_count: int = 1) -> Iterator[np.ndarray]:
    """Index batches, reshuffled each pass, the last partial batch dropped
    (DataLoader shuffle=True, drop_last=True).

    Every process draws the same seeded order and takes its interleaved
    slice `order[process_index::process_count]`, so `batch_size` is the
    per-process batch (adaptsegnet_tpu/data/pipeline.py:25-47)."""
    rng = np.random.default_rng(seed)
    while True:
        order = np.arange(n_items)
        rng.shuffle(order)
        if process_count > 1:
            order = order[process_index::process_count]
        n = len(order)
        for i in range(0, n - n % batch_size, batch_size):
            yield order[i:i + batch_size]


class PrefetchLoader:
    """Iterate a map-style dataset as dicts of device tensors.

    `collate` maps a list of dataset items to a dict of numpy arrays;
    `batch_size` is the per-process batch of the slice `process_index` of
    `process_count` (see `epoch_batches`)."""

    def __init__(self, dataset, batch_size: int,
                 collate: Callable[[list[Any]], dict[str, np.ndarray]],
                 device: torch.device, seed: int = 1338,
                 num_workers: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self._dataset = dataset
        self._collate = collate
        self._device = torch.device(device)
        self._pin = self._device.type == "cuda"
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._indices = epoch_batches(len(dataset), batch_size, seed,
                                      process_index, process_count)
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _feed(self):
        try:
            for idxs in self._indices:
                if self._stop.is_set():
                    return
                items = list(self._pool.map(self._dataset.__getitem__, idxs))
                batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in self._collate(items).items()}
                if self._pin:
                    batch = {k: v.pin_memory() for k, v in batch.items()}
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surface decode errors to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return {k: v.to(self._device, non_blocking=True)
                for k, v in item.items()}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._feeder.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)
