"""A threaded, prefetched training iterator, mirroring
tpucdc/data/grain_pipeline.py.

The JAX package wraps its crop sampling in a ``grain.MapDataset`` so that
host threads prepare batches ahead of the train step. The port has no grain:
``Prefetcher`` runs a producer function on one thread into a bounded queue
and relays the producer's exception to the consumer, and
``grain_crop_iterator`` is that thread over ``datasets.crop_batch``, which
gives the same ``default_rng((seed, batch_idx))`` batches byte for byte.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from tpucdc_torch.data.datasets import crop_batch, usable_images


class Prefetcher:
    """Iterate ``produce()`` results made ahead on a daemon thread.

    Results keep their order (one producer, a FIFO queue). An exception in
    ``produce`` is raised by the next ``__next__`` (and every one after it),
    not lost in the thread. ``close`` stops the thread.
    """

    def __init__(self, produce: Callable[[], object], depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(produce,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _run(self, produce) -> None:
        try:
            while not self._stop.is_set():
                self._put(produce())
        except BaseException as e:  # noqa: BLE001 (relayed to the consumer)
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._error is not None:
            raise self._error
        item = self._queue.get()
        if isinstance(item, BaseException):
            self._error = item
            raise item
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


def grain_crop_iterator(images: list[np.ndarray], batch_size: int,
                        crop: int, seed: int = 0, prefetch: int = 4,
                        start: int = 0) -> Prefetcher:
    """Infinite prefetched batch iterator of [-1, 1] f32 crops;
    deterministic per batch index, from batch ``start``."""
    usable = usable_images(images, crop)
    counter = iter(range(start, 2 ** 62))
    return Prefetcher(lambda: crop_batch(usable, batch_size, crop, seed,
                                         next(counter)), depth=prefetch)
