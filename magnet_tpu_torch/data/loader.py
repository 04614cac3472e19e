"""Host-side batching (counterpart of ``magnet_tpu/data/loader.py``):
shuffle, batch and collate to numpy, in the consumer's thread or, with
``prefetch`` > 0, on a background thread a bounded queue ahead of it.  The
thread only reads and collates host arrays; the copy to the card stays
with the consumer (the trainer's thread)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def collate(items: list[dict]) -> dict:
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}


class DataLoader:
    """Map-style loader: shuffle, batch, collate.

    ``dataset`` has ``__len__``, ``__getitem__`` -> dict and
    ``set_epoch(seed)``.  ``drop_last`` drops the trailing partial batch,
    on every split of ``build_loaders`` as in ``magnet_tpu``.  ``prefetch``
    > 0 collates on a worker thread up to that many batches ahead (the
    same batches in the same order); an exception in the worker is raised
    in the consumer.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.dataset.set_epoch(self.seed * 100003 + epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed * 7919 + self._epoch).shuffle(idx)
        return idx

    def _iter_sync(self) -> Iterator[dict]:
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone; False if it
            has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self._iter_sync():
                    if not put(batch):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            put(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            th.join()
