"""Host-side batching (counterpart of ``magnet_tpu/data/loader.py``),
synchronous: a batch is read and collated when the loop asks for it."""
from __future__ import annotations

from typing import Iterator

import numpy as np


def collate(items: list[dict]) -> dict:
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}


class DataLoader:
    """Map-style loader: shuffle, batch, collate.

    ``dataset`` has ``__len__``, ``__getitem__`` -> dict and
    ``set_epoch(seed)``.  ``drop_last`` drops the trailing partial batch,
    on every split of ``build_loaders`` as in ``magnet_tpu``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
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

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])
