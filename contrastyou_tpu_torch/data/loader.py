"""Batch assembly (counterpart of contrastyou_tpu/data/loader.py): items
collated into fixed-shape numpy batches, padded with ``mask`` False.

Batch: ``image`` f32 [B,H,W,1], ``target`` i32 [B,H,W], ``partition`` /
``patient`` / ``cycle`` / ``scan_id`` i32 [B] (``scan_id`` indexes
``get_scan_list()``), ``mask`` bool [B], and the host lists ``scan`` (None in
padded slots) and ``filename``. Batches are made in the calling thread; the
JAX loader's prefetch thread and native crop are host-speed knobs of the TPU
build.
"""
from __future__ import annotations

import itertools
import typing as t

import numpy as np

__all__ = ["BatchLoader", "collate"]


def collate(items: t.Sequence[dict], batch_size: int,
            scan_to_id: t.Mapping[str, int]) -> dict:
    """Stack item dicts, padding to ``batch_size`` by repeating the last
    item with mask False."""
    n = len(items)
    if not 1 <= n <= batch_size:
        raise ValueError(f"{n} items for a batch of {batch_size}")
    pad = batch_size - n
    items = list(items) + [items[-1]] * pad
    batch = {
        "image": np.stack([i["image"] for i in items]).astype(np.float32),
        "target": np.stack([i["target"] for i in items]).astype(np.int32),
        "partition": np.asarray([i["partition"] for i in items], np.int32),
        "patient": np.asarray([i.get("patient", 0) for i in items], np.int32),
        "cycle": np.asarray([i.get("cycle", 0) for i in items], np.int32),
        "scan_id": np.asarray([scan_to_id.get(i["scan"], -1) for i in items], np.int32),
        "mask": np.asarray([True] * n + [False] * pad),
        "scan": [(i["scan"] if k < n else None) for k, i in enumerate(items)],
        "filename": [i["filename"] for i in items],
    }
    for key in items[0]:
        if (key not in ("image", "target", "partition", "scan", "filename")
                and isinstance(items[0][key], np.ndarray)):
            batch[key] = np.stack([i[key] for i in items])
    return batch


class BatchLoader:
    """Iterable over collated batches, from a ``sampler`` of indices plus
    ``batch_size`` (a short last batch ends an infinite stream, pads a
    finite one) or from a ``batch_sampler`` of index lists, padded to
    ``pad_to`` (default: the sampler's largest batch). Item ``k`` of the
    loader's life draws its transforms from ``default_rng((seed *
    0x9E3779B1 + k) % 2**32)``."""

    def __init__(self, dataset, *, sampler: t.Optional[t.Iterable[int]] = None,
                 batch_size: t.Optional[int] = None,
                 batch_sampler: t.Optional[t.Iterable[t.List[int]]] = None,
                 pad_to: t.Optional[int] = None, seed: int = 0,
                 infinite: t.Optional[bool] = None):
        if (sampler is None) == (batch_sampler is None):
            raise ValueError("provide exactly one of sampler / batch_sampler")
        self._dataset = dataset
        self._sampler, self._batch_sampler = sampler, batch_sampler
        self._batch_size, self._pad_to, self._seed = batch_size, pad_to, seed
        self._infinite = (infinite if infinite is not None
                          else sampler is not None and batch_size is not None)
        self.scan_to_id = {s: i for i, s in enumerate(dataset.get_scan_list())}
        self._counter = itertools.count()

    @property
    def dataset(self):
        return self._dataset

    @property
    def item_shape(self) -> tuple:
        """Shape of one image item, drawn with a throwaway rng (the loader's
        own stream is untouched)."""
        return tuple(self._dataset[(0, np.random.default_rng(0))]["image"].shape)

    @property
    def batch_size(self) -> int:
        if self._batch_size is not None:
            return self._batch_size
        if self._pad_to is not None:
            return self._pad_to
        return self._batch_sampler.max_batch_size

    def _item(self, index: int) -> dict:
        rng = np.random.default_rng((self._seed * 0x9E3779B1 + next(self._counter)) % 2 ** 32)
        return self._dataset[(index, rng)]

    def __iter__(self) -> t.Iterator[dict]:
        if self._sampler is not None:
            it = iter(self._sampler)
            while True:
                idxs = list(itertools.islice(it, self._batch_size))
                if not idxs or (len(idxs) < self._batch_size and self._infinite):
                    return
                yield collate([self._item(i) for i in idxs], self._batch_size,
                              self.scan_to_id)
        else:
            pad_to = self.batch_size
            for idxs in self._batch_sampler:
                if idxs:
                    yield collate([self._item(i) for i in idxs[:pad_to]], pad_to,
                                  self.scan_to_id)
