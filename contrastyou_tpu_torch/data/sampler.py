"""Index samplers and scan partitions (counterpart of InfiniteRandomSampler
and ContrastBatchSampler in contrastyou_tpu/data/sampler.py and of the
partition rule in contrastyou_tpu/data/base.py), host-side numpy."""
from __future__ import annotations

import itertools
import typing as t

import numpy as np

__all__ = ["partition_index", "InfiniteRandomSampler", "ContrastBatchSampler"]


def partition_index(cur_index: int, max_len: int, partition_num: int = 3) -> int:
    """Anatomical partition of slice ``cur_index`` of a scan of ``max_len``
    slices: the 3-way threshold rule for ``partition_num`` == 3 (ACDC), else
    ``cur // (cut + 1)`` (base.py ``get_partition``)."""
    cut = max(max_len // partition_num, 1)
    if partition_num > 3:
        part = cur_index // (cut + 1)
    elif cur_index <= cut - 1:
        part = 0
    elif cur_index <= 2 * cut:
        part = 1
    else:
        part = 2
    return min(part, partition_num - 1)


class InfiniteRandomSampler:
    """Endless stream of dataset indices, one fresh permutation of
    ``range(size)`` after another (the same numpy draws as the JAX sampler,
    so one seed gives the same indices). Single process: the per-process
    stride of the JAX sampler belongs to data-parallel training."""

    def __init__(self, size: int, seed: int = 0):
        self._size = size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> t.Iterator[int]:
        while True:
            yield from self._rng.permutation(self._size).tolist()

    def batches(self, batch_size: int) -> t.Iterator[t.List[int]]:
        """Consecutive ``batch_size`` runs of the stream (data/loader.py
        ``BatchLoader`` with a sampler)."""
        it = iter(self)
        while True:
            yield list(itertools.islice(it, batch_size))


class ContrastBatchSampler:
    """Endless batches: for each of ``scan_sample_num`` random scans, up to
    ``partition_sample_num`` random slices of every partition. Slice ``i``
    belongs to scan ``scan_names[i]`` and partition ``partitions[i]``; the
    numpy draws follow the JAX sampler's, so one seed gives the same indices."""

    def __init__(self, scan_names: t.Sequence[str], partitions: t.Sequence[int], *,
                 scan_sample_num: int = 4, partition_sample_num: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self._scan2index: t.Dict[str, t.List[int]] = {}
        self._partition2index: t.Dict[int, t.List[int]] = {}
        for i, (scan, part) in enumerate(zip(scan_names, partitions)):
            self._scan2index.setdefault(str(scan), []).append(i)
            self._partition2index.setdefault(int(part), []).append(i)
        if not 1 <= scan_sample_num <= len(self._scan2index):
            raise ValueError(f"scan_sample_num={scan_sample_num} with "
                             f"{len(self._scan2index)} scans")
        self._scan_sample_num = scan_sample_num
        self._partition_sample_num = partition_sample_num
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._scans = sorted(self._scan2index)
        self._partition_sets = {p: set(v) for p, v in self._partition2index.items()}

    @property
    def batch_size(self) -> int:
        """Nominal batch size (a batch is smaller when a scan lacks a
        partition)."""
        return self._scan_sample_num * len(self._partition2index) * self._partition_sample_num

    def __iter__(self) -> t.Iterator[t.List[int]]:
        while True:
            batch: t.List[int] = []
            chosen = self._rng.choice(len(self._scans), self._scan_sample_num,
                                      replace=False)
            for si in chosen:
                scan_indices = set(self._scan2index[self._scans[si]])
                for p in sorted(self._partition_sets):
                    pool = sorted(scan_indices & self._partition_sets[p])
                    if len(pool) < self._partition_sample_num:
                        continue
                    picked = self._rng.choice(len(pool), self._partition_sample_num,
                                              replace=False)
                    batch.extend(pool[i] for i in picked)
            if self._shuffle:
                self._rng.shuffle(batch)
            yield batch
