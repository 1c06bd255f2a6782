"""Batch assembly (counterpart of contrastyou_tpu/data/loader.py): items
collated into fixed-shape numpy batches, padded with ``mask`` False.

Batch: ``image`` f32 [B,H,W,1], ``target`` i32 [B,H,W], ``partition`` /
``patient`` / ``cycle`` / ``scan_id`` i32 [B] (``scan_id`` indexes
``get_scan_list()``), ``mask`` bool [B], and the host lists ``scan`` (None in
padded slots) and ``filename``.

Batches are assembled in a background thread, ``prefetch`` of them ahead
(4 by default, as JAX's ``BatchLoader``; ``prefetch=None`` makes them in
the calling thread): :class:`PrefetchIterator`. The thread runs the same
generator the synchronous loader runs, so the batches and their order are
the same; an exception raised in it reaches the consumer at the batch
where it occurred. ``fast_crop=(out_h, out_w, "random" | "center")`` crops,
scales and stacks the preloaded uint8 slices of a ``sampler`` loader in
the native library (``native.py``: ``native/fast_collate.cpp`` over
``num_threads`` threads), skipping the dataset's item transforms, as JAX's
``_fast_batch``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import typing as t

import numpy as np

__all__ = ["BatchLoader", "PrefetchIterator", "collate", "DEFAULT_PREFETCH"]

#: batches the loader's thread assembles ahead (JAX ``BatchLoader``'s default)
DEFAULT_PREFETCH = 4
#: the fast path's crop-offset stream: ``default_rng(seed ^ FAST_CROP_SEED_XOR)``
FAST_CROP_SEED_XOR = 0x5F5E1


class _Worker:
    """The state a prefetch thread shares with its consumer (the thread holds
    no reference to the :class:`PrefetchIterator`, so dropping that stops it)."""

    def __init__(self, source: t.Iterator, depth: int):
        self.source, self.depth = source, depth
        self.buffer: "collections.deque" = collections.deque()
        self.cond = threading.Condition()
        self.stop = False
        self.ended = False       # the source ended or raised: no more items
        self.thread: t.Optional[threading.Thread] = None

    def run(self) -> None:
        while True:
            with self.cond:
                while len(self.buffer) >= self.depth and not self.stop:
                    self.cond.wait()
                if self.stop:
                    return
            try:
                item = ("batch", next(self.source))
            except StopIteration:
                item = ("end", None)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                item = ("error", e)
            with self.cond:
                # a batch made while stopping is kept for the next start
                self.buffer.append(item)
                if item[0] != "batch":
                    self.ended = True
                self.cond.notify_all()
            if item[0] != "batch":
                return

    def halt(self) -> None:
        with self.cond:
            self.stop = True
            self.cond.notify_all()
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        self.stop = False


class PrefetchIterator:
    """Iterates ``source`` through a background thread that keeps up to
    ``depth`` items ahead. :meth:`pause` stops the thread and keeps what it
    made (the next ``next`` starts it again, so nothing is lost or
    reordered); :meth:`close` stops it for good. Dropping the iterator
    closes it."""

    def __init__(self, source: t.Iterator, depth: int):
        if depth < 1:
            raise ValueError(f"prefetch depth {depth} < 1")
        self._w = _Worker(source, int(depth))
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        w = self._w
        if self._closed:
            raise StopIteration
        with w.cond:
            if w.thread is None and not w.ended:
                w.thread = threading.Thread(target=w.run, name="BatchLoader-prefetch",
                                            daemon=True)
                w.thread.start()
            while not w.buffer:
                w.cond.wait()
            kind, value = w.buffer.popleft()
            w.cond.notify_all()
        if kind == "batch":
            return value
        self.close()
        if kind == "error":
            raise value
        raise StopIteration

    def pause(self) -> None:
        self._w.halt()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._w.halt()
        self._w.buffer.clear()
        close = getattr(self._w.source, "close", None)
        if close is not None:
            close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


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
    0x9E3779B1 + k) % 2**32)``. ``prefetch``: batches made ahead in a
    thread (None: in the calling thread; below 1 raises, where JAX's queue
    of size 0 would be unbounded). ``fast_crop`` and ``num_threads``: see
    the module docstring (a ``sampler`` loader only)."""

    def __init__(self, dataset, *, sampler: t.Optional[t.Iterable[int]] = None,
                 batch_size: t.Optional[int] = None,
                 batch_sampler: t.Optional[t.Iterable[t.List[int]]] = None,
                 pad_to: t.Optional[int] = None, seed: int = 0,
                 infinite: t.Optional[bool] = None,
                 prefetch: t.Optional[int] = DEFAULT_PREFETCH,
                 fast_crop: t.Optional[t.Tuple[int, int, str]] = None, num_threads: int = 4):
        if (sampler is None) == (batch_sampler is None):
            raise ValueError("provide exactly one of sampler / batch_sampler")
        if prefetch is not None and prefetch < 1:
            raise ValueError(f"prefetch={prefetch}: give at least 1 batch ahead, or None "
                             f"for batches made in the calling thread")
        self._dataset = dataset
        self._sampler, self._batch_sampler = sampler, batch_sampler
        self._batch_size, self._pad_to, self._seed = batch_size, pad_to, seed
        self._infinite = (infinite if infinite is not None
                          else sampler is not None and batch_size is not None)
        self.prefetch = prefetch
        self.scan_to_id = {s: i for i, s in enumerate(dataset.get_scan_list())}
        self._counter = itertools.count()
        self._fast_crop, self._num_threads = fast_crop, int(num_threads)
        if fast_crop is not None:
            if sampler is None:
                raise ValueError("fast_crop takes a sampler loader")
            out_h, out_w, mode = fast_crop
            if mode not in ("random", "center"):
                raise ValueError(f"fast_crop mode {mode!r}: 'random' or 'center'")
            from .. import native
            native.load()   # builds the library now, or raises with the compiler's output
            self._fast_rng = np.random.default_rng(seed ^ FAST_CROP_SEED_XOR)
            self._fast_meta = []
            for stem in dataset.get_stem_list():
                scan = dataset.get_scan_name(stem)
                self._fast_meta.append((stem, scan, dataset.get_partition(stem),
                                        *dataset.get_patient_cycle(scan)))

    @property
    def dataset(self):
        return self._dataset

    @property
    def item_shape(self) -> tuple:
        """Shape of one image item, drawn with a throwaway rng (the loader's
        own stream is untouched)."""
        if self._fast_crop is not None:
            return (self._fast_crop[0], self._fast_crop[1], 1)
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

    def _fast_batch(self, idxs: t.List[int]) -> dict:
        """``idxs``' slices cropped at ``fast_crop``'s offsets, scaled to [0, 1]
        and stacked by the native library (JAX ``_fast_batch``)."""
        from .. import native
        out_h, out_w, mode = self._fast_crop
        img_sub, gt_sub = self._dataset._sub_folders[:2]
        images = [self._dataset._preload[img_sub][i] for i in idxs]
        labels = [self._dataset._preload[gt_sub][i] for i in idxs]
        in_h, in_w = images[0].shape
        n = len(idxs)
        if mode == "random":
            ys = self._fast_rng.integers(0, max(in_h - out_h, 0) + 1, n)
            xs = self._fast_rng.integers(0, max(in_w - out_w, 0) + 1, n)
        else:
            ys = np.full(n, max((in_h - out_h) // 2, 0))
            xs = np.full(n, max((in_w - out_w) // 2, 0))
        out_img, out_lab = native.fast_collate_crop(images, labels, ys, xs, out_h, out_w,
                                                    num_threads=self._num_threads)
        meta = [self._fast_meta[i] for i in idxs]
        return {"image": out_img[..., None], "target": out_lab,
                "partition": np.asarray([m[2] for m in meta], np.int32),
                "patient": np.asarray([m[3] for m in meta], np.int32),
                "cycle": np.asarray([m[4] for m in meta], np.int32),
                "scan_id": np.asarray([self.scan_to_id.get(m[1], -1) for m in meta], np.int32),
                "mask": np.ones(n, bool), "scan": [m[1] for m in meta],
                "filename": [m[0] for m in meta]}

    def __iter__(self) -> t.Iterator[dict]:
        if self.prefetch is None:
            return self._batches()
        return PrefetchIterator(self._batches(), self.prefetch)

    def _batches(self) -> t.Iterator[dict]:
        if self._sampler is not None:
            it = iter(self._sampler)
            while True:
                idxs = list(itertools.islice(it, self._batch_size))
                if not idxs or (len(idxs) < self._batch_size and self._infinite):
                    return
                if self._fast_crop is not None:
                    yield self._fast_batch(idxs)
                    continue
                yield collate([self._item(i) for i in idxs], self._batch_size,
                              self.scan_to_id)
        else:
            pad_to = self.batch_size
            for idxs in self._batch_sampler:
                if idxs:
                    yield collate([self._item(i) for i in idxs[:pad_to]], pad_to,
                                  self.scan_to_id)
