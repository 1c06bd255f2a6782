"""The port's host loader (contrastyou_tpu_torch/data/loader.py): the
prefetch thread and the native crop, held against the synchronous loader
and the JAX package's ``BatchLoader`` on the CPU.

- Prefetched batches (the default, 4 ahead) equal the synchronous loader's
  and JAX's bitwise, in both modes (a ``sampler`` and a ``batch_sampler``),
  also across :meth:`PrefetchIterator.pause`.
- An exception raised while a batch is made reaches the consumer at that
  batch; ``prefetch < 1`` raises.
- No prefetch thread outlives an early ``break``, nor a 3-epoch run of the
  ``semi`` trainer (the trainers pause their iterators at each epoch's end
  and close them at the run's).
- ``fast_crop`` equals JAX's native output and a numpy crop and scale
  (one float32 multiply by 1/255, as the datasets scale) exactly, in both
  modes; the library is built into build/torch_native/
  from native/fast_collate.cpp, and a failed build raises with the
  compiler's output.
"""
import gc
import itertools
import threading

import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.data.loader import BatchLoader as JBatchLoader
from contrastyou_tpu.data.sampler import InfiniteRandomSampler as JInfinite
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch import native
from contrastyou_tpu_torch.data.base import normalize_u8
from contrastyou_tpu_torch.data.creator import get_data
from contrastyou_tpu_torch.data.loader import DEFAULT_PREFETCH, BatchLoader, PrefetchIterator
from contrastyou_tpu_torch.data.sampler import InfiniteRandomSampler, ScanBatchSampler
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from test_torch_pretrain_loop import _batches_equal

torch.set_num_threads(1)

DATA = {"name": "acdc", "labeled_scan_num": 2}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=4, num_val_scans=3, slices_per_scan=6, size=64)
    return root


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "BatchLoader-prefetch" and t.is_alive()]


def _same(a, b, n):
    got = list(itertools.islice(iter(a), n))
    want = list(itertools.islice(iter(b), n))
    for x, y in zip(got, want):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k
    return got


def test_prefetched_batches_equal_sync_and_jax(data_root):
    ours = get_data(DATA, {"batch_size": 3}, {"batch_size": 3}, root_dir=str(data_root))
    ref = jget_data(DATA, {"batch_size": 3}, {"batch_size": 3}, root_dir=str(data_root))
    labeled, val = ours[0], ours[2]
    assert labeled.prefetch == DEFAULT_PREFETCH == 4
    assert isinstance(iter(labeled), PrefetchIterator)
    # sampler mode (endless) and batch_sampler mode (one scan a batch)
    _batches_equal(labeled, ref[0], 7)
    _batches_equal(val, ref[2], len(val.dataset.get_scan_list()))
    ds = labeled.dataset
    sync = BatchLoader(ds, sampler=InfiniteRandomSampler(len(ds), seed=0), batch_size=3,
                       prefetch=None)
    pre = BatchLoader(ds, sampler=InfiniteRandomSampler(len(ds), seed=0), batch_size=3)
    _same(pre, sync, 9)
    vsync = BatchLoader(val.dataset, batch_sampler=ScanBatchSampler(val.dataset),
                        infinite=False, prefetch=None)
    assert len(_same(val, vsync, 10)) == len(list(vsync)) == len(val.dataset.get_scan_list())


def test_pause_keeps_the_stream(data_root):
    ds = get_data(DATA, {}, {}, root_dir=str(data_root))[0].dataset

    def loader(prefetch):
        return BatchLoader(ds, sampler=InfiniteRandomSampler(len(ds), seed=5), batch_size=2,
                           seed=5, prefetch=prefetch)

    want = list(itertools.islice(iter(loader(None)), 8))
    it = iter(loader(2))
    got = []
    for _ in range(4):
        got += [next(it), next(it)]
        it.pause()
        assert not _prefetch_threads()
    it.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["filename"] == b["filename"]
    assert not _prefetch_threads()


class _Failing:
    """A dataset stand-in whose item 3 raises."""

    def __init__(self):
        self.items = [{"image": np.full((4, 4, 1), i, np.float32),
                       "target": np.zeros((4, 4), np.int32), "partition": 0, "scan": "s",
                       "filename": f"f{i}"} for i in range(6)]

    def get_scan_list(self):
        return ["s"]

    def __getitem__(self, index):
        i, _ = index
        if i == 3:
            raise KeyError("item 3 is broken")
        return self.items[i]


def test_worker_error_reaches_the_consumer():
    loader = BatchLoader(_Failing(), sampler=range(6), batch_size=1, infinite=False)
    it = iter(loader)
    assert [float(next(it)["image"].max()) for _ in range(3)] == [0.0, 1.0, 2.0]
    with pytest.raises(KeyError, match="item 3 is broken"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(ValueError, match="prefetch=0"):
        BatchLoader(_Failing(), sampler=range(6), batch_size=1, prefetch=0)


def test_no_thread_after_early_break(data_root):
    loader = get_data(DATA, {}, {}, root_dir=str(data_root))[0]
    for i, _ in enumerate(loader):
        if i == 2:
            break
    gc.collect()
    assert not _prefetch_threads()
    it = iter(loader)
    next(it)
    del it
    gc.collect()
    assert not _prefetch_threads()


def test_no_thread_after_three_trainer_epochs(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    seen = []
    tra_epoch = port_main.trainer_zoo["semi"].tra_epoch

    def spy(self, epoch):
        out = tra_epoch(self, epoch)
        seen.append((len(_prefetch_threads()), isinstance(self._labeled_iter, PrefetchIterator)))
        return out

    monkeypatch.setattr(port_main.trainer_zoo["semi"], "tra_epoch", spy)
    port_main.main(["-o", "Trainer.name=semi", "Trainer.device=cpu", "Trainer.max_epoch=3",
                    "Trainer.num_batches=2", "Arch.max_channel=32", "Trainer.save_dir=run"])
    assert seen == [(0, True)] * 3
    assert not _prefetch_threads()


def _preloaded(data_root):
    ours = get_data(DATA, {}, {}, root_dir=str(data_root))[0].dataset
    ref = jget_data(DATA, {}, {}, root_dir=str(data_root))[0].dataset
    ref.preload()
    return ours, ref


@pytest.mark.parametrize("mode", ["random", "center"])
def test_fast_crop_matches_jax_and_numpy(data_root, mode):
    ours, ref = _preloaded(data_root)
    crop = (48, 40, mode)
    a = BatchLoader(ours, sampler=InfiniteRandomSampler(len(ours), seed=3), batch_size=5,
                    seed=3, fast_crop=crop, num_threads=3)
    b = JBatchLoader(ref, sampler=JInfinite(len(ref), seed=3), batch_size=5, seed=3,
                     fast_crop=crop, num_threads=3)
    assert a.item_shape == (48, 40, 1)
    got = _batches_equal(a, b, 4)
    # the same crops in numpy, at the offsets of the loader's stream
    rng = np.random.default_rng(3 ^ 0x5F5E1)
    idx = list(itertools.islice(iter(InfiniteRandomSampler(len(ours), seed=3)), 20))
    for i, batch in enumerate(got):
        rows = idx[5 * i:5 * i + 5]
        imgs = [ours._preload["img"][r] for r in rows]
        gts = [ours._preload["gt"][r] for r in rows]
        H, W = imgs[0].shape
        if mode == "random":
            ys, xs = rng.integers(0, H - 48 + 1, 5), rng.integers(0, W - 40 + 1, 5)
        else:
            ys, xs = np.full(5, (H - 48) // 2), np.full(5, (W - 40) // 2)
        for j, (im, gt, y, x) in enumerate(zip(imgs, gts, ys, xs)):
            np.testing.assert_array_equal(batch["image"][j, ..., 0],
                                          normalize_u8(im[y:y + 48, x:x + 40]))
            np.testing.assert_array_equal(batch["target"][j], gt[y:y + 48, x:x + 40])
    assert native.load.cache_info().currsize == 1
    assert list(native.BUILD_DIR.glob("libfastcollate-*.so"))
    assert not (native.SOURCE.parent / "build").exists()


def test_fast_crop_build_failure_raises(tmp_path, monkeypatch, data_root):
    bad = tmp_path / "fast_collate.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building fast_collate.cpp failed") as e:
            native.load()
        assert "error" in str(e.value)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.load()
    finally:
        native.load.cache_clear()
    with pytest.raises(ValueError, match="mode"):
        BatchLoader(_preloaded(data_root)[0], sampler=range(4), batch_size=2,
                    fast_crop=(8, 8, "middle"))


def test_prefetch_stress_keeps_every_stream_in_order():
    """12 prefetch threads (more than this machine's cores) at depths 1-4,
    consumed in a random interleaving with random pauses and a 1 us switch
    interval: every stream arrives whole and in order, and no thread is
    left; bounded at 60 s."""
    import random
    import sys
    import time

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        its = [PrefetchIterator(iter(range(1500)), depth) for depth in (1, 2, 3, 4) * 3]
        got = [[] for _ in its]
        done = [False] * len(its)
        rng = random.Random(0)
        deadline = time.monotonic() + 60
        while not all(done) and time.monotonic() < deadline:
            i = rng.randrange(len(its))
            if done[i]:
                continue
            try:
                got[i].append(next(its[i]))
            except StopIteration:
                done[i] = True
            if rng.random() < 0.02:
                its[i].pause()
    finally:
        sys.setswitchinterval(old)
    assert all(done), "timed out"
    assert all(g == list(range(1500)) for g in got)
    assert not _prefetch_threads()
