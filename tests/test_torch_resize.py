"""The resize datasets (prostate, prostate_md, spleen) of the port held
against PIL and the JAX package, all exactly (integers, and the same f32
quantization and multiply):

- ``resize_bilinear_u8`` against PIL's ``Image.resize(..., BILINEAR)`` of an
  ``L`` image and ``resize_nearest`` against ``NEAREST``, bit for bit, over
  hypothesis-drawn input sizes 16-600 (each axis) to (224, 224), (320, 320)
  and non-square targets, up and down; the coefficient rows exhaustively
  over every input width 16-600;
- ``Resize`` and ``transform_zoo[name]`` (train and val pipelines) against
  JAX's on the same images, labels and rng;
- ``get_data``'s four loaders and the contrastive loader against JAX's on a
  ``synthesize_dataset`` layout: the same scans and partitions, images
  bit-equal, labels equal.
"""
import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from contrastyou_tpu.augment import transform_zoo as jtransform_zoo
from contrastyou_tpu.augment.host import Resize as JResize
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.data.synthetic import synthesize_dataset as jsynthesize
from contrastyou_tpu.trainers.pretrain import get_contrastive_loader as jget_loader
from contrastyou_tpu_torch.augment.host import (Resize, bilinear_coefficients,
                                                resize_bilinear_u8, resize_nearest,
                                                transform_zoo)
from contrastyou_tpu_torch.data.creator import get_data
from contrastyou_tpu_torch.data.datasets import data_zoo
from contrastyou_tpu_torch.trainers.pretrain import get_contrastive_loader

RESIZE_DATASETS = ("prostate", "prostate_md", "spleen")
SIZES = st.integers(16, 600)
#: targets: the datasets' own (prostate 224, spleen 320) and non-square ones
TARGETS = st.one_of(st.just((224, 224)), st.just((320, 320)), st.tuples(SIZES, SIZES))


def _pil(img: np.ndarray, size, resample) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize((size[1], size[0]), resample))


@settings(max_examples=80, deadline=None)
@given(h=SIZES, w=SIZES, target=TARGETS, seed=st.integers(0, 2 ** 16),
       kind=st.sampled_from(["random", "smooth", "saturated"]))
def test_bilinear_is_pil_bit_for_bit(h, w, target, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "random":
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w]
        img = (127.5 + 127.5 * np.sin(yy / 7.0 + xx / 11.0)).astype(np.uint8)
    else:   # 0 / 255 blocks: the coefficient sums' rounding reaches clip8's bounds
        img = (rng.random((h // 4 + 1, w // 4 + 1)) > 0.5).repeat(4, 0).repeat(4, 1)[:h, :w]
        img = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(resize_bilinear_u8(img, target),
                                  _pil(img, target, Image.BILINEAR))


@settings(max_examples=80, deadline=None)
@given(h=SIZES, w=SIZES, target=TARGETS, seed=st.integers(0, 2 ** 16))
def test_nearest_is_pil_bit_for_bit(h, w, target, seed):
    label = np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)
    np.testing.assert_array_equal(resize_nearest(label, target),
                                  _pil(label, target, Image.NEAREST))


@pytest.mark.parametrize("out", [224, 256, 320, 97])
def test_every_input_width_resamples_as_pil(out):
    """Each coefficient row against PIL for every input width 16-600: a
    3-row image resized in width only (the horizontal pass alone)."""
    rng = np.random.default_rng(out)
    for n in range(16, 601):
        img = rng.integers(0, 256, (3, n), dtype=np.uint8)
        np.testing.assert_array_equal(resize_bilinear_u8(img, (3, out)),
                                      _pil(img, (3, out), Image.BILINEAR), err_msg=f"{n}->{out}")
    # PIL's fixed point: each row of weights sums to 2**22 within rounding
    sums = bilinear_coefficients(600, 224).sum(1)
    assert np.abs(sums - 2 ** 22).max() <= 4


@pytest.mark.parametrize("size", [224, 320, (200, 300)])
def test_resize_transform_matches_jax(size):
    """``Resize`` on f32 images (k/255 values and arbitrary values in and
    out of [0, 1], quantized by truncation) and int labels, against JAX's."""
    rng = np.random.default_rng(1)
    for h, w in ((384, 300), (256, 256), (512, 512), (37, 600)):
        images = (rng.integers(0, 256, (h, w)).astype(np.float32) * np.float32(1 / 255),
                  rng.uniform(-0.1, 1.1, (h, w)).astype(np.float32))
        label = rng.integers(0, 4, (h, w)).astype(np.int32)
        for image in images:
            got = Resize(size)(image, label, rng)
            want = JResize(size)(image, label, rng)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", RESIZE_DATASETS)
def test_transform_zoo_matches_jax(name):
    """The train pipeline (spleen: a random crop of 256 after the resize)
    and the val pipeline, on the same rng, against JAX's."""
    ours, ref = transform_zoo[name](), jtransform_zoo[name]()
    assert ours.crop_size == ref.crop_size
    rng = np.random.default_rng(2)
    for h, w in ((384, 384), (256, 300), (512, 512)):
        image = rng.integers(0, 256, (h, w)).astype(np.float32) * np.float32(1 / 255)
        label = rng.integers(0, 2, (h, w)).astype(np.int32)
        for which in ("train", "val"):
            seed = int(rng.integers(1 << 30))
            got = getattr(ours, which)(image, label, np.random.default_rng(seed))
            want = getattr(ref, which)(image, label, np.random.default_rng(seed))
            assert got[0].shape == ours.crop_size
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {which} {h}x{w}")


LOADERS = dict(shuffle=True, batch_size=3, num_workers=5)


def _batches_equal(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), (what, i, set(a) ^ set(b))
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, (what, i, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} batch {i} {k}")
            else:
                assert a[k] == b[k], (what, i, k)


@pytest.fixture(scope="module", params=RESIZE_DATASETS)
def layout(request, tmp_path_factory):
    """A JAX ``synthesize_dataset`` archive (native 256-384 px prostate
    slices, 512 px spleen slices) of 4 train and 3 validation scans."""
    root = tmp_path_factory.mktemp(request.param)
    jsynthesize(root, request.param, num_train_scans=4, num_val_scans=3, max_slices=6, seed=3)
    return request.param, root


def test_get_data_matches_jax(layout):
    """The four loaders: the ordering JSON's labeled split, the eval splits,
    and their first batches (train: four, eval: all), padding included."""
    name, root = layout
    params = {"name": name, "labeled_scan_num": 2}
    ours = get_data(params, LOADERS, LOADERS, root_dir=str(root))
    ref = jget_data(params, LOADERS, LOADERS, root_dir=str(root))
    shape = transform_zoo[name]().crop_size + (1,)
    for which, a, b in zip(("labeled", "unlabeled", "val", "test"), ours, ref):
        assert a.dataset.get_scan_list() == b.dataset.get_scan_list(), which
        assert a.dataset.get_partition_list() == b.dataset.get_partition_list(), which
        assert a.item_shape == b.item_shape == shape
        n = 4 if which in ("labeled", "unlabeled") else None
        _batches_equal(list(itertools.islice(iter(a), n)), list(itertools.islice(iter(b), n)),
                       f"{name} {which}")


def test_contrastive_loader_matches_jax(layout):
    """``get_data(pretrain=True)``'s labeled half under the contrastive
    loader (spleen: scans x partitions; prostate: the random branch)."""
    name, root = layout
    data = {"name": name, "labeled_scan_num": 1}
    ours = get_data(data, {}, {}, root_dir=str(root), pretrain=True)[0].dataset
    ref = jget_data(data, {}, {}, root_dir=str(root), pretrain=True)[0].dataset
    assert ours.get_scan_list() == ref.get_scan_list()
    kw = dict(data_name=name, seed=10, scan_sample_num=2)
    a, b = get_contrastive_loader(ours, **kw), jget_loader(ref, **kw)
    assert a.batch_size == b.batch_size
    _batches_equal(list(itertools.islice(iter(a), 3)), list(itertools.islice(iter(b), 3)),
                   f"{name} contrastive")


def test_dataset_reads_the_native_sizes(layout):
    """The archive's slices keep their native size on disk; every item
    comes out at the dataset's shape."""
    name, root = layout
    ds = data_zoo[name](root_dir=str(root), mode="train", transforms=transform_zoo[name]().train)
    native = {ds._raw(ds._sub_folders[0], i).shape for i in range(len(ds))}
    assert len(native) > 1 or name == "spleen"
    assert {ds[(i, None)]["image"].shape for i in range(len(ds))} == {
        transform_zoo[name]().crop_size + (1,)}
