"""The port's data path (contrastyou_tpu_torch/data, augment/host.py) held
against the JAX package's on the same files: the PNG codec both ways against
PIL, the synthetic writer's pixels, dataset items, scan lists, partitions,
splits, loader batches (labeled, unlabeled, val, test) and the device cache,
all compared exactly (integers and the same f32 multiply)."""
import itertools
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from contrastyou_tpu.augment import transform_zoo as jtransform_zoo
from contrastyou_tpu.data import ACDCDataset as JACDC
from contrastyou_tpu.data import ScanBatchSampler as JScanBatchSampler
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.data import split_dataset as jsplit
from contrastyou_tpu.data import synthesize_acdc_like as jsynthesize
from contrastyou_tpu.data.datasets import data_zoo as jdata_zoo
from contrastyou_tpu.data.device_cache import DeviceDataCache as JCache
from contrastyou_tpu.data.sampler import InfiniteRandomSampler as JInfinite
from contrastyou_tpu.data import synthetic as jsynthetic
from contrastyou_tpu.data.synthetic import synthesize_dataset
from contrastyou_tpu_torch.augment.host import transform_zoo
from contrastyou_tpu_torch.data.creator import get_data, split_dataset
from contrastyou_tpu_torch.data.datasets import ACDCDataset, data_zoo
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.data.png import _SIGNATURE, _chunk, read_png, write_png
from contrastyou_tpu_torch.data.sampler import InfiniteRandomSampler, ScanBatchSampler
from contrastyou_tpu_torch.data import synthetic as port_synthetic
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like

SIZE = 64
LOADERS = dict(shuffle=True, batch_size=3, num_workers=5)


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """An ACDC layout written by the JAX package's writer (PIL), plus one
    longer validation scan from the port's writer, so the eval batches are
    ragged."""
    root = tmp_path_factory.mktemp("jax_acdc")
    jsynthesize(root, num_train_scans=5, num_val_scans=4, slices_per_scan=6, size=SIZE)
    synthesize_acdc_like(root, num_train_scans=0, num_val_scans=1, slices_per_scan=8,
                         size=SIZE, first_scan=10, seed=1)
    return root


# --- PNG ------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img: np.ndarray, kinds) -> bytes:
    """A PNG of ``img`` with row ``y`` filtered by ``kinds[y]``, written out
    by the PNG specification's formulas."""
    h, w = img.shape
    x, out = img.astype(int), bytearray()
    for y in range(h):
        out.append(kinds[y])
        for i in range(w):
            a = x[y, i - 1] if i else 0
            b = x[y - 1, i] if y else 0
            c = x[y - 1, i - 1] if y and i else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kinds[y]]
            out.append((x[y, i] - pred) & 255)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b""))


def test_png_reads_what_pil_wrote(jax_root):
    files = sorted((jax_root / "ACDC_contrast" / "train").glob("*/*.png"))
    assert len(files) == 60
    for f in files:
        np.testing.assert_array_equal(read_png(f), np.asarray(Image.open(f).convert("L")))


@pytest.mark.parametrize("kinds", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reads_every_row_filter(tmp_path, kinds):
    img = np.random.default_rng(3).integers(0, 256, (37, 29)).astype(np.uint8)
    names = ["none", "sub", "up", "average", "paeth"]
    rows = [y % 5 for y in range(37)] if kinds == "mixed" else [names.index(kinds)] * 37
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, rows))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_written_reads_back_in_pil(tmp_path):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:50, 0:70]
    for img in (rng.integers(0, 256, (50, 70)).astype(np.uint8),
                ((np.hypot(yy - 25, xx - 30) < 15) * 3).astype(np.uint8),
                np.full((1, 1), 7, np.uint8)):
        write_png(tmp_path / "w.png", img)
        with Image.open(tmp_path / "w.png") as im:
            assert im.mode == "L"
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)


@pytest.mark.parametrize("mode,words", [("RGB", "colour type 2"), ("P", "colour type 3"),
                                        ("LA", "colour type 4"), ("I;16", "bit depth 16"),
                                        ("1", "bit depth 1")])
def test_png_refuses_other_formats_by_name(tmp_path, mode, words):
    path = tmp_path / f"slice_{mode.replace(';', '')}.png"
    Image.new(mode, (8, 8)).save(path)
    with pytest.raises(ValueError, match=words) as e:
        read_png(path)
    assert str(path) in str(e.value)


def test_png_refuses_interlaced(tmp_path):
    raw = bytearray(_encode(np.zeros((4, 4), np.uint8), [0] * 4))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    raw[8:33] = _chunk(b"IHDR", ihdr)
    (tmp_path / "i.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(tmp_path / "i.png")


def test_png_decode_time_of_a_256_slice(tmp_path):
    """The worst case, every row Paeth (a loop over the row): under 0.2 s
    for a 256 x 256 slice (~20 ms on one core of the build host); the
    dataset decodes each slice once."""
    img = np.random.default_rng(1).integers(0, 256, (256, 256)).astype(np.uint8)
    (tmp_path / "p.png").write_bytes(_encode(img, [4] * 256))
    write_png(tmp_path / "w.png", img)
    for name in ("p.png", "w.png"):
        t0 = time.perf_counter()
        got = read_png(tmp_path / name)
        dt = time.perf_counter() - t0
        print(f"decode {name}: {dt * 1e3:.1f} ms")
        np.testing.assert_array_equal(got, img)
        assert dt < 0.2, dt


def test_synthetic_writer_gives_jax_pixels(tmp_path):
    jsynthesize(tmp_path / "j", num_train_scans=2, num_val_scans=1, slices_per_scan=4,
                size=48, seed=5)
    synthesize_acdc_like(tmp_path / "p", num_train_scans=2, num_val_scans=1,
                         slices_per_scan=4, size=48, seed=5)
    jfiles = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.png"))
    pfiles = sorted(p.relative_to(tmp_path / "p") for p in (tmp_path / "p").rglob("*.png"))
    assert jfiles == pfiles and len(jfiles) == 24
    for f in jfiles:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p" / f)),
                                      np.asarray(Image.open(tmp_path / "j" / f)))


def test_synthetic_writer_first_scan_numbers_a_longer_scan(tmp_path):
    synthesize_acdc_like(tmp_path, num_train_scans=1, num_val_scans=1, slices_per_scan=3,
                         size=32)
    synthesize_acdc_like(tmp_path, num_train_scans=0, num_val_scans=1, slices_per_scan=5,
                         size=32, first_scan=3, seed=1)
    ds = ACDCDataset(root_dir=str(tmp_path), mode="val", transforms=None)
    assert ds.get_scan_list() == ["patient002_00", "patient003_00"]
    assert [len(b) for b in ScanBatchSampler(ds)] == [3, 5]



@pytest.mark.parametrize("name", ["acdc", "acdc_lv", "prostate", "prostate_md", "mmwhsct",
                                  "mmwhsmr", "spleen", "hippocampus"])
def test_dataset_writer_gives_jax_files(tmp_path, name):
    """The port's ``synthesize_dataset`` against JAX's at the same seed, for
    every archive layout (``acdc_lv`` for the ACDC family's ordering name):
    the same layout table entry (names, native size and slice-count ranges,
    folders, classes), then the same files, PNG pixels equal, the
    ``*_info.npy`` dict and the ordering JSON equal."""
    key = "acdc" if name.startswith("acdc") else name
    ours, ref = port_synthetic._LAYOUTS[key], jsynthetic._LAYOUTS[key]
    assert set(ours) == set(ref)
    for field in ("sizes", "slices", "info", "modes", "subs", "classes"):
        assert ours[field] == ref[field], field
    for i, sl in itertools.product((1, 12, 123), (0, 7, 42)):
        assert ours["stem"](i, sl) == ref["stem"](i, sl)
        assert ours["scan_key"](i) == ref["scan_key"](i)
    kw = dict(num_train_scans=2, num_val_scans=2, seed=3, max_slices=4)
    jroot = synthesize_dataset(tmp_path / "j", name, **kw)
    proot = port_synthetic.synthesize_dataset(tmp_path / "p", name, **kw)
    assert proot.relative_to(tmp_path / "p") == jroot.relative_to(tmp_path / "j")
    jfiles = sorted(f.relative_to(jroot) for f in jroot.rglob("*") if f.is_file())
    pfiles = sorted(f.relative_to(proot) for f in proot.rglob("*") if f.is_file())
    assert pfiles == jfiles
    suffixes = [f.suffix for f in jfiles]
    assert suffixes.count(".npy") == 1 and suffixes.count(".json") == 1
    assert suffixes.count(".png") == len(jfiles) - 2 == 2 * 4 * 4
    for f in jfiles:
        if f.suffix == ".png":
            ours, ref = np.asarray(Image.open(proot / f)), np.asarray(Image.open(jroot / f))
            assert ours.dtype == ref.dtype and ours.shape == ref.shape, f
            np.testing.assert_array_equal(ours, ref, err_msg=str(f))
        elif f.suffix == ".npy":
            ours = np.load(proot / f, allow_pickle=True).item()
            assert ours == np.load(jroot / f, allow_pickle=True).item() and ours, f
        else:
            assert (proot / f).read_text() == (jroot / f).read_text(), f

# --- datasets, splits, loaders --------------------------------------------

def _items_equal(a: dict, b: dict, what=""):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (what, k, a[k].dtype, b[k].dtype)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


@pytest.mark.parametrize("name", ["acdc", "acdc_lv"])
def test_dataset_items_match_jax(jax_root, name):
    for mode, which in (("train", "train"), ("val", "val")):
        ours = data_zoo[name](root_dir=str(jax_root), mode=mode,
                              transforms=getattr(transform_zoo[name](), which))
        ref = jdata_zoo[name](root_dir=str(jax_root), mode=mode,
                              transforms=getattr(jtransform_zoo[name](), which))
        assert ours.get_scan_list() == ref.get_scan_list()
        assert ours.get_stem_list() == ref.get_stem_list()
        assert ours.get_partition_list() == ref.get_partition_list()
        for i in range(len(ref)):
            _items_equal(ours[(i, np.random.default_rng(i))], ref[(i, np.random.default_rng(i))],
                         f"{name} {mode} {i}")


@pytest.mark.parametrize("name", ["acdc", "hippocampus", "mmwhsct"])
def test_archive_layouts_match_jax(tmp_path, name):
    """The JAX package's realistic fakes (varying slice sizes and counts,
    ``*_info.npy``, mode prefixes): the same scans, partitions, items and
    ordering-JSON split."""
    synthesize_dataset(tmp_path, name, num_train_scans=3, num_val_scans=2, max_slices=7)
    spec, jspec = transform_zoo[name](), jtransform_zoo[name]()
    ours = data_zoo[name](root_dir=str(tmp_path), mode="train", transforms=spec.train)
    ref = jdata_zoo[name](root_dir=str(tmp_path), mode="train", transforms=jspec.train)
    assert ours._scan_info == ref._scan_info and ours._scan_info
    assert ours.get_scan_list() == ref.get_scan_list()
    assert ours.get_partition_list() == ref.get_partition_list()
    for i in range(len(ref)):
        _items_equal(ours[(i, np.random.default_rng(i))], ref[(i, np.random.default_rng(i))])
    loaders = get_data({"name": name, "labeled_scan_num": 2}, LOADERS, LOADERS,
                       root_dir=str(tmp_path))
    jloaders = jget_data({"name": name, "labeled_scan_num": 2}, LOADERS, LOADERS,
                         root_dir=str(tmp_path))
    for a, b in zip(loaders, jloaders):
        assert a.dataset.get_scan_list() == b.dataset.get_scan_list()
        assert a.batch_size == b.batch_size


@pytest.mark.parametrize("name", ["prostate", "prostate_md", "spleen"])
def test_resize_datasets_raise_by_name(tmp_path, name):
    """Named for the refusal it held until the resize transforms were
    ported; now each resize dataset builds from a JAX-written archive and
    its first train item (resized, spleen also cropped) equals JAX's."""
    synthesize_dataset(tmp_path, name, num_train_scans=2, num_val_scans=1, max_slices=3)
    spec, jspec = transform_zoo[name](), jtransform_zoo[name]()
    ours = data_zoo[name](root_dir=str(tmp_path), mode="train", transforms=spec.train)
    ref = jdata_zoo[name](root_dir=str(tmp_path), mode="train", transforms=jspec.train)
    item = ours[(0, np.random.default_rng(0))]
    _items_equal(item, ref[(0, np.random.default_rng(0))], name)
    assert item["image"].shape == spec.crop_size + (1,)


def _batches(loader, n=None):
    return list(itertools.islice(iter(loader), n))


@pytest.mark.parametrize("ordering", [False, True])
def test_get_data_matches_jax(jax_root, tmp_path, ordering):
    """The four loaders of a run: the same split (the ordering JSON when
    present, else the split seeded with 2), and the same batches, padded
    eval batches and masks included."""
    root = jax_root
    if ordering:
        import json
        import shutil
        root = tmp_path / "ordered"
        shutil.copytree(jax_root, root)
        scans = ACDCDataset(root_dir=str(root), mode="train").get_scan_list()
        (root / "ACDC_contrast" / "acdc_ordering_0.json").write_text(
            json.dumps(scans[::-1]))
    params = {"name": "acdc", "labeled_scan_num": 2}
    ours = get_data(params, LOADERS, LOADERS, root_dir=str(root))
    ref = jget_data(params, LOADERS, LOADERS, root_dir=str(root))
    if ordering:
        assert ours[0].dataset.get_scan_list() == ["patient004_00", "patient005_00"]
    for which, a, b in zip(("labeled", "unlabeled", "val", "test"), ours, ref):
        assert a.dataset.get_scan_list() == b.dataset.get_scan_list(), which
        assert a.scan_to_id == b.scan_to_id and a.batch_size == b.batch_size, which
        assert a.item_shape == b.item_shape == (224, 224, 1)
        n = 4 if which in ("labeled", "unlabeled") else None
        got, want = _batches(a, n), _batches(b, n)
        assert len(got) == len(want) > 0, which
        for i, (x, y) in enumerate(zip(got, want)):
            _items_equal(x, y, f"{which} batch {i}")


def test_split_and_samplers_match_jax(jax_root):
    ours = ACDCDataset(root_dir=str(jax_root), mode="val")
    ref = JACDC(root_dir=str(jax_root), mode="val")
    for seed in (1, 7):
        for a, b in zip(split_dataset(ours, 2, 1, seed=seed), jsplit(ref, 2, 1, seed=seed)):
            assert a.get_scan_list() == b.get_scan_list()
            assert a.get_stem_list() == b.get_stem_list()
    for shuffle in (False, True):
        assert (list(ScanBatchSampler(ours, shuffle=shuffle, seed=4))
                == list(JScanBatchSampler(ref, shuffle=shuffle, seed=4)))
        got = itertools.islice(iter(InfiniteRandomSampler(7, seed=3, shuffle=shuffle)), 30)
        want = itertools.islice(iter(JInfinite(7, shuffle=shuffle, seed=3, process_index=0,
                                               process_count=1)), 30)
        assert list(got) == list(want)


def test_device_cache_from_dataset_matches_jax(tmp_path):
    synthesize_dataset(tmp_path, "acdc", num_train_scans=3, num_val_scans=1, max_slices=5)
    ours = DeviceDataCache.from_dataset(
        ACDCDataset(root_dir=str(tmp_path), mode="train"), crop=224, device="cpu")
    ref = JCache.from_dataset(JACDC(root_dir=str(tmp_path), mode="train"), crop=224)
    images = np.asarray(ref._images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) * np.float32(1 / 255)
    np.testing.assert_array_equal(ours.images.numpy(), images)
    np.testing.assert_array_equal(ours.targets.numpy(), np.asarray(ref._targets))
    for k in ("partition", "patient", "cycle", "scan_id"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(), np.asarray(getattr(ref, f"_{k}")))
    assert ours.scan_names == ref.scan_names and ours.crop == ref._crop
