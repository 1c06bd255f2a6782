"""The port's meters (contrastyou_tpu_torch/meters) held against the JAX
package's on the same inputs: UniversalDice (slice maps and step counts,
padded slots, device ids), the average meters, MeterInterface statistics,
SurfaceMeter and the Storage CSV, to 1e-12 (both sum float64 in the same
order, so most agree exactly); the CSV text byte for byte."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.meters import AverageValueDictionaryMeter as JDictMeter
from contrastyou_tpu.meters import AverageValueMeter as JMeter
from contrastyou_tpu.meters import MeterInterface as JInterface
from contrastyou_tpu.meters import Storage as JStorage
from contrastyou_tpu.meters import SurfaceMeter as JSurface
from contrastyou_tpu.meters import UniversalDice as JDice
from contrastyou_tpu_torch.meters.averages import AverageValueDictionaryMeter, AverageValueMeter
from contrastyou_tpu_torch.meters.dice import UniversalDice
from contrastyou_tpu_torch.meters.interface import MeterInterface
from contrastyou_tpu_torch.meters.storage import Storage
from contrastyou_tpu_torch.meters.surface import SurfaceMeter

TOL = 1e-12


def _same(a, b, what=""):
    if isinstance(b, dict):
        assert list(a) == list(b), (what, list(a), list(b))
        for k in b:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, float) and math.isnan(b):
        assert math.isnan(a), (what, a)
    else:
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (what, a, b)


def _maps(seed, b=6, c=4, s=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, (b, s, s)), rng.integers(0, c, (b, s, s))


def test_universal_dice_matches_jax():
    """Slice maps grouped by one name, by names per sample and by none; a
    mask that drops padded slots; counts with None slots; device ids with
    out-of-table ids skipped."""
    ours, ref = UniversalDice(4, report_axis=[1, 2, 3]), JDice(4, report_axis=[1, 2, 3])
    for m in (ours, ref):
        m.reset()
    names = ["p1", "p2", "p1", "p3", None, None]
    for seed in range(3):
        pred, target = _maps(seed)
        ours.add(torch.tensor(pred), torch.tensor(target), group_name="scanA")
        ref.add(pred, target, group_name="scanA")
        mask = np.array([1, 1, 1, 1, 0, 0], bool)
        ours.add(pred, target, group_name=["x", "y", "x", "z", "y", "y"], mask=mask)
        ref.add(pred, target, group_name=["x", "y", "x", "z", "y", "y"], mask=mask)
        inter = np.random.default_rng(seed).integers(0, 50, (6, 4))
        union = inter * 2 + np.random.default_rng(seed + 9).integers(0, 30, (6, 4))
        ours.add_counts(torch.tensor(inter), torch.tensor(union), group_name=names)
        ref.add_counts(jnp.asarray(inter), jnp.asarray(union), group_name=names)
        ids = np.array([0, 1, 1, 2, -1, 5])
        ours.add_counts(torch.tensor(inter), torch.tensor(union), group_ids=torch.tensor(ids),
                        id_table=["q0", "q1", "q2"])
        ref.add_counts(jnp.asarray(inter), jnp.asarray(union), group_ids=jnp.asarray(ids),
                       id_table=["q0", "q1", "q2"])
    assert ours.group_names == ref.group_names
    np.testing.assert_array_equal(ours.compute_dice_by_group(), ref.compute_dice_by_group())
    _same(ours.summary(), ref.summary(), "dice")
    ours.reset(), ref.reset()
    _same(ours.summary(), ref.summary(), "empty")
    one, jone = UniversalDice(3), JDice(3)
    pred, target = _maps(5, c=3)
    one.add(pred, target)
    jone.add(pred, target)
    _same(one.summary(), jone.summary(), "ungrouped")


def test_average_meters_and_interface_match_jax():
    rng = np.random.default_rng(0)
    ours, ref = MeterInterface(default_focus="tra"), JInterface(default_focus="tra")
    for m in (ours, ref):
        m.register_meter("loss", AverageValueMeter() if m is ours else JMeter())
        with m.focus_on("hook"):
            m.register_meter("metrics", AverageValueDictionaryMeter() if m is ours
                             else JDictMeter())
        with m.focus_on("_hidden"):
            m.register_meter("x", AverageValueMeter() if m is ours else JMeter())
    with ours, ref:
        for _ in range(7):
            v, n, a, b = rng.random(), int(rng.integers(1, 4)), rng.random(), rng.random()
            ours.add("loss", torch.tensor(v, dtype=torch.float64), n=n)
            ref.add("loss", v, n=n)
            with ours.focus_on("hook"), ref.focus_on("hook"):
                ours.add("metrics", loss=torch.tensor(a), mi=b)
                ref.add("metrics", loss=jnp.asarray(a, jnp.float32), mi=b)
    got, want = dict(ours.statistics()), dict(ref.statistics())
    assert list(got) == list(want) == ["tra", "hook"]
    _same(got, want, "statistics")
    assert math.isnan(AverageValueMeter().summary()) and math.isnan(JMeter().summary())
    with pytest.raises(KeyError):
        ours.register_meter("loss", AverageValueMeter())


def test_surface_meter_matches_jax():
    """Per-scan 3D average surface distances of random blobs, padded slots
    and a class that is absent from a scan (infinite distance, left out of
    the mean)."""
    ours = SurfaceMeter(4, report_axis=[1, 2, 3])
    ref = JSurface(4, report_axis=[1, 2, 3], metername="asd")
    yy, xx = np.mgrid[0:24, 0:24]
    rng = np.random.default_rng(2)
    for batch in range(3):
        pred = np.zeros((5, 24, 24), np.int64)
        target = np.zeros((5, 24, 24), np.int64)
        for s in range(5):
            for c, (arr, r) in enumerate(((pred, 7), (target, 6)), 1):
                cy, cx = rng.uniform(8, 16, 2)
                arr[s][np.hypot(yy - cy, xx - cx) < r] = c
                arr[s][np.hypot(yy - cy, xx - cx) < r / 2] = 2
        names = [f"scan{batch % 2}"] * 4 + [None]
        ours.add(torch.tensor(pred), target, group_name=names)
        ref.add(pred, target, group_name=names)
    _same(ours.summary(), ref.summary(), "asd")


def _fill(storage, epochs, rng):
    for epoch in epochs:
        stats = {"tra": {"tra": {"sup_loss": rng.random(), "lr": 1e-7 * (epoch + 1),
                                 "sup_dice": {"DSC1": rng.random(), "DSC_mean": 3e16}},
                         "consistency": {"metrics": {"loss": rng.random()}}},
                 "val": {"eval": {"loss": rng.random(),
                                  "dice": {"DSC1": float("nan") if epoch == 1 else 0.1,
                                           "DSC_mean": 0.30000000000000004}}}}
        if epoch == 2:
            stats["test"] = {"eval": {"loss": 1.5e-5, "dice": {"DSC_mean": -0.0}}}
        with storage:
            storage.add_from_meter_interface(epoch=epoch, **stats)


def test_storage_csv_matches_jax_pandas(tmp_path):
    """The same header, index and values as JAX's pandas ``to_csv``
    (floats as repr, NaN and missing cells empty, a stage that starts late);
    the history survives state_dict -> load_state_dict."""
    ours, ref = Storage(tmp_path / "p"), JStorage(tmp_path / "j")
    _fill(ours, range(3), np.random.default_rng(0))
    _fill(ref, range(3), np.random.default_rng(0))
    text = (tmp_path / "p" / "storage.csv").read_text()
    assert text == (tmp_path / "j" / "storage.csv").read_text()
    assert text.count("\n") == 4 and ",,," not in text.splitlines()[1]
    resumed, jresumed = Storage(tmp_path / "p2"), JStorage(tmp_path / "j2")
    resumed.load_state_dict(ours.state_dict())
    jresumed.load_state_dict(ref.state_dict())
    _fill(resumed, [3], np.random.default_rng(1))
    _fill(jresumed, [3], np.random.default_rng(1))
    assert ((tmp_path / "p2" / "storage.csv").read_text()
            == (tmp_path / "j2" / "storage.csv").read_text())
    empty, jempty = Storage(tmp_path / "e"), JStorage(tmp_path / "je")
    empty.to_csv(), jempty.to_csv()
    assert (tmp_path / "e" / "storage.csv").read_text() == (
        tmp_path / "je" / "storage.csv").read_text()
