"""The port's TensorBoard writer, figure and prediction savers and the
profiled, event-writing loop, against the JAX package's tensorboardX writer
and PIL savers and against TensorBoard's own reader."""
from __future__ import annotations

import io
import json
import math
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from contrastyou_tpu.hooks import savers as jsavers
from contrastyou_tpu.trainers.savers import InferenceSaver as JInferenceSaver
from contrastyou_tpu.utils import colors as jcolors
from contrastyou_tpu.writer import SummaryWriter as JSummaryWriter
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.png import read_png
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.hooks import savers
from contrastyou_tpu_torch.trainers.savers import InferenceSaver
from contrastyou_tpu_torch.utils import colors
from contrastyou_tpu_torch.writer import (SummaryWriter, crc32c, get_tb_writer, masked_crc32c,
                                          read_events, storage_tag)
from test_torch_ccblock import TINY, _hook_inputs, _hook_pair, _run_hook_pair
from torch_parity import close

#: meter statistics as the trainers hand them to the writer: scalars, dicts,
#: a hidden group, values that are not numbers
STATS = {"tra": {"tra": {"sup_loss": 0.5, "reg_loss": np.float32(-1.25),
                         "sup_dice": {"DSC1": 0.125, "DSC_mean": 1 / 3},
                         "lr": 1e-7, "flag": True},
                 "_hidden": {"metrics": {"x": 1.0}},
                 "cc_Up_conv2": {"metrics": {"rr": -2.5, "name": "abc", "none": None,
                                             "big": 1e30}}},
         "val": {"eval": {"loss": 1.386, "dice": {"DSC1": 0.0, "DSC_mean": math.pi}}}}


def _scalars(events):
    return sorted((e["tag"], e["step"], e["value"]) for e in events
                  if isinstance(e["value"], float))


def _tbx_file(log_dir: Path) -> Path:
    (path,) = (log_dir / "tensorboard").glob("events.out.tfevents.*")
    return path


def _write_both(tmp_path):
    port = SummaryWriter(tmp_path / "port")
    jax_writer = JSummaryWriter(str(tmp_path / "jax"))
    for epoch in (0, 3):
        for w in (port, jax_writer):
            w.add_scalars_from_meter_interface(epoch=epoch, **STATS)
    port.close()
    jax_writer.close()
    return port.path, _tbx_file(tmp_path / "jax")


def test_crc32c_and_mask():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    c = crc32c(b"abc")
    assert masked_crc32c(b"abc") == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_tensorboard_reads_the_ports_events_as_tensorboardx_writes_jax_ones(tmp_path):
    """TensorBoard's ``EventFileLoader`` reads the port's file: the same
    file version, and the same tags, steps and float32 values as the JAX
    writer (tensorboardX) gives for the same meter statistics."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util
    port_path, jax_path = _write_both(tmp_path)

    def value(v):
        # the loader migrates a simple_value to a scalar tensor
        if v.HasField("tensor"):
            return float(tensor_util.make_ndarray(v.tensor))
        return v.simple_value

    def load(path):
        events = list(EventFileLoader(str(path)).Load())
        values = sorted((v.tag, e.step, value(v)) for e in events for v in e.summary.value)
        return events[0].file_version, values

    (port_version, port_values), (jax_version, jax_values) = load(port_path), load(jax_path)
    assert port_version == jax_version == "brain.Event:2"
    assert port_values == jax_values
    assert len(port_values) == 2 * 11
    assert port_path.name.startswith("events.out.tfevents.")


def test_read_events_reads_tensorboardx_files(tmp_path):
    port_path, jax_path = _write_both(tmp_path)
    assert _scalars(read_events(jax_path)) == _scalars(read_events(port_path))
    tags = {t for t, _, _ in _scalars(read_events(port_path))}
    assert "tra/tra/sup_dice/DSC_mean" in tags and "tra/tra/sup_loss" in tags
    assert not any(t.startswith("tra/_hidden") or t.endswith(("/name", "/none")) for t in tags)


def test_read_events_checks_the_framing(tmp_path):
    w = SummaryWriter(tmp_path)
    w.add_scalar("a", 1.0, 2)
    w.close()
    data = bytearray(w.path.read_bytes())
    data[-6] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        read_events(bad)


@pytest.mark.parametrize("shape", [(5, 7), (4, 4, 3)])
def test_image_summary_decodes_to_the_normalized_matrix(tmp_path, shape):
    """``joint_2D_figure`` logs the matrix min-max normalized to uint8 (the
    first 2-D slice's pixels, grayscale); an RGB image keeps its channels."""
    rng = np.random.default_rng(0)
    w = SummaryWriter(tmp_path)
    if len(shape) == 2:
        joint = rng.random(shape).astype(np.float32) * 3 - 1
        savers.joint_2D_figure(joint, tb_writer=w, cur_epoch=4, tag="hook/joint")
        want = ((joint - joint.min()) / (joint.max() - joint.min() + 1e-8) * 255).astype(np.uint8)
        colorspace = 1
    else:
        want = rng.integers(0, 256, shape, dtype=np.uint8)
        w.add_image("rgb", want.transpose(2, 0, 1), 4)
        colorspace = 3
    w.close()
    (event,) = read_events(w.path)
    img = event["value"]
    assert event["step"] == 4 and (img["height"], img["width"]) == shape[:2]
    assert img["colorspace"] == colorspace
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(img["png"]))), want)


def test_writer_stack_and_disabled_writer(tmp_path):
    with pytest.raises(RuntimeError):
        get_tb_writer()
    outer, inner = SummaryWriter(tmp_path / "a"), SummaryWriter(tmp_path / "b")
    with outer:
        with inner:
            assert get_tb_writer() is inner
        assert get_tb_writer() is outer
    quiet = SummaryWriter(tmp_path / "c", write=False)
    quiet.add_scalar("x", 1.0, 0)
    quiet.close()
    assert quiet.path is None and not (tmp_path / "c").exists()
    again = SummaryWriter(tmp_path / "a")
    assert again.path != outer.path and len(list((tmp_path / "a/tensorboard").iterdir())) == 2


def _png(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _same_tree(a: Path, b: Path, suffix: str) -> int:
    names = sorted(p.relative_to(a) for p in a.rglob(f"*{suffix}"))
    assert names == sorted(p.relative_to(b) for p in b.rglob(f"*{suffix}")) and names
    for n in names:
        if suffix == ".png":
            np.testing.assert_array_equal(_png(a / n), _png(b / n))
        else:
            x, y = np.load(a / n), np.load(b / n)
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])
    return len(names)


def test_feature_map_saver_and_zip_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    kw = dict(image=rng.random((2, 12, 10, 1), np.float32),
              feature_map1=rng.random((2, 12, 10, 4), np.float32) - 0.5,
              feature_map2=rng.random((2, 12, 10), np.float32), cur_epoch=3, cur_batch_num=1,
              save_name="feat")
    port, jax_saver = savers.FeatureMapSaver(tmp_path / "p"), jsavers.FeatureMapSaver(
        str(tmp_path / "j"))
    port.save_map(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                     for k, v in kw.items()})
    jax_saver.save_map(**kw)
    assert _same_tree(tmp_path / "p/vis", tmp_path / "j/vis", ".png") == 3
    pz, jz = port.zip(), jax_saver.zip()
    assert Path(pz).name == Path(jz).name == "vis.zip"
    with zipfile.ZipFile(pz) as a, zipfile.ZipFile(jz) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for n in a.namelist():
            assert a.read(n) == b.read(n) or n.endswith(".png")


def test_distribution_tracker_and_matrix_saver_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    d1, d2 = rng.random((3, 5, 5, 6), np.float32), rng.random((3, 5, 5, 6), np.float32)
    for root, mod in ((tmp_path / "p", savers), (tmp_path / "j", jsavers)):
        tracker = mod.DistributionTracker(str(root))
        tracker.save_map(dist1=d1, dist2=d2, cur_epoch=7)
        mod.MatrixSaver(str(root)).save_matrix(matrix=d1[0], cur_epoch=7, cur_batch_num=2,
                                               save_name="joint")
    assert _same_tree(tmp_path / "p", tmp_path / "j", ".npz") == 2
    assert savers.DistributionTracker(str(tmp_path / "p")).zip().endswith("dist.zip")


def test_inference_saver_and_colours_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    image = rng.random((3, 9, 11, 1), np.float32) * 1.2 - 0.1
    target = rng.integers(0, 4, (3, 9, 11))
    pred = rng.integers(0, 25, (3, 9, 11))
    mask = np.array([True, False, True])
    names = ["patient001_00_0", "patient001_00_1", "patient002_01_3"]
    InferenceSaver(tmp_path / "p").save_batch(image=torch.from_numpy(image),
                                              target=torch.from_numpy(target),
                                              pred=torch.from_numpy(pred), filenames=names,
                                              mask=mask)
    JInferenceSaver(str(tmp_path / "j")).save_batch(image=image, target=target, pred=pred,
                                                    filenames=names, mask=mask)
    assert _same_tree(tmp_path / "p/predictions", tmp_path / "j/predictions", ".png") == 8
    pred_png = tmp_path / "p/predictions/pred/patient002_01_3.png"
    assert _png(pred_png).shape == (9, 11, 3)
    np.testing.assert_array_equal(read_png(pred_png, rgb=True), _png(pred_png))
    np.testing.assert_array_equal(colors.label2colored_image(pred),
                                  jcolors.label2colored_image(pred))
    np.testing.assert_array_equal(colors.overlay_segmentation(image[0, ..., 0], pred[0]),
                                  jcolors.overlay_segmentation(image[0, ..., 0], pred[0]))


def test_cc_block_joint_figure_matches_jax():
    """``save: true`` with the ``rr`` tiny hook emits ``fig/joint_rr``, the
    first subhead's redundancy joint, as JAX's block does."""
    jhook, params, jstate, hook, state = _hook_pair("Up_conv2", {"rr": TINY["rr"]})
    jhook._save = hook._save = True
    (_, _, jm, _, _), (_, _, tm, _, _) = _run_hook_pair(
        jhook, params, jstate, hook, state, _hook_inputs(), "Up_conv2")
    assert set(tm) == set(jm) == {"rr", "fig/joint_rr"}
    assert tm["fig/joint_rr"].shape == (10, 10)
    close(tm["fig/joint_rr"], jm["fig/joint_rr"], rtol=1e-4, atol=1e-6, what="joint_rr")


def test_infonce_emit_figures_gives_the_eager_auxiliaries():
    """``emit_figures`` hands out the SupCon similarity logits and positive
    mask of the step beside the loss, equal to JAX's ``INFONCEHook(
    emit_figures=True)`` on the same projected pairs; the figures carry no
    gradient and the loss's route is the one without figures."""
    import jax.numpy as jnp
    from contrastyou_tpu.hooks.infonce import INFONCEHook as JINFONCEHook
    from contrastyou_tpu_torch.hooks.infonce import INFONCEHook
    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, 6, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = np.array([0, 0, 1, 1, 2, 2], np.int32)
    jhook = JINFONCEHook(name="infonce", feature_name="Conv5", emit_figures=True)
    jhook._pairs_and_labels = lambda ctx, params: (jnp.asarray(f[0]), jnp.asarray(f[1]),
                                                   jnp.asarray(labels))
    jloss, _, jm = jhook.loss(None, None, None)
    hook = INFONCEHook(name="infonce", feature_name="Conv5", in_dim=8, emit_figures=True)
    t1, t2 = (torch.tensor(x, requires_grad=True) for x in f)
    hook._pairs_and_labels = lambda ctx: (t1, t2, torch.tensor(labels, dtype=torch.long))
    loss, _, metrics = hook.loss(None, {})
    plain = INFONCEHook(name="infonce", feature_name="Conv5", in_dim=8)
    plain._pairs_and_labels = hook._pairs_and_labels
    close(loss, plain.loss(None, {})[0], rtol=0, atol=0, what="loss with and without figures")
    close(loss, jloss, rtol=1e-5, atol=1e-6, what="loss")
    assert set(metrics) == set(jm) == {"fig/sim_logits", "fig/pos_mask"}
    for key in metrics:
        assert not metrics[key].requires_grad
        assert metrics[key].shape == jm[key].shape == (12, 12)
        close(metrics[key], jm[key], rtol=1e-5, atol=1e-5, what=key)


def _storage(path: Path):
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0][1:], {int(r[0]): dict(zip(rows[0][1:], r[1:])) for r in rows[1:]}


ARGV = ["-p", "config/base.yaml", "config/hooks/ccblocks2.yaml", "-o", "Trainer.name=semi",
        "Trainer.device=cpu", "Arch.max_channel=32", "Trainer.num_batches=2",
        "CrossCorrelationParameters.save=true", "+Trainer.profile=true", "Trainer.save_dir=cc"]


def test_cpu_run_writes_events_figures_and_a_trace(tmp_path, monkeypatch):
    """Two epochs of ``semi`` with the cross-correlation block's figure and
    the profiler: every numeric ``storage.csv`` cell is in the events under
    JAX's tag at step = epoch (float32), one ``joint_rr`` image an epoch,
    epoch 1's Chrome trace and its launch counts, the run's timing records
    in ``launches.json``; a resume to a third epoch
    adds an events file holding epoch 2 alone."""
    import contrastyou_tpu_torch as package
    repo = Path(__file__).resolve().parents[1]
    monkeypatch.chdir(repo)
    synthesize_acdc_like(tmp_path / "data", num_train_scans=4, num_val_scans=3,
                         slices_per_scan=6, size=64)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    run = tmp_path / "runs/cc"
    assert port_main.main(ARGV + ["Trainer.max_epoch=2"]) == 0
    (first,) = (run / "tensorboard").glob("events.out.tfevents.*")
    columns, rows = _storage(run / "storage.csv")
    events = read_events(first)
    scalars = {(e["tag"], e["step"]): e["value"] for e in events if isinstance(e["value"], float)}
    checked = 0
    for epoch, row in rows.items():
        for c in columns:
            if row[c] == "":
                continue
            got = scalars[(storage_tag(c), epoch)]
            assert got == np.float32(float(row[c])), (c, epoch, got, row[c])
            checked += 1
    assert checked >= 2 * 20 and len(scalars) == checked
    images = [e for e in events if isinstance(e["value"], dict)]
    assert [(e["tag"], e["step"]) for e in images] == [("cc_Up_conv2/joint_rr", 0),
                                                       ("cc_Up_conv2/joint_rr", 1)]
    assert not any("fig" in c for c in columns)
    trace = json.loads((run / "profile/epoch_001.pt.trace.json").read_text())
    assert trace["traceEvents"]
    launches = json.loads((run / "profile/launches.json").read_text())
    assert launches["epoch"] == 1 and launches["device_events"] == 0
    assert set(launches["launches"]) >= {"conv3x3_stats", "supcon_loss", "iic_joints"}
    record = json.loads((run / "launches.json").read_text())
    assert record["launches"]["conv3x3_stats"] == 0
    assert record["trainer"] == "semi" and record["seconds"] > 0
    train = [t for t in record["timing"] if t["phase"] == "train"]
    assert [(t["epoch"], t["steps"], t["profiled"]) for t in train] == [(0, 2, False),
                                                                        (1, 2, True)]
    assert [t["epoch"] for t in record["timing"] if t["phase"] == "events"] == [0, 1]
    assert [t["epoch"] for t in record["timing"] if t["phase"] == "profile"] == [1]

    assert port_main.main([a for a in ARGV if "profile" not in a] + ["Trainer.max_epoch=3"]) == 0
    files = sorted((run / "tensorboard").glob("events.out.tfevents.*"))
    assert len(files) == 2 and first in files
    (second,) = [f for f in files if f != first]
    assert {e["step"] for e in read_events(second)} == {2}
    assert read_events(first) == events


def test_profile_without_device_events_on_the_card_raises(tmp_path):
    """On the card a trace that recorded no device kernel (no CUPTI) is not
    kept: the profiled epoch raises and ``profile/`` holds no trace. (Run
    here on the CPU with the device reported as a card.)"""
    import types
    from contrastyou_tpu_torch.engine.trainer import Trainer
    fake = types.SimpleNamespace(_profile=True, is_master=True, _profiling=False,
                                 device=types.SimpleNamespace(type="cuda"), _sync=lambda: None,
                                 _save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with Trainer._epoch_profile(fake, 1):
            torch.ones(4).sum()
    assert not list((tmp_path / "profile").glob("*.json")) and not fake._profiling
    with Trainer._epoch_profile(fake, 0):          # another epoch: not profiled
        pass
