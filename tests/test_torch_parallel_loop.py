"""The port's ``SemiTrainer`` on two gloo ranks of CPU processes
(``data_group``; tests/torch_dp.py ``loop_worker``): a device-cached epoch,
its evaluation and checkpoint, a fresh trainer resumed from rank 0's
``last`` for a second epoch, inference, and a host-fed epoch. The U-Net at
max_channel 32, f32, 32x32 slices, consistency and the encoder InfoNCE
hook, 2 slices a rank and step.

- Only rank 0 writes ``config.yaml``, ``storage.csv``, the checkpoints,
  ``.success`` and ``inference_result.json`` (each rank trains into a
  ``save_dir`` of its own, so the other rank's stays empty); the resume
  loads on every rank and both continue from epoch 1.
- Device-cached, every rank draws the global batch and keeps its rows, so
  rank 0's ``storage.csv`` is the one-process run's at the global batch (4
  slices, two epochs unbroken): the same header, the train and eval losses
  and dice to rel 1e-4 (their global sums in another order; measured 2.4e-6
  at most on the CPU), and so is its inference.
- Host-fed, each rank reads JAX's stride ``order[r::2]`` of the indices, so
  a step holds the one-process step's slices in another row order and its
  draws fall on other rows: the test holds the ranks' parameters bitwise
  equal and the scores finite, not equal to a one-process run.
- ``MTTrainer`` (the MT hook, evaluated on its teacher) and
  ``FineTuneTrainer`` (the labeled batch alone, with the EMA eval hook
  evaluated in the student's place) for two device-cached epochs on the
  same layout (tests/torch_dp.py ``slice_loop_worker``): only rank 0
  writes, the ranks end with bitwise equal parameters and hook states (the
  teacher, the EMA), and rank 0's ``storage.csv`` is the one-process run's
  at the global batch, to the tolerances above.
"""
import csv
import json
import math

import pytest
import torch

from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from torch_dp import loop_worker, one_process_run, slice_loop_worker, spawn

W = 2
WRITTEN = ("config.yaml", "storage.csv", "last", "best", ".success")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    synthesize_acdc_like(root / "data", num_train_scans=4, num_val_scans=4, slices_per_scan=4,
                         size=32)
    spec = {"root": str(root / "data"), "size": 32, "max_channel": 32, "num_batches": 2,
            "per_rank": 2, "world": W}
    return root, spec


@pytest.fixture(scope="module")
def runs(layout):
    root, spec = layout
    spawn(loop_worker, W, spec, str(root))
    single = one_process_run(spec, str(root / "single"))
    return root, [torch.load(root / f"rank{r}.pt") for r in range(W)], single


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("mode", ["cached", "host"])
def test_only_rank_zero_writes(runs, mode):
    root, _, _ = runs
    for name in WRITTEN:
        assert (root / f"{mode}_r0" / name).exists(), name
    assert not any((root / f"{mode}_r1").iterdir())
    assert (root / "cached_r0" / "inference_result.json").exists()


def test_resume_loads_on_every_rank(runs):
    root, ranks, _ = runs
    assert [r["resumed_at"] for r in ranks] == [1] * W
    header, rows = _csv(root / "cached_r0" / "storage.csv")
    assert [row[0] for row in rows] == ["0", "1"]


def test_ranks_end_with_equal_parameters(runs):
    _, ranks, _ = runs
    assert ranks[0]["cached_digest"] == ranks[1]["cached_digest"]
    assert ranks[0]["host_digest"] == ranks[1]["host_digest"]


def test_device_cached_storage_equals_one_process_run(runs):
    root, _, single = runs
    header, rows = _csv(root / "cached_r0" / "storage.csv")
    ref_header, ref_rows = _csv(root / "single" / "storage.csv")
    assert header == ref_header
    assert len(rows) == len(ref_rows) == 2
    for row, ref in zip(rows, ref_rows):
        for col, a, b in zip(header, row, ref):
            if b == "":
                assert a == "", col
            else:
                assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-7), col
    got = json.loads((root / "cached_r0" / "inference_result.json").read_text())
    want = single.inference()
    for key in ("dice", "asd"):
        for k, v in want[key].items():
            assert got[key][k] == pytest.approx(v, rel=1e-4, abs=1e-6, nan_ok=True), (key, k)


def test_host_fed_ranks_train_and_evaluate(runs):
    root, ranks, _ = runs
    header, rows = _csv(root / "host_r0" / "storage.csv")
    assert len(rows) == 1
    for col, v in zip(header, rows[0]):
        if v != "":
            assert math.isfinite(float(v)), col
    assert all(math.isfinite(r["host_score"]) for r in ranks)


# --- MTTrainer and FineTuneTrainer ---------------------------------------------

SLICE_KINDS = ("mt", "ft")


@pytest.fixture(scope="module")
def slice_runs(layout):
    root, spec = layout
    spawn(slice_loop_worker, W, spec, str(root))
    single = {k: one_process_run(spec, str(root / f"{k}_single"), k) for k in SLICE_KINDS}
    return root, [torch.load(root / f"slice_rank{r}.pt") for r in range(W)], single


@pytest.mark.parametrize("kind", SLICE_KINDS)
def test_mt_and_ft_trainers_write_on_rank_zero_only(slice_runs, kind):
    root, _, _ = slice_runs
    for name in WRITTEN:
        assert (root / f"{kind}_r0" / name).exists(), name
    assert not any((root / f"{kind}_r1").iterdir())


@pytest.mark.parametrize("kind", SLICE_KINDS)
def test_mt_and_ft_ranks_end_with_equal_parameters_and_teachers(slice_runs, kind):
    _, ranks, _ = slice_runs
    assert ranks[0][kind] == ranks[1][kind]
    assert ranks[0][kind]["ema_step"] == 4          # two epochs of two steps


@pytest.mark.parametrize("kind", SLICE_KINDS)
def test_mt_and_ft_storage_equals_one_process_run(slice_runs, kind):
    root, _, _ = slice_runs
    header, rows = _csv(root / f"{kind}_r0" / "storage.csv")
    ref_header, ref_rows = _csv(root / f"{kind}_single" / "storage.csv")
    assert header == ref_header
    assert len(rows) == len(ref_rows) == 2
    for row, ref in zip(rows, ref_rows):
        for col, a, b in zip(header, row, ref):
            if b == "":
                assert a == "", col
            else:
                assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-7), col
