"""Contrastive pretraining on the port's experiment loop
(contrastyou_tpu_torch/trainers/pretrain.py ``get_contrastive_loader``,
``PretrainEncoderTrainer`` / ``PretrainDecoderTrainer``; main.py) held
against the JAX package, and the CLI chain pretrain -> fine-tune -> sweep.

- The contrastive loader over ``get_data(pretrain=True)``'s labeled split
  (half of the train scans): its first batches equal JAX
  ``get_contrastive_loader``'s bitwise (indices through the filenames,
  padding, images, targets, partition, scan, patient and cycle ids), in the
  ACDC branch (``ContrastBatchSampler``; with two slices per partition a
  partition of one slice is skipped, so batches come out short and padded)
  and in the random-sampler branch (any other ``Data.name``).
- The CLI chain through ``main.main`` on the CPU (bf16, max_channel 32, the
  dataset's 224 x 224 crop, one step per epoch): ``pretrain_decoder`` for
  2 epochs, a resume to 3, ``ft`` from its ``last`` (``Arch.checkpoint``),
  then ``val``'s sweep at 1 and 2 labeled scans. Checked: the files each
  run writes and does not write, the resume's history and counts, the
  frozen ``_Deconv_1x1`` bit-unchanged, the warm start's parameters equal to
  the checkpoint's bit for bit with the BN statistics and the optimizer
  fresh, finite losses and dice.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.data.sampler import InfiniteRandomSampler as JInfinite
from contrastyou_tpu.trainers.pretrain import get_contrastive_loader as jget_loader
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.creator import get_data
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.checkpoint import extract_model_params, load_checkpoint
from contrastyou_tpu_torch.trainers.ft import FineTuneTrainer
from contrastyou_tpu_torch.trainers.pretrain import get_contrastive_loader
from contrastyou_tpu_torch.val import val

torch.set_num_threads(1)

SEED = 10


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """4 train scans (2 in the pretrain split) and 3 validation scans of 6
    slices at 64 x 64."""
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=4, num_val_scans=3, slices_per_scan=6, size=64)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def _pretrain_splits(root):
    data = {"name": "acdc", "labeled_scan_num": 1}
    ours = get_data(data, {}, {}, root_dir=str(root), pretrain=True)[0].dataset
    ref = jget_data(data, {}, {}, root_dir=str(root), pretrain=True)[0].dataset
    assert ours.get_scan_list() == ref.get_scan_list() and len(ours.get_scan_list()) == 2
    return ours, ref


def _batches_equal(ours, ref, n):
    got = list(itertools.islice(iter(ours), n))
    want = list(itertools.islice(iter(ref), n))
    assert len(got) == len(want) == n
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), (i, set(a) ^ set(b))
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, (i, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {i} {k}")
            else:
                assert a[k] == b[k], (i, k, a[k], b[k])
    return got


@pytest.mark.parametrize("scan_sample_num,partition_sample_num", [(2, 1), (1, 2)])
def test_contrastive_loader_matches_jax(data_root, scan_sample_num, partition_sample_num):
    """ACDC branch: scan_sample_num scans x every partition; with 2 slices a
    partition, the one-slice partition 2 is skipped and the batch padded."""
    ours, ref = _pretrain_splits(data_root)
    kw = dict(data_name="acdc", seed=SEED, scan_sample_num=scan_sample_num,
              partition_sample_num=partition_sample_num)
    a, b = get_contrastive_loader(ours, **kw), jget_loader(ref, **kw)
    assert a.batch_size == b.batch_size == 3 * scan_sample_num * partition_sample_num
    got = _batches_equal(a, b, 4)
    padded = [int((~g["mask"]).sum()) for g in got]
    assert all(p == 0 for p in padded) if partition_sample_num == 1 else all(p == 2 for p in padded)


def test_contrastive_loader_random_branch_matches_jax(data_root):
    """Any ``Data.name`` but acdc* / spleen: consecutive runs of an endless
    random permutation stream of min(scan_sample_num x partition_num x
    partition_sample_num, 50) slices (here on the ACDC files: the name only
    picks the branch)."""
    ours, ref = _pretrain_splits(data_root)
    kw = dict(data_name="hippocampus", seed=SEED, scan_sample_num=2)
    a, b = get_contrastive_loader(ours, **kw), jget_loader(ref, **kw)
    assert a.batch_size == b.batch_size == 6
    got = _batches_equal(a, b, 4)
    stream = list(itertools.islice(iter(JInfinite(len(ref), seed=SEED, process_index=0,
                                                  process_count=1)), 24))
    files = ref.get_stem_list()
    assert [f for g in got for f in g["filename"]] == [files[i] for i in stream]


# --- the CLI chain -----------------------------------------------------------

COMMON = ["Trainer.device=cpu", "Arch.max_channel=32", "Trainer.num_batches=1"]
PRETRAIN = ["-o", "Trainer.name=pretrain_decoder", "Trainer.save_dir=pre",
            "ContrastiveLoaderParams.scan_sample_num=1", *COMMON]


def _rows(run):
    return (run / "storage.csv").read_text().splitlines()


def _ft_argv(runs, save_dir, epochs, *extra):
    return ["-o", "Trainer.name=ft", f"Trainer.save_dir={save_dir}",
            f"Trainer.max_epoch={epochs}", "LabeledLoader.batch_size=2", *COMMON, *extra]


def test_cli_chain_pretrain_finetune_sweep(paths, monkeypatch):
    pre = paths / "pre"
    assert port_main.main(PRETRAIN + ["Trainer.max_epoch=2"]) == 0
    for f in ("storage.csv", "config.yaml", ".success", "last/train_state.pt",
              "last/host_state.pkl"):
        assert (pre / f).exists(), f
    for f in ("best", "inference_result.json"):
        assert not (pre / f).exists(), f
    first = _rows(pre)
    assert len(first) == 3 and first[0].split(",")[1] == "tra/pretrain/reg_loss/value"
    assert all(np.isfinite(float(v)) for r in first[1:] for v in r.split(",")[1:])

    # resume to a third epoch: the history kept, one step a epoch counted
    assert port_main.main(PRETRAIN + ["Trainer.max_epoch=3"]) == 0
    rows = _rows(pre)
    assert rows[:3] == first and len(rows) == 4
    ckpt = load_checkpoint(pre / "last")
    assert ckpt["host_state"]["cur_epoch"] == 3
    assert ckpt["train_state"]["optimizer_count"] == ckpt["train_state"]["step"] == 3
    cfg = port_main.parse_config(PRETRAIN + ["Trainer.max_epoch=3"])
    fresh = port_main._model(cfg, "cpu", torch.bfloat16, None,
                             torch.Generator().manual_seed(SEED), 4)
    saved = ckpt["train_state"]["model"]
    for k in ("_Deconv_1x1.weight", "_Deconv_1x1.bias"):
        assert torch.equal(saved[k], fresh.state_dict()[k]), f"frozen {k} changed"
    assert not torch.equal(saved["_Conv1.conv.0.weight"], fresh.state_dict()["_Conv1.conv.0.weight"])

    # ft from the pretrained weights: the state right after the warm start
    seen = {}
    start = FineTuneTrainer.start_training

    def record(self):
        seen["params"] = {k: p.detach().clone() for k, p in self._model.named_parameters()}
        seen["buffers"] = {k: b.clone() for k, b in self._model.named_buffers()}
        seen["optimizer"] = (dict(self._state.optimizer.state), self._state.optimizer.count,
                             self._state.step)
        return start(self)

    monkeypatch.setattr(FineTuneTrainer, "start_training", record)
    assert port_main.main(_ft_argv(paths, "ft", 2, f"Arch.checkpoint={pre}/last")) == 0
    for k, v in seen["params"].items():
        assert torch.equal(v, saved[k]), k
    for k, v in seen["buffers"].items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    assert seen["optimizer"] == ({}, 0, 0)
    ft = paths / "ft"
    for f in ("storage.csv", ".success", "best/train_state.pt", "last/train_state.pt",
              "inference_result.json"):
        assert (ft / f).exists(), f
    assert len(_rows(ft)) == 3
    result = json.loads((ft / "inference_result.json").read_text())
    assert np.isfinite(result["loss"]) and np.isfinite(result["dice"]["DSC_mean"])
    ft_ckpt = load_checkpoint(ft / "last")["train_state"]
    assert ft_ckpt["hooks"] == {} and ft_ckpt["optimizer_count"] == 2

    # the sweep at 1 and 2 labeled scans
    monkeypatch.setattr(FineTuneTrainer, "start_training", start)
    base = port_main.parse_config(_ft_argv(paths, "sweep", 1))
    model = port_main._model(base, "cpu", torch.bfloat16, None,
                             torch.Generator().manual_seed(SEED), 4)
    results = val(model=model, pretrained_params=extract_model_params(pre / "last", model),
                  save_dir=str(pre), base_config=base, labeled_ratios=[1, 2], seed=SEED)
    assert sorted(results) == [1, 2] and all(np.isfinite(v) for v in results.values())
    for n in (1, 2):
        run = pre / "tra" / f"num_labeled_scan_{n}"
        assert (run / ".success").exists() and len(_rows(run)) == 2, n
