"""Config faults of the port repaired against the JAX package: the class
count and label remap of every ``Data.name``, config keys that the port
parses but does not implement (they raise instead of training something
else), ``Arch`` keys (honoured, or raising where JAX's entry point raises,
never dropped), and warm-start keys that name a missing file (they raise
before anything is built)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.augment.host import LabelRemap, transform_zoo
from contrastyou_tpu_torch.data.datasets import DATASETS, dataset_spec
from contrastyou_tpu_torch.models.unet import BatchNorm, GroupNorm
from contrastyou_tpu_torch.main import (UNPORTED_KEYS, build_pretrain_run, build_semi_run, main,
                                        parse_config, synthetic_split)

OPT = Path(__file__).resolve().parents[1] / "opt"
SMALL = dict(device="cpu", dtype=torch.float32, crop=32, max_channel=128)


def _opt_num_classes(name: str) -> int:
    """``num_classes`` of opt/<name>.yaml, read as text; the root main.py
    takes 4 where the file does not exist."""
    f = OPT / f"{name}.yaml"
    if not f.exists():
        return 4
    m = re.search(r"^num_classes:\s*(\d+)\s*$", f.read_text(), re.M)
    return int(m.group(1))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_trained_class_count_matches_opt_yaml(name):
    """The port trains as many classes per ``Data.name`` as the JAX entry
    point reads from opt/<name>.yaml."""
    assert dataset_spec(name).train_classes == _opt_num_classes(name)


@pytest.mark.parametrize("name", ["acdc_lv", "acdc_rv", "acdc_myo"])
def test_acdc_subtask_targets_are_remapped_as_jax(name):
    """The binary ACDC sub-tasks: 4-class synthetic targets remapped by the
    tables of JAX's ``transform_zoo``; ``semi`` builds a 2-class head and
    stages the remapped targets."""
    spec = dataset_spec(name)
    _, targets = synthetic_split(6, 40, num_classes=spec.num_classes, seed=10)
    assert sorted(np.unique(targets)) == [0, 1, 2, 3]
    ref = LabelRemap(transform_zoo[name]().mapping)(None, targets, None)[1]
    np.testing.assert_array_equal(spec.remap(targets), ref)
    run = build_semi_run(parse_config(["-o", "Trainer.name=semi", f"Data.name={name}"]),
                         raw_size=40, n_slices=6, **SMALL)
    assert run.state.model._Deconv_1x1.out_channels == 2
    got = torch.cat([run.labeled_cache.targets, run.unlabeled_cache.targets]).numpy()
    np.testing.assert_array_equal(got, ref)
    m = run.step(run.state, run.generator)
    assert m["dice_inter"].shape[-1] == 2


@pytest.mark.parametrize("key,value", [("Trainer.unroll_steps", "2"), ("Trainer.profile", "true")])
def test_unported_keys_raise(key, value):
    """Both keys that were refused as unported are ported: they have left
    :data:`UNPORTED_KEYS`, which is empty. ``Trainer.profile`` is taken by
    both run-building functions. ``Trainer.unroll_steps`` is accepted by the
    ``semi`` run, whose step then runs that many steps a call (metrics
    stacked [2, ...]); pretraining refuses it, naming the key, as JAX's
    pretraining runs one step a call."""
    assert UNPORTED_KEYS == {}
    for trainer, build, size in (("semi", build_semi_run, dict(raw_size=40, n_slices=8)),
                                 ("pretrain", build_pretrain_run, dict(raw_size=36, n_scans=6))):
        cfg = parse_config(["-o", f"Trainer.name={trainer}", f"+{key}={value}"])
        if key == "Trainer.profile":
            assert cfg["Trainer"]["profile"] is True
            build(cfg, **size, **SMALL)
            continue
        assert cfg["Trainer"]["unroll_steps"] == 2
        if trainer == "semi":
            run = build(cfg, **size, **SMALL)
            m = run.step(run.state, run.generator, 0, run.host_rng)
            assert m["sup_loss"].shape == (2,) and run.state.step == 2
            continue
        with pytest.raises(NotImplementedError, match=re.escape(key)):
            build(cfg, **size, **SMALL)


@pytest.mark.parametrize("override,error,match", [
    ("Arch.name=unet2", TypeError, "UNet2 has no field dtype, max_channel, momentum"),
    ("+Arch.norm=instancenorm", ValueError, "norm='instancenorm'")])
def test_arch_keys_the_net_lacks_raise(override, error, match):
    """The entry point passes every ``Arch`` key but name, checkpoint,
    pretrained_path and true_num_classes to the net, as JAX's root main.py:
    ``Arch.name=unet2`` raises there (UNet2 has no ``dtype``,
    ``max_channel`` or ``momentum`` field, the cause named), and a norm
    other than batchnorm / groupnorm raises (JAX takes any other value as
    GroupNorm), in both run builders before anything is trained."""
    for trainer, build, size in (("semi", build_semi_run, dict(raw_size=40, n_slices=8)),
                                 ("pretrain", build_pretrain_run, dict(raw_size=36, n_scans=6))):
        cfg = parse_config(["-o", f"Trainer.name={trainer}", override])
        with pytest.raises(error, match=re.escape(match)):
            build(cfg, **size, **SMALL)


def test_arch_norm_groupnorm_builds_groupnorm_layers():
    """``+Arch.norm=groupnorm`` reaches the U-Net (the port used to drop it
    and train a BatchNorm net): every norm of the run's model is a
    GroupNorm, there are no running statistics, and a step trains."""
    run = build_semi_run(parse_config(["-o", "Trainer.name=semi", "+Arch.norm=groupnorm"]),
                         raw_size=40, n_slices=8, **SMALL)
    model = run.state.model
    norms = [m for m in model.modules() if isinstance(m, (GroupNorm, BatchNorm))]
    assert len(norms) == 22 and all(isinstance(m, GroupNorm) for m in norms)
    assert not list(model.buffers())
    m = run.step(run.state, run.generator)
    assert torch.isfinite(m["total_loss"])


@pytest.mark.parametrize("key,name", [("Arch.checkpoint", "pretrain/last"),
                                      ("Arch.pretrained_path", "enc.npz")])
def test_missing_warm_start_raises(key, name, tmp_path, monkeypatch):
    """A warm start from a checkpoint directory or npz archive that is not
    there raises ``FileNotFoundError`` naming the path, in both run builders
    and in the entry point, before a model is built or a run directory made."""
    missing = str(tmp_path / name)
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    for trainer, build, size in (("semi", build_semi_run, dict(raw_size=40, n_slices=8)),
                                 ("pretrain", build_pretrain_run, dict(raw_size=36, n_scans=6))):
        cfg = parse_config(["-o", f"Trainer.name={trainer}", f"+{key}={missing}"])
        with pytest.raises(FileNotFoundError, match=re.escape(missing)):
            build(cfg, **size, **SMALL)
    for trainer in ("ft", "pretrain_decoder"):
        with pytest.raises(FileNotFoundError, match=re.escape(missing)):
            main(["-o", f"Trainer.name={trainer}", "Trainer.device=cpu", f"+{key}={missing}"])
    assert not (tmp_path / "runs").exists()
