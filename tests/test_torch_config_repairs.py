"""Config faults of the port repaired against the JAX package: the class
count and label remap of every ``Data.name``, and config keys that the port
parses but does not implement (they raise instead of training something
else)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from contrastyou_tpu.augment.host import LabelRemap, transform_zoo
from contrastyou_tpu_torch.data.datasets import DATASETS, dataset_spec
from contrastyou_tpu_torch.main import (UNPORTED_KEYS, build_pretrain_run, build_semi_run,
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


@pytest.mark.parametrize("key,value", [("Trainer.accumulate_iter", "4"), ("Arch.name", "unet2"),
                                       ("Arch.checkpoint", "ckpt.pth"),
                                       ("Arch.pretrained_path", "enc.npz"),
                                       ("trainer_checkpoint", "last.pth")])
def test_unported_keys_raise(key, value):
    """A non-default value of a key the port does not implement raises
    ``NotImplementedError`` naming it, in both run builders, before anything
    is built."""
    assert tuple(key.split(".")) in UNPORTED_KEYS
    for trainer, build, size in (("semi", build_semi_run, dict(raw_size=40, n_slices=8)),
                                 ("pretrain", build_pretrain_run, dict(raw_size=36, n_scans=6))):
        cfg = parse_config(["-o", f"Trainer.name={trainer}", f"+{key}={value}"])
        with pytest.raises(NotImplementedError, match=re.escape(key)):
            build(cfg, **size, **SMALL)
