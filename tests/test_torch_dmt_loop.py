"""The differentiable mean teacher on the port's experiment loop
(contrastyou_tpu_torch/trainers/dmt.py, main.py ``Trainer.name=dmt``,
engine/checkpoint.py with the hook's teacher and Adam state) on the CPU.

- ``main.main`` with ``Trainer.name=dmt`` (the preset's ``method1``) and
  with ``second_order``: the files JAX's trainer writes, ``storage.csv``'s
  header equal to JAX's ``DMTTrainer``'s (``second_order``: JAX's
  ``method1`` header with the hook's ``meta_loss`` column, in the order JAX
  sorts the hook's metrics; JAX's trainer compiles ``second_order``'s step
  for minutes on the CPU), the eval model the teacher, and a
  resume to one more epoch that restores the teacher, its statistics, its
  Adam moments and count and ``ema_step`` from ``last``.
- The in-code base equals config/base.yaml + config/hooks/dmt.yaml, every
  ``method_name`` builds, ``DMTTrainer`` without the hook raises.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.engine import trainer as jtrainer_module
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint
from contrastyou_tpu_torch.hooks.creator import UNPORTED_SECTIONS, create_hook_from_config
from contrastyou_tpu_torch.hooks.dmt import METHODS, DifferentiableMeanTeacherTrainerHook
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.trainers import trainer_zoo
from contrastyou_tpu_torch.trainers.dmt import DMTTrainer
from contrastyou_tpu_torch.utils.torch_convert import state_dict_to_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2",
         "Trainer.num_batches=2", "Trainer.max_epoch=1", "Trainer.device=cpu"]


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


@pytest.fixture
def layout(tmp_path, monkeypatch):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=3, num_val_scans=2,
                         slices_per_scan=4, size=32)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def jax_loop_header(cfg, tmp_path, monkeypatch) -> list:
    """The ``storage.csv`` header of JAX's trainer of ``cfg`` (max_channel
    128, f32, its bundle from the port's initial weights: flax's own init
    takes ~20 s to trace) after ``max_epoch`` x ``num_batches`` steps."""
    def create(cls, model, rng, input_shape, batch=2):
        port = UNet(max_channel=128, momentum=0.01, dtype=torch.float32).init_weights(
            torch.Generator().manual_seed(0))
        tree = jax.tree.map(jnp.asarray, state_dict_to_flax(port.state_dict()))
        return cls(model, tree["params"], tree["batch_stats"], tuple(input_shape))

    monkeypatch.setattr(jtrainer_module.ModelBundle, "create", classmethod(create))
    loaders = jget_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                        root_dir=package.DATA_PATH)
    trainer = jtrainer_zoo[cfg["Trainer"]["name"]](
        model=JUNet(max_channel=128, momentum=0.01, dtype=jnp.float32),
        labeled_loader=loaders[0], unlabeled_loader=loaders[1], val_loader=loaders[2],
        test_loader=loaders[3], save_dir=str(tmp_path / "jax"),
        max_epoch=int(cfg["Trainer"]["max_epoch"]),
        num_batches=int(cfg["Trainer"]["num_batches"]),
        config={"Optim": cfg["Optim"], "Scheduler": cfg["Scheduler"]}, two_stage=True, seed=10)
    trainer.register_hooks(*jcreate_hooks(cfg, trainer=trainer))
    trainer.init()
    trainer.start_training()
    return (tmp_path / "jax" / "storage.csv").read_text().splitlines()[0].split(",")


@pytest.mark.parametrize("method", ["method1", "second_order"])
def test_dmt_loop_writes_jax_columns_and_resumes(method, layout, tmp_path, monkeypatch):
    argv = ["-o", "Trainer.name=dmt", "Trainer.save_dir=dmt", "Arch.max_channel=32",
            f"DifferentiableMeanTeacherParameters.method_name={method}", *SMALL]
    assert port_main.main(argv) == 0
    run = layout / "dmt"
    for f in (".success", "inference_result.json", "last/train_state.pt", "best/train_state.pt",
              "config.yaml"):
        assert (run / f).exists(), f
    lines = (run / "storage.csv").read_text().splitlines()
    header, row = lines[0].split(","), dict(zip(*(line.split(",") for line in lines[:2])))
    assert len(lines) == 2 and np.isfinite(float(row["tra/dmt/metrics/consistency_loss"]))
    saved = load_checkpoint(run / "last")["train_state"]["hook_states"]["dmt"]
    assert saved["ema_step"] == 2
    assert ("teacher_opt" in saved) == (method == "method1")

    seen = {}
    original = DMTTrainer.start_training

    def start(self):
        seen["state"] = self._state.hook_states["dmt"]
        seen["eval_hook"] = self._inference_hook
        return original(self)

    monkeypatch.setattr(DMTTrainer, "start_training", start)
    assert port_main.main([*argv, "Trainer.max_epoch=2"]) == 0
    state = seen["state"]
    assert isinstance(seen["eval_hook"], DifferentiableMeanTeacherTrainerHook)
    assert state["ema_step"] == 4 and len((run / "storage.csv").read_text().splitlines()) == 3
    if method == "method1":
        assert state["teacher_opt"]["count"] == 4
    # the resumed run started from the saved teacher (its first epoch moved it on)
    resumed = load_checkpoint(run / "last")["train_state"]["hook_states"]["dmt"]
    assert not torch.equal(resumed["teacher_params"]["_Conv1.conv.0.weight"],
                           saved["teacher_params"]["_Conv1.conv.0.weight"])

    jcfg = port_main.parse_config([*argv, "DifferentiableMeanTeacherParameters.method_name="
                                   "method1"])
    want = jax_loop_header(jcfg, tmp_path, monkeypatch)
    if method == "second_order":
        at = want.index("tra/dmt/metrics/loss") + 1
        want = want[:at] + ["tra/dmt/metrics/meta_loss"] + want[at:]
    assert header == want


def test_dmt_config_and_factory():
    assert port_main.DMT_CONFIG == merge(yaml_load(REPO / "config/base.yaml"),
                                         yaml_load(REPO / "config/hooks/dmt.yaml"))
    assert port_main.parse_config(["-o", "Trainer.name=dmt"]) == port_main.DMT_CONFIG
    assert trainer_zoo["dmt"] is DMTTrainer and set(trainer_zoo) == set(jtrainer_zoo)
    assert UNPORTED_SECTIONS == ()
    width = UNet(max_channel=128).get_channel_dim
    for method in METHODS:
        cfg = merge(port_main.DMT_CONFIG,
                    {"DifferentiableMeanTeacherParameters": {"method_name": method}})
        (hook,) = create_hook_from_config(cfg, channel_dim=width)
        (jhook,) = jcreate_hooks(cfg)
        assert hook.name == jhook.name == "dmt" and hook._method == jhook._method == method
        assert hook.weight == jhook.weight == 10.0
    with pytest.raises(RuntimeError, match="pretrain"):
        create_hook_from_config(cfg, channel_dim=width, is_pretrain=True)
    with pytest.raises(ValueError, match="method_name"):
        DifferentiableMeanTeacherTrainerHook(method_name="method5")
