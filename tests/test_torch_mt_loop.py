"""The mean-teacher family and the EMA eval model on the port's experiment
loop (contrastyou_tpu_torch/trainers/mt.py, trainers/ft.py, engine/trainer.py
``set_model4inference`` / ``_inference_state``, engine/checkpoint.py, main.py
``Trainer.name=mt``) held against the JAX package on the CPU.

- A whole f32 ``mt`` run (max_channel 128, 2 epochs) through
  ``run_experiment``: JAX's ``MTTrainer.eval_epoch`` and ``inference`` on the
  port's ``last`` and ``best`` checkpoints (student, statistics and teacher
  converted back) give the port's validation and inference losses to 1e-5
  and dice within 2e-3 per class, the bounds and reasons of
  tests/test_torch_trainer.py; the teacher evaluated differs from the
  student. The same for ``EvalEMAParameters`` under ``semi`` (EMA
  statistics) and ``ft`` (``always_active``; the student's statistics).
- The CLI (bf16, max_channel 32): ``mt`` and the UAMT and ICT override
  forms, two epochs with the device cache in one run equal one epoch, a
  resume and one more, bitwise, the teacher included.
- ``mt`` with ``Arch.checkpoint``: the student starts from the checkpoint,
  the teacher from the initial weights, as JAX orders it; the first step's
  losses equal JAX's to rtol 1e-4 (tests/test_torch_step.py's).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.engine import trainer as jtrainer_module
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.creator import get_data
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.checkpoint import (extract_model_params, load_checkpoint,
                                                     save_checkpoint)
from contrastyou_tpu_torch.engine.steps import StepDraws
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.trainers import trainer_zoo
from contrastyou_tpu_torch.utils.torch_convert import hook_state_to_flax, state_dict_to_flax
from test_torch_mt import ICT_OVERRIDES, UAMT_OVERRIDES
from torch_parity import close, scaled_close, t

torch.set_num_threads(1)

SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2",
         "UnlabeledLoader.batch_size=2", "Trainer.num_batches=2", "Trainer.device=cpu"]
DICE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _xla_path(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """3 train scans of 4 slices, 3 validation scans (one of 6 slices) at 64 x 64."""
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=3, num_val_scans=2, slices_per_scan=4, size=64)
    synthesize_acdc_like(root, num_train_scans=0, num_val_scans=1, slices_per_scan=6, size=64,
                         first_scan=6, seed=1)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


@pytest.fixture
def fast_jax_bundle(monkeypatch):
    """JAX trainers build their bundle from the port's initial weights of
    seed ``weights["seed"]`` (flax's own init of this U-Net takes ~20 s to
    trace); the tests overwrite or compare those weights."""
    weights = {"seed": 0}

    def create(cls, model, rng, input_shape, batch=2):
        port = UNet(max_channel=model.max_channel, momentum=0.01, dtype=torch.float32,
                    num_classes=model.num_classes).init_weights(
            torch.Generator().manual_seed(weights["seed"]))
        tree = jax.tree.map(jnp.asarray, state_dict_to_flax(port.state_dict()))
        return cls(model, tree["params"], tree["batch_stats"], tuple(input_shape))

    monkeypatch.setattr(jtrainer_module.ModelBundle, "create", classmethod(create))
    return weights


def _csv_rows(path):
    lines = path.read_text().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, line.split(","))) for line in lines[1:]]


def _dice(row, stage):
    return {k.rsplit("/", 1)[1]: float(v) for k, v in row.items()
            if k.startswith(f"{stage}/eval/dice/")}


def _jax_trainer(cfg, tmp_path):
    """JAX's trainer of ``cfg`` with JAX's hooks (its factory picks the eval
    model), initialized."""
    loaders = jget_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                        root_dir=package.DATA_PATH)
    trainer = jtrainer_zoo[cfg["Trainer"]["name"]](
        model=JUNet(max_channel=128, momentum=0.01, dtype=jnp.float32),
        labeled_loader=loaders[0], unlabeled_loader=loaders[1], val_loader=loaders[2],
        test_loader=loaders[3], save_dir=str(tmp_path / "jax"),
        max_epoch=int(cfg["Trainer"]["max_epoch"]), num_batches=2,
        config={"Optim": cfg["Optim"], "Scheduler": cfg["Scheduler"]}, two_stage=True, seed=10)
    trainer.register_hooks(*jcreate_hooks(cfg, trainer=trainer))
    trainer.init()
    return trainer, loaders


def _load_into_jax(jtrainer, path):
    """The port's checkpoint ``path`` (model and hook states) into the JAX
    trainer's state."""
    saved = load_checkpoint(path)["train_state"]
    flax = jax.tree.map(jnp.asarray, state_dict_to_flax(saved["model"]))
    states = dict(jtrainer._state.hook_states)
    for name, state in saved["hook_states"].items():
        if state:                        # the mean-teacher and EMA hooks'
            states[name] = jax.tree.map(jnp.asarray, hook_state_to_flax(state))
    jtrainer._state = jtrainer._state.replace(params=flax["params"],
                                              batch_stats=flax["batch_stats"],
                                              hook_states=states)
    return saved


RUNS = {"mt": (["Trainer.name=mt"], "mt"),
        "semi+ema": (["Trainer.name=semi", "+EvalEMAParameters.alpha=0.9"], "ema_eval"),
        "ft+ema": (["Trainer.name=ft", "+EvalEMAParameters.alpha=0.9",
                    "+EvalEMAParameters.update_bn=false"], "ema_eval")}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_evaluates_on_the_hook_model_as_jax(run, paths, tmp_path, fast_jax_bundle):
    """f32, max_channel 128 (the JAX U-Net's least width), 2 epochs at lr
    1e-3, so the student moves away from the model evaluated."""
    overrides, eval_hook = RUNS[run]
    cfg = port_main.parse_config(["-o", *overrides, "Trainer.max_epoch=2", "Optim.lr=1e-3",
                                  "Arch.max_channel=128", "Trainer.save_dir=f32", *SMALL])
    trainer = port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32)
    assert trainer._inference_hook.name == eval_hook
    assert [h.name for h in trainer._active_hooks][-1] == eval_hook
    rows = _csv_rows(paths / "f32" / "storage.csv")
    assert len(rows) == 2
    jtrainer, jloaders = _jax_trainer(cfg, tmp_path)
    assert jtrainer._inference_hook.name == eval_hook
    assert [h.name for h in jtrainer._active_hooks] == [h.name for h in trainer._active_hooks]

    saved = _load_into_jax(jtrainer, paths / "f32" / "last")
    state = saved["hook_states"][eval_hook]
    assert state["ema_step"] == 4
    jstats, _ = jtrainer.eval_epoch(jloaders[2], 1)
    hook, jtrainer._inference_hook = jtrainer._inference_hook, None
    student_loss = jtrainer.eval_epoch(jloaders[2], 1)[0]["eval"]["loss"]
    jtrainer._inference_hook = hook
    print(run, "val loss: hook model", jstats["eval"]["loss"], "student", student_loss)
    # the student scores apart from the hook model by far more than the tolerance
    assert abs(student_loss - jstats["eval"]["loss"]) > 1e-3 * abs(student_loss)
    got, want = _dice(rows[1], "val"), jstats["eval"]["dice"]
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= DICE_TOL, (k, got[k], want[k])
    scaled_close(float(rows[1]["val/eval/loss/value"]), jstats["eval"]["loss"], tol=1e-5,
                 what="val loss")
    _load_into_jax(jtrainer, paths / "f32" / "best")
    jresult = jtrainer.inference()
    result = json.loads((paths / "f32" / "inference_result.json").read_text())
    for k in jresult["dice"]:
        assert abs(result["dice"][k] - jresult["dice"][k]) <= DICE_TOL, k
    scaled_close(result["loss"], jresult["loss"], tol=1e-5, what="inference loss")
    print(run, "val dice", got, "jax", want)


def _argv(save_dir, epochs, *extra):
    return ["-o", f"Trainer.max_epoch={epochs}", "Arch.max_channel=32",
            f"Trainer.save_dir={save_dir}", "Trainer.device_cache=true", *SMALL, *extra]


@pytest.mark.parametrize("name,overrides", [("mt", ["Trainer.name=mt"]),
                                            ("uamt", UAMT_OVERRIDES), ("ict", ICT_OVERRIDES)])
def test_device_cache_resume_is_bitwise_with_the_teacher(name, overrides, paths):
    assert port_main.main(_argv("whole", 2, *overrides)) == 0
    assert port_main.main(_argv("split", 1, *overrides)) == 0
    assert port_main.main(_argv("split", 2, *overrides)) == 0
    assert (paths / "whole" / "storage.csv").read_text() == (
        paths / "split" / "storage.csv").read_text()
    for f in (".success", "inference_result.json", "best/train_state.pt"):
        assert (paths / "split" / f).exists(), f
    a, b = (load_checkpoint(paths / r / "last")["train_state"] for r in ("whole", "split"))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    ta, tb = a["hook_states"][name], b["hook_states"][name]
    assert ta["ema_step"] == tb["ema_step"] == 4
    for part in ("teacher_params", "teacher_batch_stats"):
        for k, v in ta[part].items():
            assert torch.equal(v, tb[part][k]), (part, k)
    assert not torch.equal(ta["teacher_params"]["_Up_conv2.conv.3.weight"],
                           a["model"]["_Up_conv2.conv.3.weight"])


def test_arch_checkpoint_warm_starts_the_student_not_the_teacher(data_root, tmp_path,
                                                                 monkeypatch, fast_jax_bundle):
    """JAX copies the teacher from the fresh model in ``init`` and
    ``Arch.checkpoint`` then replaces the student's parameters alone; the
    first step's losses (``mt/loss`` included) equal JAX's."""
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    cfg = port_main.parse_config(["-o", "Trainer.name=mt", "Arch.max_channel=128",
                                  "Trainer.max_epoch=2", "Optim.lr=1e-3", *SMALL])
    warm = UNet(max_channel=128, momentum=0.01, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(3))
    save_checkpoint(tmp_path / "ckpt", train_state={"model": warm.state_dict()}, host_state={})

    loaders = get_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                       root_dir=package.DATA_PATH)
    model = UNet(max_channel=128, momentum=0.01, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))
    fresh = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = trainer_zoo["mt"](model=model, labeled_loader=loaders[0],
                                unlabeled_loader=loaders[1], save_dir=str(tmp_path / "port"),
                                max_epoch=2, num_batches=2, config=cfg, seed=10)
    trainer.register_hooks(*create_hook_from_config(cfg, channel_dim=model.get_channel_dim,
                                                    trainer=trainer))
    trainer.init()
    trainer.load_model_params(extract_model_params(tmp_path / "ckpt", model))
    teacher = trainer._state.hook_states["mt"]["teacher_params"]
    for k, p in model.named_parameters():
        assert torch.equal(p, warm.state_dict()[k]) and torch.equal(teacher[k], fresh[k]), k

    jtrainer, _ = _jax_trainer(cfg, tmp_path)       # fresh weights of seed 0, as the port's
    jwarm = jax.tree.map(jnp.asarray, state_dict_to_flax(warm.state_dict()))
    jtrainer.load_model_params(jwarm["params"])
    jstate = jtrainer._state
    for a, b in zip(jax.tree.leaves(jstate.hook_states["mt"]["teacher_params"]),
                    jax.tree.leaves(state_dict_to_flax(fresh)["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)

    rng = np.random.default_rng(0)
    batch = {"labeled_image": rng.random((2, 224, 224, 1)).astype(np.float32),
             "labeled_target": rng.integers(0, 4, (2, 224, 224)).astype(np.int32),
             "unlabeled_image": rng.random((2, 224, 224, 1)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    jstep = jax.jit(jbuild(jtrainer._bundle, jtrainer._optimizer, jtrainer._active_hooks,
                           raw=True, two_stage=True, mode="semi"))
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.int32(0))
    k_geo, k_int, _ = jax.random.split(key, 3)
    geo = GeoParams(*(torch.tensor(np.asarray(v)) for v in sample_geo_params(k_geo, 2)))
    gammas = t(jax.random.uniform(k_int, (2, 1, 1, 1), minval=0.5, maxval=2.0)).reshape(2)
    m = trainer._train_step(trainer._state, {k: torch.tensor(v) for k, v in batch.items()},
                            StepDraws(geo, gammas, {}), 0)
    for k in ("sup_loss", "mt/loss", "reg_loss", "total_loss"):
        close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=k)
