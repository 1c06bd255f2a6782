"""The entry point's runs of the other architectures and knobs
(contrastyou_tpu_torch/main.py ``run_experiment``) on a synthetic layout on
the CPU, held against the JAX package: the ``Arch`` keys reach the net as
they reach JAX's ``get_arch`` (``Arch.name=resunet``, ``+Arch.norm=
groupnorm``), whose ``semi`` + consistency step gives the port's first
step's losses, and ``EvalEMAParameters`` under ``pretrain_decoder``.

Tolerances: the first step's losses at rtol 1e-4 (f32, the same weights,
batch and transform draws); the EMA at 1e-6 of the f32 mean it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.engine.steps import init_train_state as jinit
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.hooks.mt import EMAEvalTrainerHook as JEMAHook
from contrastyou_tpu.models import get_arch as jget_arch
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine import trainer as port_trainer
from contrastyou_tpu_torch.engine.checkpoint import load_checkpoint
from contrastyou_tpu_torch.engine.steps import StepDraws
from contrastyou_tpu_torch.models.resunet import ResUNet
from contrastyou_tpu_torch.models.unet import GroupNorm
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import state_dict_to_flax
from torch_parity import close, n, t

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """4 train scans of 4 slices (the pretrain split holds 2), 2 validation
    scans, at 64 x 64."""
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=4, num_val_scans=2, slices_per_scan=4, size=64)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2",
         "UnlabeledLoader.batch_size=2", "Trainer.num_batches=1", "Trainer.max_epoch=1",
         "Trainer.device=cpu"]


@pytest.mark.parametrize("arch,width", [("Arch.name=resunet", 64), ("+Arch.norm=groupnorm", 128)])
def test_arch_keys_train_the_net_jax_trains(arch, width, paths, monkeypatch):
    """``semi`` + consistency through ``run_experiment`` (f32) builds the net
    JAX's ``get_arch`` builds from the same ``Arch`` keys, and its first
    step, with the transform replayed from a JAX key, gives the losses of
    JAX's step on the same weights and batch (JAX's U-Net takes
    max_channel >= 128, so the GroupNorm net runs at 128)."""
    key = jax.random.PRNGKey(3)
    seen = {}
    build = port_trainer.build_train_step

    def recording(bundle, hooks, **kw):
        step = build(bundle, hooks, **kw)

        def first(state, batch, draws, epoch=0):
            nu = batch["unlabeled_image"].shape[0]
            k_geo, k_int, _ = jax.random.split(key, 3)
            geo = sample_geo_params(k_geo, nu)
            gammas = jax.random.uniform(k_int, (nu, 1, 1, 1), minval=0.5, maxval=2.0)
            draws = StepDraws(GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                              t(gammas).reshape(nu), draws.hooks, draws.points)
            seen.update(batch={k: n(v) if v.is_floating_point() else v.numpy()
                               for k, v in batch.items()},
                        before=state_dict_to_flax(state.model.state_dict(), state.model))
            seen["metrics"] = step(state, batch, draws, epoch)
            return seen["metrics"]

        return first

    monkeypatch.setattr(port_trainer, "build_train_step", recording)
    cfg = port_main.parse_config(["-o", "Trainer.name=semi", arch, f"Arch.max_channel={width}",
                                  "Trainer.save_dir=run", *SMALL])
    trainer = port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32)
    model = trainer._model
    if "resunet" in arch:
        assert isinstance(model, ResUNet)
    else:
        assert sum(isinstance(m, GroupNorm) for m in model.modules()) == 22
    assert (paths / "run" / ".success").exists()
    assert load_checkpoint(paths / "run" / "last")["train_state"]["model"].keys() == \
        model.state_dict().keys()

    arch_kw = {k: v for k, v in cfg["Arch"].items() if k not in ("name", "checkpoint")}
    jm = jget_arch(cfg["Arch"]["name"], input_dim=1, num_classes=4, dtype=jnp.float32,
                   **arch_kw)
    before = seen["before"]
    bundle = JBundle(jm, before["params"], before["batch_stats"], (224, 224, 1))
    tx, _ = jcreate(cfg["Optim"], cfg["Scheduler"], max_epoch=1, steps_per_epoch=1)
    hooks = [JConsistency(weight=10.0)]
    state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
    batch = {k: jnp.asarray(seen["batch"][k]) for k in
             ("labeled_image", "labeled_target", "unlabeled_image")}
    _, jm_metrics = jax.jit(jbuild(bundle, tx, hooks, raw=True, two_stage=True,
                                   mode="semi"))(state, batch, key, jnp.int32(0))
    for k in ("sup_loss", "reg_loss", "consistency/loss"):
        close(seen["metrics"][k], jm_metrics[k], rtol=1e-4, atol=1e-7, what=k)


def test_eval_ema_under_pretrain_decoder(paths):
    """``EvalEMAParameters`` under ``pretrain_decoder``: JAX's factory builds
    the EMA hook there and so does the port's; the EMA of the student
    (alpha min(1 - 1/(step + 1), 0.99): the student after step 1, the mean
    of the two students after step 2) travels in the checkpoint and a
    resumed run carries it on."""
    argv = ["-o", "Trainer.name=pretrain_decoder", "Arch.max_channel=32",
            "+EvalEMAParameters.alpha=0.99", "Trainer.num_batches=1", "Trainer.max_epoch=1",
            "Trainer.device=cpu", "ContrastiveLoaderParams.scan_sample_num=2",
            "Trainer.save_dir=pre"]
    cfg = port_main.parse_config(argv)
    assert any(isinstance(h, JEMAHook) for h in jcreate_hooks(cfg, is_pretrain=True))
    students = []
    build = port_main.trainer_zoo["pretrain_decoder"]._build_steps

    def record(self):
        build(self)
        step = self._train_step

        def wrapped(state, *a, **kw):
            out = step(state, *a, **kw)
            students.append({k: p.detach().clone() for k, p in state.model.named_parameters()})
            return out

        self._train_step = wrapped

    def ema():
        return load_checkpoint(paths / "pre" / "last")["train_state"]["hook_states"]["ema_eval"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_main.trainer_zoo["pretrain_decoder"], "_build_steps", record)
        trainer = port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32)
        assert trainer._inference_hook.name == "ema_eval" and ema()["ema_step"] == 1
        for k, p in ema()["ema_params"].items():
            assert torch.equal(p, students[0][k]), k
        cfg["Trainer"]["max_epoch"] = 2
        port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32)
    state = ema()
    assert state["ema_step"] == 2
    for k, p in state["ema_params"].items():
        torch.testing.assert_close(p, 0.5 * students[0][k] + 0.5 * students[1][k],
                                   rtol=1e-6, atol=1e-7)
