"""The multicore (multi-prototype) trainer of the port
(contrastyou_tpu_torch/losses/multicore.py, losses/pica.py,
trainers/multicore.py, the ``sup_criterion`` / ``prob_transform`` /
``target_num_classes`` of engine/steps.py and engine/trainer.py, the
multicore branch of main.py) held against the JAX package on the CPU.

- Every function of losses/multicore.py and losses/pica.py: value and
  gradient of each input, f32, rtol 1e-5 (``scale_grad``: the gradient
  scaled, the value passed through).
- Two ``semi`` steps with ``MultiCoreKL`` (4 classes x 2 prototypes) and
  the IIC hook on the prototype logits through ``build_train_step`` against
  JAX's: losses rtol 1e-4; the update per tensor 1e-1, over all 5e-2 in
  L2, because JAX's f32 gradient is that noisy here (the multicore
  gradient is held to JAX's f64 to 1e-3 instead); the dice counts exact at
  the first step and within 1% after an update.
- The eval step, with and without TTA, collapses the 8 prototype channels
  to 4 classes as JAX's: loss rtol 1e-5, predictions and dice counts equal.
- ``MulticoreParameters.name`` other than ``naive`` raises, as JAX's main;
  the in-code base equals config/base.yaml + config/hooks/multicore.yaml.
- ``main.main`` with ``Trainer.name=multicore`` alone and with a mean
  teacher (``multicore_mt``'s sections): the files JAX's trainer writes,
  ``storage.csv``'s header equal to JAX's trainer's, a resume.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_eval_step as jbuild_eval
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.losses import multicore as jmc
from contrastyou_tpu.losses import pica as jpica
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
from contrastyou_tpu.trainers.multicore import prototype_groups as jgroups
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_eval_step, build_train_step,
                                                init_train_state)
from contrastyou_tpu_torch.losses import multicore as mc
from contrastyou_tpu_torch.losses import pica
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.trainers import trainer_zoo
from contrastyou_tpu_torch.trainers.multicore import MulticoreTrainer, prototype_groups
from contrastyou_tpu_torch.utils.torch_convert import flax_to_state_dict, state_dict_to_flax
from torch_parity import close, n, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-7
NL, NU, S, C, MULT = 2, 2, 32, 4, 2
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


# --- the losses ------------------------------------------------------------------

def _simplex(rng, shape):
    return rng.dirichlet(np.ones(shape[-1]), shape[:-1]).astype(np.float32)


def _grad_pair(fn, jfn, inputs, argnums):
    """(value, grads) of the port's ``fn`` and JAX's ``jfn`` on ``inputs``."""
    xs = [t(a).requires_grad_(i in argnums) for i, a in enumerate(inputs)]
    value = fn(*xs)
    grads = torch.autograd.grad(value, [xs[i] for i in argnums])
    jv, jg = jax.value_and_grad(jfn, argnums=argnums)(*map(jnp.asarray, inputs))
    return (value, grads), (jv, jg)


def _check(fn, jfn, inputs, argnums, what):
    (v, g), (jv, jg) = _grad_pair(fn, jfn, inputs, argnums)
    close(v, jv, rtol=RTOL, atol=ATOL, what=f"{what} value")
    for i, (a, b) in enumerate(zip(g, jg)):
        close(a, b, rtol=1e-4, atol=1e-6, what=f"{what} grad {i}")


GROUPS = [[0, 1], [2, 3], [4, 5], [6, 7]]


def _loss_cases():
    rng = np.random.default_rng(0)
    pred = _simplex(rng, (2, 6, 6, 8))
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, (2, 6, 6))]
    trans = rng.normal(size=(8, C)).astype(np.float32)
    free = rng.normal(size=(4, C)).astype(np.float32)
    weights = rng.normal(size=(2, 6, 6, C)).astype(np.float32)
    return {
        "reduced_simplex": (lambda p, w: (mc.reduced_simplex_from_groups(p, GROUPS) * w).sum(),
                            lambda p, w: (jmc.reduced_simplex_from_groups(p, GROUPS) * w).sum(),
                            [pred, weights], (0,)),
        "multicore_kl": (lambda p, y: mc.MultiCoreKL(GROUPS)(p, y),
                         lambda p, y: jmc.MultiCoreKL(GROUPS)(p, y), [pred, onehot], (0,)),
        "adaptive_reduced_simplex": (
            lambda p, m, w: (mc.adaptive_reduced_simplex(p, m, 0.5) * w).sum(),
            lambda p, m, w: (jmc.adaptive_reduced_simplex(p, m, 0.5) * w).sum(),
            [pred, trans, weights], (0, 1)),
        "adaptive_oversegmented": (
            lambda p, y, m: mc.adaptive_oversegmented_loss(p, y, m, entropy_decay=0.1),
            lambda p, y, m: jmc.adaptive_oversegmented_loss(p, y, m, entropy_decay=0.1),
            [pred, onehot, trans], (0, 2)),
        "stricter_adaptive": (
            lambda p, y, m: mc.stricter_adaptive_loss(p, y, m, num_classes=C, mi_weight=0.1),
            lambda p, y, m: jmc.stricter_adaptive_loss(p, y, m, num_classes=C, mi_weight=0.1),
            [pred, onehot, free], (0, 2)),
        "stricter_translate_matrix": (
            lambda m, w: (mc.stricter_translate_matrix(m, C) * w).sum(),
            lambda m, w: (jmc.stricter_translate_matrix(m, C) * w).sum(),
            [free, rng.normal(size=(8, C)).astype(np.float32)], (0,)),
        "pui": (lambda x, y: pica.pui_loss(x, y, 2.0), lambda x, y: jpica.pui_loss(x, y, 2.0),
                [_simplex(rng, (20, 5)), _simplex(rng, (20, 5))], (0, 1)),
        "pui_seg": (lambda x, y: pica.pui_seg_loss(x, y, 2.0, 1),
                    lambda x, y: jpica.pui_seg_loss(x, y, 2.0, 1),
                    [_simplex(rng, (2, 6, 6, 5)), _simplex(rng, (2, 6, 6, 5))], (0, 1)),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_loss_matches_jax(name):
    fn, jfn, inputs, argnums = _loss_cases()[name]
    _check(fn, jfn, inputs, argnums, name)


def test_stricter_translate_matrix_without_free_rows():
    empty = np.zeros((0, C), np.float32)
    close(mc.stricter_translate_matrix(t(empty), C),
          jmc.stricter_translate_matrix(jnp.asarray(empty), C), rtol=0, atol=0)
    rng = np.random.default_rng(1)
    pred, onehot = _simplex(rng, (2, 4, 4, C)), np.eye(C, dtype=np.float32)[
        rng.integers(0, C, (2, 4, 4))]
    close(mc.stricter_adaptive_loss(t(pred), t(onehot), t(empty), num_classes=C, mi_weight=1.0),
          jmc.stricter_adaptive_loss(jnp.asarray(pred), jnp.asarray(onehot), jnp.asarray(empty),
                                     num_classes=C, mi_weight=1.0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [0.0, 0.25, -1.0])
def test_scale_grad_matches_jax(scale):
    x = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    xt = t(x).requires_grad_()
    out = mc.scale_grad(xt, scale)
    (g,) = torch.autograd.grad((out * t(w)).sum(), xt)
    jg = jax.grad(lambda a: (jmc.scale_grad(a, scale) * w).sum())(jnp.asarray(x))
    close(out, x, rtol=0, atol=0)
    close(g, jg, rtol=RTOL, atol=ATOL)
    close(g, scale * w, rtol=RTOL, atol=ATOL)


# --- the step and the eval -------------------------------------------------------------

def _weights(seed):
    model = UNet(max_channel=128, num_classes=C * MULT, momentum=0.1,
                 dtype=torch.float32).init_weights(torch.Generator().manual_seed(seed))
    return state_dict_to_flax(model.state_dict())


def _jbundle(tree):
    return JBundle(JUNet(max_channel=128, num_classes=C * MULT, momentum=0.1, dtype=jnp.float32),
                   jax.tree.map(jnp.asarray, tree["params"]),
                   jax.tree.map(jnp.asarray, tree["batch_stats"]), (S, S, 1))


def _port_model(tree):
    model = UNet(max_channel=128, num_classes=C * MULT, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(tree["params"], tree["batch_stats"]))
    return model


def _l2(a, b):
    a, b = n(a), n(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_groups_match_jax():
    assert prototype_groups(4, 8) == jgroups(4, 8)
    assert prototype_groups(2, 3) == [[0, 1, 2], [3, 4, 5]]


def test_multicore_steps_match_jax():
    tree = _weights(3)
    rng = np.random.default_rng(0)
    batch = {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
             "labeled_target": rng.integers(0, C, (NL, S, S)).astype(np.int32),
             "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}
    jcrit = jmc.MultiCoreKL(jgroups(C, MULT))
    jb = _jbundle(tree)
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    jhooks = jcreate_hooks({"IIDSegParameters": {"weight": 0.1}, "Data": {"name": "acdc"},
                            "Trainer": {"max_epoch": 5}})
    jstate = jinit(jb, jhooks, tx, jax.random.PRNGKey(1))
    jstep = jax.jit(jbuild(jb, tx, jhooks, raw=True, two_stage=True, mode="semi",
                           sup_criterion=jcrit, prob_transform=jcrit.reduced_simplex,
                           target_num_classes=C))
    from contrastyou_tpu_torch.hooks.midl import IIDSegmentationTrainerHook
    crit = mc.MultiCoreKL(prototype_groups(C, MULT))
    model = _port_model(tree)
    bundle = ModelBundle(model, (S, S, 1))
    hooks = [IIDSegmentationTrainerHook(hook_name="iidseg", weight=0.1)]
    opt, _ = create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    state = init_train_state(bundle, hooks, opt)
    step = build_train_step(bundle, hooks, sup_criterion=crit,
                            prob_transform=crit.reduced_simplex, target_num_classes=C)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for i in range(2):
        key = jax.random.PRNGKey(7 + i)
        k_geo, k_int, _ = jax.random.split(key, 3)
        gammas = jax.random.uniform(k_int, (NU, 1, 1, 1), minval=0.5, maxval=2.0)
        draws = StepDraws(GeoParams(*(torch.tensor(np.asarray(v))
                                      for v in sample_geo_params(k_geo, NU))),
                          t(gammas).reshape(NU), {})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           jnp.int32(1))
        m = step(state, tb, draws, 1)
        assert set(m) == set(jm)
        for k in jm:
            if k.startswith("dice"):
                # the counts of the collapsed argmax: equal from the same
                # weights; after an update, pixels at a near-tie may go
                # either way (1 of ~1000 here)
                a, b = n(m[k]), n(jm[k])
                assert a.shape == (NL, C), k
                assert np.array_equal(a, b) if i == 0 else np.abs(a - b).sum() <= 0.01 * b.sum()
            else:
                close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=f"step {i} {k}")
    got = state_dict_to_flax(model.state_dict())["params"]
    upd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(got),
                                                          jax.tree.leaves(tree["params"]))]
    jupd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(jstate.params),
                                                           jax.tree.leaves(tree["params"]))]
    assert max(_l2(a, b) for a, b in zip(upd, jupd)) <= 1e-1
    assert _l2(np.concatenate([np.ravel(a) for a in upd]),
               np.concatenate([np.ravel(a) for a in jupd])) <= 5e-2


def test_multicore_gradient_matches_jax_f64():
    """The supervised multicore KL's gradient on a labeled batch against
    JAX's in f64 (x64 on, JAX's U-Net's f32 casts promoted): 1e-3 per tensor
    (measured 2.9e-5). JAX's f32 gradient lies 4.2e-2 from its own f64 on
    Conv1's BN scales here (measured), which is why the step test above
    holds the updates to 1e-1 / 5e-2 only."""
    import types
    from contrastyou_tpu.models import unet as jax_unet
    tree = _weights(3)
    rng = np.random.default_rng(0)
    image = rng.random((NL, S, S, 1)).astype(np.float32)
    target = rng.integers(0, C, (NL, S, S))
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unet, "jnp", promoted)
        f64 = lambda tr: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tr)  # noqa: E731
        jb = JBundle(JUNet(max_channel=128, num_classes=C * MULT, momentum=0.1,
                           dtype=jnp.float64), f64(tree["params"]), f64(tree["batch_stats"]),
                     (S, S, 1))
        crit = jmc.MultiCoreKL(jgroups(C, MULT))

        def loss(p):
            (logits, _), _ = jb.apply_train(p, jb.batch_stats, jnp.asarray(image, jnp.float64))
            return crit(jax.nn.softmax(logits, -1), jax.nn.one_hot(target, C, dtype=jnp.float64))

        want = [np.asarray(g) for g in jax.tree.leaves(jax.jit(jax.grad(loss))(jb.params))]
    model = _port_model(tree)
    logits = model(t(image), train=True)[0]
    mc.MultiCoreKL(prototype_groups(C, MULT))(
        torch.softmax(logits, -1),
        torch.nn.functional.one_hot(torch.tensor(target), C).float()).backward()
    got = jax.tree.leaves(state_dict_to_flax(
        {**{k: p.grad for k, p in model.named_parameters()},
         **dict(model.named_buffers())})["params"])
    assert max(_l2(a, b) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.parametrize("tta", [False, True])
def test_eval_collapses_the_prototypes_as_jax(tta):
    tree = _weights(4)
    rng = np.random.default_rng(1)
    image = rng.random((3, S, S, 1)).astype(np.float32)
    target = rng.integers(0, C, (3, S, S)).astype(np.int32)
    mask = np.array([True, True, False])
    jcrit = jmc.MultiCoreKL(jgroups(C, MULT))
    jb = _jbundle(tree)
    jeval = jbuild_eval(jb, prob_transform=jcrit.reduced_simplex, target_num_classes=C, tta=tta)
    jout = jeval(jb.params, jb.batch_stats, jnp.asarray(image), jnp.asarray(target),
                 jnp.asarray(mask))
    crit = mc.MultiCoreKL(prototype_groups(C, MULT))
    model = _port_model(tree)
    out = build_eval_step(ModelBundle(model, (S, S, 1)), tta=tta,
                          prob_transform=crit.reduced_simplex, target_num_classes=C)(
        model, t(image), torch.tensor(target), torch.tensor(mask))
    close(out[0], jout[0], rtol=RTOL, atol=ATOL, what="loss")
    for a, b in zip(out[1:], jout[1:]):
        assert np.array_equal(n(a), n(b))
    assert out[2].shape == (3, C)


# --- configs and the loop ---------------------------------------------------------

def test_multicore_config_and_refusals():
    assert port_main.MULTICORE_CONFIG == merge(yaml_load(REPO / "config/base.yaml"),
                                               yaml_load(REPO / "config/hooks/multicore.yaml"))
    assert port_main.parse_config(["-o", "Trainer.name=multicore"]) == merge(
        port_main.MULTICORE_CONFIG, {"Trainer": {"name": "multicore"}})
    assert trainer_zoo["multicore"] is MulticoreTrainer
    assert set(trainer_zoo) == set(jtrainer_zoo)
    assert port_main.multicore_classes(port_main.MULTICORE_CONFIG, 4) == {
        "true_num_classes": 4, "multiplier": 8}
    with pytest.raises(RuntimeError, match="only 'naive'"):
        port_main.multicore_classes({"MulticoreParameters": {"name": "adaptive"}}, 4)


def jax_loop_header(cfg, tmp_path, **kwargs) -> list:
    """The ``storage.csv`` header of JAX's trainer of ``cfg`` (its model at
    max_channel 128, f32) after ``max_epoch`` x ``num_batches`` steps."""
    loaders = jget_data(cfg["Data"], cfg["LabeledLoader"], cfg["UnlabeledLoader"],
                        root_dir=package.DATA_PATH)
    trainer = jtrainer_zoo[cfg["Trainer"]["name"]](
        model=JUNet(max_channel=128, num_classes=kwargs.pop("num_classes", C),
                    momentum=0.01, dtype=jnp.float32),
        labeled_loader=loaders[0], unlabeled_loader=loaders[1], val_loader=loaders[2],
        test_loader=loaders[3], save_dir=str(tmp_path / "jax"),
        max_epoch=int(cfg["Trainer"]["max_epoch"]),
        num_batches=int(cfg["Trainer"]["num_batches"]),
        config={"Optim": cfg["Optim"], "Scheduler": cfg["Scheduler"]}, two_stage=True, seed=10,
        **kwargs)
    trainer.register_hooks(*jcreate_hooks(cfg, trainer=trainer))
    trainer.init()
    trainer.start_training()
    return (tmp_path / "jax" / "storage.csv").read_text().splitlines()[0].split(",")


SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2",
         "Trainer.num_batches=2", "Trainer.max_epoch=1", "Trainer.device=cpu",
         "Arch.max_channel=32", "MulticoreParameters.multiplier=2"]
MT_SECTION = ["+MeanTeacherParameters.weight=1", "+MeanTeacherParameters.alpha=0.99",
              "+MeanTeacherParameters.weight_decay=0.000001"]


@pytest.fixture
def layout(tmp_path, monkeypatch):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=3, num_val_scans=2,
                         slices_per_scan=4, size=48)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


@pytest.mark.parametrize("extra", [["+IIDSegParameters.weight=0.01"], MT_SECTION],
                         ids=["multicore", "multicore_mt"])
def test_multicore_loop_writes_jax_columns_and_resumes(extra, layout, tmp_path):
    argv = ["-o", "Trainer.name=multicore", "Trainer.save_dir=mc", *SMALL, *extra]
    assert port_main.main(argv) == 0
    run = layout / "mc"
    for f in (".success", "inference_result.json", "last/train_state.pt", "config.yaml"):
        assert (run / f).exists(), f
    lines = (run / "storage.csv").read_text().splitlines()
    header = lines[0].split(",")
    assert len(lines) == 2 and "tra/tra/sup_dice/DSC3" in header
    assert "tra/tra/sup_dice/DSC4" not in header
    state = torch.load(run / "last/train_state.pt", weights_only=True)
    assert state["model"]["_Deconv_1x1.weight"].shape[0] == C * 2
    if extra is MT_SECTION:
        assert state["hook_states"]["mt"]["teacher_params"]["_Deconv_1x1.weight"].shape[0] == 8
    assert port_main.main([*argv, "Trainer.max_epoch=2"]) == 0
    assert len((run / "storage.csv").read_text().splitlines()) == 3
    cfg = port_main.parse_config(argv)
    assert header == jax_loop_header(cfg, tmp_path, num_classes=C * 2, true_num_classes=C,
                                     multiplier=2)
