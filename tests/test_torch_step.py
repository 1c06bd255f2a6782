"""One full ``semi`` + consistency train step of the port
(contrastyou_tpu_torch/engine/steps.py) held against JAX
``build_train_step(..., raw=True)`` on the same batch, weights and draws, the
same with the ``udaiic`` hooks (IIC on Conv5 and Up_conv2 with their cluster
heads, plus consistency), plus the port's device cache, config loader, hook
factory and import hygiene.

The JAX step draws its GeoParams and gammas from its key
(steps.py ``jax.random.split(rng, 3)``, affine.py ``apply_gamma``); the test
replays those splits and hands the draws to the port as tensors.

Tolerances (f32): losses rtol 1e-4 (the same sums in another order through
the U-Net); BN running statistics 1e-3 of the largest value; dice counts may
differ by a pixel per class where two logits tie to f32 precision. The
parameter updates (an unrectified first RAdam step, -lr * (grad + wd *
param)) are read back as differences of f32 parameters: a BN scale near 1.0
quantizes its ~1e-6 update to ulp(1) = 1.2e-7, and the consistency gradient
is a difference of two nearly equal softmaxes, so they are compared in L2,
per tensor at 3e-2 (measured worst 2.0%, BN scales) and over all parameters
together at 2e-2 (measured 1.3%, dominated by the same BN updates). The
udaiic step keeps these bounds for the model and its cluster heads (whose
first update is -lr * (grad + wd * param) as well).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.hooks.creator import create_discrete_mi_consistency_hooks as jcreate_dmi
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch.configure.config import ConfigParser, merge, parse_value, yaml_load
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_train_step,
                                                init_train_state, sample_step_draws)
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.creator import (UNPORTED_SECTIONS,
                                                 create_discrete_mi_consistency_hooks,
                                                 create_hook_from_config)
from contrastyou_tpu_torch.main import (MAIN_PATH_CONFIG, UDAIIC_CONFIG, build_pretrain_run,
                                        build_semi_run, parse_config)
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops import convblock as cb
from contrastyou_tpu_torch.ops import iic
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import (cluster_head_state_dict_to_flax,
                                                        flax_to_cluster_head_state_dict,
                                                        flax_to_state_dict, state_dict_to_flax)
from torch_parity import close, n, scaled_close, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NL, NU, S = 2, 2, 32
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (NL, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}


def _jax_step(batch, key, hooks=None):
    bundle = JBundle.create(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                            jax.random.PRNGKey(0), (S, S, 1))
    hooks = hooks or [JConsistency(weight=10.0)]
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
    before = jax.tree.map(np.asarray, (state.params, state.batch_stats, state.hook_params))
    step = jax.jit(jbuild(bundle, tx, hooks, raw=True, two_stage=True, mode="semi"))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.int32(0))
    return before, new, jax.tree.map(np.asarray, metrics)


def _replayed_draws(key):
    k_geo, k_int, _ = jax.random.split(key, 3)
    geo = sample_geo_params(k_geo, NU)
    gammas = jax.random.uniform(k_int, (NU, 1, 1, 1), minval=0.5, maxval=2.0)
    return StepDraws(GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                     t(gammas).reshape(NU))


def _port_state(params, stats):
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    bundle = ModelBundle(model, (S, S, 1))
    hooks = [ConsistencyTrainerHook(weight=10.0)]
    opt, _ = create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75,
                              steps_per_epoch=200)
    return bundle, hooks, init_train_state(bundle, hooks, opt)


def test_semi_step_matches_jax():
    batch = _batch()
    key = jax.random.PRNGKey(7)
    (params, stats, _), jnew, jm = _jax_step(batch, key)
    bundle, hooks, state = _port_state(params, stats)
    step = build_train_step(bundle, hooks)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    m = step(state, tb, _replayed_draws(key))

    for k in ("sup_loss", "reg_loss", "total_loss", "consistency/loss"):
        close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=k)
    for k in ("dice_inter", "dice_union"):
        assert np.abs(n(m[k]) - jm[k]).max() <= 1, k
    assert state.step == 1
    new = state_dict_to_flax(state.model.state_dict())
    upd = jax.tree.map(lambda a, b: a - b, new["params"], params)
    jupd = jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.params, params)
    _check_updates(upd, jupd)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jax.tree.map(np.asarray, jnew.batch_stats))):
        scaled_close(a, b, tol=1e-3, what=f"stats {jax.tree_util.keystr(path)}")


def _check_updates(upd, jupd, what="update"):
    """Per tensor L2 <= 3e-2, all tensors together <= 2e-2."""
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(upd)[0],
                            jax.tree.leaves(jupd)):
        assert _l2(a, b) <= 3e-2, f"{what} {jax.tree_util.keystr(path)}: {_l2(a, b):.3e}"
    assert _l2(*(np.concatenate([np.ravel(v) for v in jax.tree.leaves(u)])
                 for u in (upd, jupd))) <= 2e-2, what


#: config/hooks/udaiic.yaml's DiscreteMIConsistencyParams
UDAIIC_HOOKS = UDAIIC_CONFIG["DiscreteMIConsistencyParams"]


def test_udaiic_semi_step_matches_jax():
    """The semi step with the udaiic hooks: JAX's factory order
    (discreteMI/conv5, discreteMI/up_conv2 at padding 1, consistency), the
    cluster heads carried over by the bridge and optimized beside the model.
    JAX's dense hook takes its CPU default (the merged XLA form), the port's
    the plain E1/E2."""
    batch = _batch()
    key = jax.random.PRNGKey(7)
    jhooks = jcreate_dmi(**UDAIIC_HOOKS)
    (params, stats, hparams), jnew, jm = _jax_step(batch, key, jhooks)
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    hooks = create_discrete_mi_consistency_hooks(channel_dim=model.get_channel_dim,
                                                 **UDAIIC_HOOKS)
    assert [h.name for h in hooks] == [h.name for h in jhooks]
    heads = hooks[:2]
    for h in heads:
        h.projector.load_state_dict(flax_to_cluster_head_state_dict(hparams[h.name]))
    opt, _ = create_optimizer(list(model.parameters()) + hook_parameters(hooks), OPTIM, SCHED,
                              max_epoch=75, steps_per_epoch=200)
    bundle = ModelBundle(model, (S, S, 1))
    state = init_train_state(bundle, hooks, opt)
    m = build_train_step(bundle, hooks)(state, {k: torch.tensor(v) for k, v in batch.items()},
                                        _replayed_draws(key))

    assert set(jm) <= set(m) | {"dice_inter", "dice_union"}
    for k in jm:
        if not k.startswith("dice"):
            close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=k)
    new = state_dict_to_flax(state.model.state_dict())
    _check_updates(jax.tree.map(lambda a, b: a - b, new["params"], params),
                   jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.params, params))
    for h in heads:
        dense = h.name.endswith("up_conv2")
        got = cluster_head_state_dict_to_flax(h.projector.state_dict(), dense=dense)
        _check_updates(jax.tree.map(lambda a, b: a - b, got, hparams[h.name]),
                       jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.hook_params[h.name],
                                    hparams[h.name]), what=f"update {h.name}")


def _l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_disable_bn_keeps_unlabeled_pass_out_of_running_stats():
    """disable_bn: only the labeled pass updates the running statistics —
    the same update as a lone labeled train-mode forward."""
    batch = _batch()
    v = JUNet(max_channel=128).init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 1)),
                                    train=False)
    params, stats = (jax.tree.map(np.asarray, v[k]) for k in ("params", "batch_stats"))
    bundle, hooks, state = _port_state(params, stats)
    step = build_train_step(bundle, hooks, disable_bn=True)
    step(state, {k: torch.tensor(v) for k, v in batch.items()},
         _replayed_draws(jax.random.PRNGKey(3)))
    ref = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    ref.load_state_dict(flax_to_state_dict(params, stats))
    ref(torch.tensor(batch["labeled_image"]), train=True)
    for k, v in ref.state_dict().items():
        if "running" in k:
            close(state.model.state_dict()[k], v, rtol=1e-6, atol=1e-7, what=k)


def test_device_cache_crop_matches_jax():
    from contrastyou_tpu.data.device_cache import _crop_slices
    rng = np.random.default_rng(1)
    imgs = rng.random((6, 20, 24)).astype(np.float32)
    tgts = rng.integers(0, 4, (6, 20, 24))
    idx, oy, ox = np.array([5, 0, 3]), np.array([0, 4, 2]), np.array([8, 0, 3])
    cache = DeviceDataCache.from_arrays(imgs, tgts, crop=16, device="cpu",
                                        scan_id=np.arange(6) % 2)
    got = cache.sample_at(torch.tensor(idx), torch.tensor(oy), torch.tensor(ox))
    ri, rt = _crop_slices(jnp.asarray(imgs)[idx], jnp.asarray(tgts)[idx],
                          jnp.asarray(oy), jnp.asarray(ox), 16)
    np.testing.assert_array_equal(n(got["image"][..., 0]), np.asarray(ri))
    np.testing.assert_array_equal(got["target"].numpy(), np.asarray(rt))
    np.testing.assert_array_equal(got["scan_id"].numpy(), idx % 2)
    i2, y2, x2 = cache.draw(torch.Generator().manual_seed(0), 64)
    assert int(i2.max()) < 6 and int(y2.max()) <= 4 and int(x2.max()) <= 8


def test_cached_step_is_the_step_on_the_sampled_batch():
    """build_cached_train_step == build_train_step on the batch and draws the
    same generator state yields."""
    def run():
        return build_semi_run(MAIN_PATH_CONFIG, device=torch.device("cpu"),
                              dtype=torch.float32, raw_size=40, crop=32, n_slices=8,
                              max_channel=128)

    a, b = run(), run()
    ma = a.step(a.state, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    lab, unl = b.labeled_cache.sample(g, 5), b.unlabeled_cache.sample(g, 5)
    step = build_train_step(ModelBundle(b.state.model, (32, 32, 1)),
                            [ConsistencyTrainerHook(weight=10.0)])
    mb = step(b.state, {"labeled_image": lab["image"], "labeled_target": lab["target"],
                        "unlabeled_image": unl["image"]}, sample_step_draws(g, 5))
    for k in ("sup_loss", "reg_loss", "dice_inter"):
        np.testing.assert_array_equal(n(ma[k]), n(mb[k]))
    np.testing.assert_array_equal(ma["labeled_scan_id"].numpy(), lab["scan_id"].numpy())


def test_package_never_imports_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import contrastyou_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'contrastyou_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'contrastyou_tpu' or m.startswith('contrastyou_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("config,hook_file", [(MAIN_PATH_CONFIG, "consistency.yaml"),
                                              (UDAIIC_CONFIG, "udaiic.yaml")])
def test_main_path_config_equals_the_yaml_files(config, hook_file):
    cfg = merge(yaml_load(REPO / "config/base.yaml"),
                yaml_load(REPO / "config/hooks" / hook_file))
    assert config == cfg
    parsed = ConfigParser().parse(["-p", str(REPO / "config/base.yaml"),
                                   str(REPO / "config/hooks" / hook_file),
                                   "-o", "Trainer.name=semi", "Optim.lr=1e-3"])
    assert parsed["Trainer"]["name"] == "semi" and parsed["Optim"]["lr"] == 1e-3
    assert ConfigParser(config).parse([])["Arch"] == cfg["Arch"]


#: the udaiic run from the in-code semi base, as written in the README
UDAIIC_OVERRIDES = ["Trainer.name=semi", "~ConsistencyParameters",
                    "+DiscreteMIConsistencyParams.feature_names=[Conv5,Up_conv2]",
                    "+DiscreteMIConsistencyParams.mi_weights=[0.1,0.05]",
                    "+DiscreteMIConsistencyParams.dense_paddings=[1]",
                    "+DiscreteMIConsistencyParams.consistency_weight=1"]


def test_udaiic_override_form_equals_the_config():
    got = parse_config(["-o", *UDAIIC_OVERRIDES])
    assert got == merge(UDAIIC_CONFIG, {"Trainer": {"name": "semi"}})


@pytest.mark.parametrize("section", ["MeanTeacherParameters", "EntropyMinParameters",
                                     "SPInfonceParams", "FeatureCrossCorrelationParameters"])
def test_unported_hook_sections_raise(section):
    """A hook section without a port fails the run instead of training
    without it, in semi and in pretraining."""
    with pytest.raises(NotImplementedError, match=section):
        build_semi_run(merge(MAIN_PATH_CONFIG, {section: {"weight": 1.0}}), device="cpu",
                       dtype=torch.float32, raw_size=40, crop=32, n_slices=8, max_channel=128)
    cfg = parse_config(["-o", "Trainer.name=pretrain", f"+{section}.weight=1"])
    with pytest.raises(NotImplementedError, match=section):
        build_pretrain_run(cfg, device="cpu", dtype=torch.float32, raw_size=36, crop=32,
                           n_scans=6, max_channel=128)
    assert section in UNPORTED_SECTIONS or "CrossCorrelation" in section


def test_discrete_mi_under_pretraining_raises():
    cfg = merge(parse_config(["-o", "Trainer.name=pretrain"]),
                {"DiscreteMIConsistencyParams": UDAIIC_HOOKS})
    with pytest.raises(RuntimeError, match="DiscreteMIConsistencyParams"):
        create_hook_from_config(cfg, channel_dim=UNet(max_channel=128).get_channel_dim,
                                is_pretrain=True)
    with pytest.raises(RuntimeError, match="DiscreteMIConsistencyParams"):
        build_pretrain_run(cfg, device="cpu", dtype=torch.float32, raw_size=36, crop=32,
                           n_scans=6, max_channel=128)


def test_semi_takes_the_class_count_of_the_dataset():
    """``-o Data.name=prostate`` trains 2 classes (model and synthetic
    split), as JAX does; ACDC keeps 4."""
    for name, classes in (("prostate", 2), ("acdc", 4)):
        run = build_semi_run(parse_config(["-o", "Trainer.name=semi", f"Data.name={name}"]),
                             device="cpu", dtype=torch.float32, raw_size=40, crop=32,
                             n_slices=8, max_channel=128)
        assert run.state.model._Deconv_1x1.out_channels == classes
        targets = torch.cat([run.labeled_cache.targets, run.unlabeled_cache.targets])
        assert int(targets.max()) == classes - 1
        m = run.step(run.state, run.generator)
        assert m["dice_inter"].shape[-1] == classes


def _counting(monkeypatch, module, names):
    """Count the calls of ``module``'s wrappers ``names`` (plain on the CPU)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrapper(*a, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)
    return calls


def test_udaiic_run_takes_one_e1_e2_pair_per_step_beside_the_semi_convs(monkeypatch):
    """build_semi_run(UDAIIC_CONFIG): hooks in JAX order, their heads in the
    optimizer, one E1 and one E2 call per step, the conv kernels called as
    on the consistency-only semi path, finite losses, heads updated."""
    conv = _counting(monkeypatch, cb, ("conv3x3_stats", "upconv3x3_stats", "upconv3x3_dx",
                                       "conv_dw_taps", "conv3x3_bwd_fused"))
    joints = _counting(monkeypatch, iic, ("iic_joints", "iic_joints_bwd"))
    kw = dict(device="cpu", dtype=torch.float32, raw_size=40, crop=32, n_slices=8,
              max_channel=128)
    semi = build_semi_run(MAIN_PATH_CONFIG, **kw)
    semi.step(semi.state, semi.generator)
    semi_calls = dict(conv)
    assert joints == {"iic_joints": 0, "iic_joints_bwd": 0}
    for k in conv:
        conv[k] = 0
    run = build_semi_run(UDAIIC_CONFIG, **kw)
    assert [h.name for h in run.hooks] == ["discreteMI/conv5", "discreteMI/up_conv2",
                                           "consistency"]
    heads = {f"{h.name}/bias": h.projector.bias.detach().clone() for h in run.hooks[:2]}
    params = {id(p) for g in run.state.optimizer.param_groups for p in g["params"]}
    assert all(id(p) in params for p in hook_parameters(run.hooks))
    m = run.step(run.state, run.generator)
    assert conv == semi_calls and joints == {"iic_joints": 1, "iic_joints_bwd": 1}
    for k in ("discreteMI/conv5/loss", "discreteMI/up_conv2/loss", "consistency/loss"):
        assert np.isfinite(float(m[k])), k
    # at the preset's lr (1e-7 in warm-up) a weight's step is below its f32
    # resolution, so the zero-initialized biases show the update
    for h in run.hooks[:2]:
        assert not torch.equal(heads[f"{h.name}/bias"], h.projector.bias), h.name


@pytest.mark.parametrize("raw", ["1", "-2", "1e-3", "0.5", "true", "False", "null",
                                 "abc", "[1, 2]", "'quoted'", "semi"])
def test_override_values_parse_like_yaml(raw):
    import yaml
    assert parse_value(raw) == yaml.safe_load(raw) or (
        raw == "1e-3" and parse_value(raw) == 1e-3)


def test_profile_step_builds_the_overridden_semi_run():
    """``profile_step semi -o ...`` profiles the run the overrides describe
    (class count, hook weights), and ``--udaiic`` the udaiic hooks."""
    from contrastyou_tpu_torch import profile_step
    size = dict(dtype=torch.float32, raw_size=40, crop=32, n_slices=8, max_channel=128)
    run = profile_step._build("semi", "cpu", ["Data.name=prostate",
                                              "ConsistencyParameters.weight=2"], **size)
    assert run.state.model._Deconv_1x1.out_channels == 2
    assert [(h.name, h.weight) for h in run.hooks] == [("consistency", 2.0)]
    run = profile_step._build("semi", "cpu", ["Data.name=prostate"], udaiic=True, **size)
    assert run.state.model._Deconv_1x1.out_channels == 2
    assert [(h.name, h.weight) for h in run.hooks] == [
        ("discreteMI/conv5", 0.1), ("discreteMI/up_conv2", 0.05), ("consistency", 1.0)]
