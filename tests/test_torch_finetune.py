"""Fine-tuning and warm starts of the port (contrastyou_tpu_torch/engine/
steps.py mode ``ft``, trainers/ft.py, engine/checkpoint.py
``extract_model_params``, utils/torch_convert.py ``merge_pretrained``)
held against the JAX package.

- One ``ft`` step (max_channel 128, 32 x 32, f32) against JAX
  ``build_train_step(mode="ft")`` on the same weights (through the bridge)
  and batch: losses rtol 1e-5; dice counts within a pixel per class (f32
  near-ties); gradients (recorded by a wrapper around the JAX optimizer) and
  the first RAdam update at lr 0.1 in L2, per tensor 5e-2 and together
  2e-2, the bounds and reasons of tests/test_torch_pretrain.py (the
  train-mode BN backward at a batch of 2 cancels terms far larger than its
  result); BN running statistics 1e-4 of the largest value. The cached
  ``ft`` step draws the labeled sample alone from its generator.
- ``FineTuneTrainer`` drops the config's hooks: no head parameter in the
  optimizer, no hook state, no unlabeled batch read.
- ``extract_model_params``: the same parameters as JAX's from the same
  weights, bit for bit; BN statistics, the optimizer and RAdam's count stay
  fresh; a JAX checkpoint is refused by name.
- ``merge_pretrained`` / ``Trainer.load_pretrained``: on an encoder-only
  archive written by JAX ``save_npz_tree`` with one leaf of another shape,
  the same loaded and skipped paths as JAX's and the same tensors, bit for
  bit.
- The class-count case: JAX restores a 4-class checkpoint's
  ``Deconv_1x1`` into a 2-class template and its train step then raises
  ``ScopeParamShapeError``; the port raises at load, naming
  ``_Deconv_1x1.weight``, before anything trains.
"""
import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.checkpoint import extract_model_params as jextract
from contrastyou_tpu.engine.checkpoint import save_checkpoint as jsave
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.trainers import FineTuneTrainer as JFineTuneTrainer
from contrastyou_tpu.utils.torch_convert import load_npz_tree as jload_npz
from contrastyou_tpu.utils.torch_convert import merge_pretrained as jmerge
from contrastyou_tpu.utils.torch_convert import save_npz_tree as jsave_npz
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.data.creator import get_data
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.checkpoint import (extract_model_params, save_checkpoint,
                                                     train_state_dict)
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (build_cached_train_step, build_train_step,
                                                init_train_state)
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.creator import create_infonce_hooks
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.trainers.ft import FineTuneTrainer
from contrastyou_tpu_torch.trainers.semi import SemiTrainer
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_state_dict, load_pretrained,
                                                        state_dict_to_flax)
from test_torch_pretrain import HOOKS, L2_TOL, OPTIM, SCHED, _check_l2, _recording
from torch_parity import close, scaled_close

torch.set_num_threads(1)

NL, S = 2, 32
SEED = 10


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    synthesize_acdc_like(root, num_train_scans=3, num_val_scans=2, slices_per_scan=4, size=64)
    return root


@pytest.fixture
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(package, "DATA_PATH", str(data_root))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def _jax_state(seed=0, num_classes=4, tx=None):
    """A JAX bundle and train state on the port's initial weights of
    ``seed`` (flax's own init of this U-Net takes ~20 s to trace on the CPU)."""
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32,
                 num_classes=num_classes).init_weights(torch.Generator().manual_seed(seed))
    flax = jax.tree.map(jnp.asarray, state_dict_to_flax(model.state_dict()))
    bundle = JBundle(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32,
                           num_classes=num_classes), flax["params"], flax["batch_stats"],
                     (S, S, 1))
    tx = tx or jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)[0]
    return bundle, tx, jinit(bundle, [], tx, jax.random.PRNGKey(1))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(params, stats, num_classes=4, max_channel=128):
    model = UNet(max_channel=max_channel, momentum=0.1, dtype=torch.float32,
                 num_classes=num_classes)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model


def _optimizer(model):
    return create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75,
                            steps_per_epoch=200)[0]


def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (NL, S, S)).astype(np.int32)}


# --- the ft step ----------------------------------------------------------------

def test_ft_step_matches_jax():
    bundle, tx, state = _jax_state(tx=_recording(jcreate(OPTIM, SCHED, max_epoch=75,
                                                         steps_per_epoch=200)[0]))
    params, stats = _numpy(state.params), _numpy(state.batch_stats)
    batch = _batch()
    step = jax.jit(jbuild(bundle, tx, [], raw=True, two_stage=True, mode="ft"))
    jnew, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(7), jnp.int32(0))
    jnew, jm = _numpy(jnew), _numpy(jm)

    model = _port_model(params, stats)
    pbundle = ModelBundle(model, (S, S, 1))
    pstate = init_train_state(pbundle, [], _optimizer(model))
    m = build_train_step(pbundle, [], mode="ft")(
        pstate, {k: torch.tensor(v) for k, v in batch.items()}, None)

    assert set(m) == set(jm)
    for k in ("sup_loss", "reg_loss", "total_loss"):
        close(m[k], jm[k], rtol=1e-5, atol=0, what=k)
    for k in ("dice_inter", "dice_union"):
        assert np.abs(m[k].numpy() - jm[k]).max() <= 1, k
    assert pstate.step == 1 and pstate.optimizer.count == 1
    grads = state_dict_to_flax({k: p.grad if isinstance(p, torch.nn.Parameter) else p
                                for k, p in model.state_dict(keep_vars=True).items()})
    jgrads = jnew.opt_state["grads"][0]
    flat = jax.tree_util.tree_flatten_with_path
    _check_l2([(jax.tree_util.keystr(p), g, jg) for (p, g), jg in zip(
        flat(grads["params"])[0], jax.tree.leaves(jgrads))], "grad")
    new = state_dict_to_flax(model.state_dict())
    _check_l2([(jax.tree_util.keystr(p), a - b0, b - b0) for (p, a), b, b0 in zip(
        flat(new["params"])[0], jax.tree.leaves(jnew.params), jax.tree.leaves(params))],
        "update", L2_TOL)
    for (p, a), b in zip(flat(new["batch_stats"])[0], jax.tree.leaves(jnew.batch_stats)):
        scaled_close(a, b, tol=1e-4, what=f"stats {jax.tree_util.keystr(p)}")


def test_ft_cached_step_samples_the_labeled_cache_only():
    """No unlabeled sample and no geometric or gamma draws: the generator
    moves exactly as far as the labeled sample takes it."""
    from contrastyou_tpu_torch.main import synthetic_split
    images, targets = synthetic_split(4, 40, seed=1)
    cache = DeviceDataCache.from_arrays(images, targets, crop=S, device="cpu")
    model = UNet(max_channel=32, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))
    bundle = ModelBundle(model, (S, S, 1))
    state = init_train_state(bundle, [], _optimizer(model))
    step = build_cached_train_step(bundle, [], labeled_cache=cache, labeled_batch=NL)
    gen, twin = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    m = step(state, gen)
    lab = cache.sample(twin, NL)
    assert torch.equal(gen.get_state(), twin.get_state())
    assert torch.equal(m["labeled_scan_id"], lab["scan_id"])
    assert np.isfinite(float(m["total_loss"])) and float(m["reg_loss"]) == 0.0


# --- FineTuneTrainer --------------------------------------------------------------

def _trainer(cls, root, tmp_path, *, max_channel=32, num_classes=4, seed=5, **kw):
    loaders = get_data({"name": "acdc", "labeled_scan_num": 1}, {"batch_size": NL},
                       {"batch_size": NL}, root_dir=str(root))
    model = UNet(max_channel=max_channel, momentum=0.01, dtype=torch.float32,
                 num_classes=num_classes).init_weights(torch.Generator().manual_seed(seed))
    return cls(model=model, labeled_loader=loaders[0], unlabeled_loader=loaders[1],
               val_loader=loaders[2], test_loader=loaders[3], save_dir=str(tmp_path / "run"),
               max_epoch=1, num_batches=1, config={"Optim": OPTIM, "Scheduler": SCHED},
               seed=SEED, **kw)


def test_fine_tune_trainer_drops_the_hooks(data_root, tmp_path):
    assert (FineTuneTrainer.train_mode, FineTuneTrainer.activate_hooks) == (
        JFineTuneTrainer.train_mode, JFineTuneTrainer.activate_hooks) == ("ft", False)
    runs = {}
    for cls in (SemiTrainer, FineTuneTrainer):
        trainer = _trainer(cls, data_root, tmp_path / cls.__name__)
        hooks = create_infonce_hooks(channel_dim=trainer._model.get_channel_dim,
                                     **HOOKS["pretrain_decoder"])
        trainer.register_hooks(*hooks, ConsistencyTrainerHook(weight=1.0))
        trainer.init()
        params = {id(p) for g in trainer._state.optimizer.param_groups for p in g["params"]}
        heads = {id(p) for h in hooks for p in h.parameters()}
        runs[cls] = trainer, params, heads
    semi, ft = runs[SemiTrainer], runs[FineTuneTrainer]
    assert semi[2] <= semi[1]
    trainer, params, heads = ft
    assert params == {id(p) for p in trainer._model.parameters()} and not params & heads
    assert trainer._state.hook_states == {} and trainer._active_hooks == []
    stats = trainer.tra_epoch(0)
    assert trainer._unlabeled_iter is None and set(stats) == {"tra"}
    assert np.isfinite(stats["tra"]["sup_loss"]) and stats["tra"]["reg_loss"] == 0.0


# --- extract_model_params ------------------------------------------------------------

def _port_checkpoint(path, model):
    """``model`` after one ft step (moved BN statistics and optimizer state),
    written as the trainer writes a checkpoint."""
    bundle = ModelBundle(model, (S, S, 1))
    state = init_train_state(bundle, [], _optimizer(model))
    build_train_step(bundle, [], mode="ft")(
        state, {k: torch.tensor(v) for k, v in _batch().items()}, None)
    save_checkpoint(path, train_state=train_state_dict(state, []), host_state={})
    return model.state_dict()


def test_extract_model_params_matches_jax(data_root, tmp_path):
    _, _, jstate = _jax_state(seed=0)
    saved = _port_checkpoint(tmp_path / "port",
                             _port_model(_numpy(jstate.params), _numpy(jstate.batch_stats)))
    flax = state_dict_to_flax(saved)
    jsave(tmp_path / "jax", train_state=jstate.replace(
        params=jax.tree.map(jnp.asarray, flax["params"]),
        batch_stats=jax.tree.map(jnp.asarray, flax["batch_stats"])), host_state={})
    _, _, template = _jax_state(seed=5)
    restored = _numpy(jextract(tmp_path / "jax", template.params))

    trainer = _trainer(FineTuneTrainer, data_root, tmp_path, max_channel=128)
    fresh = {k: v.clone() for k, v in trainer._model.state_dict().items()}
    trainer.init()
    trainer.load_model_params(extract_model_params(tmp_path / "port", trainer._model))
    got = trainer._model.state_dict()
    for k, p in trainer._model.named_parameters():
        assert torch.equal(p, saved[k]), k
    for k, b in trainer._model.named_buffers():
        assert torch.equal(b, fresh[k]) and not torch.equal(b, saved[k]), k
    for a, b in zip(jax.tree.leaves(state_dict_to_flax(got)["params"]),
                    jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, b)
    opt = trainer._state.optimizer
    assert not opt.state and opt.count == 0 and trainer._state.step == 0
    with pytest.raises(ValueError, match="train_state.msgpack"):
        extract_model_params(tmp_path / "jax", trainer._model)


# --- merge_pretrained -----------------------------------------------------------------

ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")


def test_merge_pretrained_matches_jax(data_root, tmp_path):
    """An encoder-only archive (another init, drawn BN statistics) with
    ``Conv3/conv0/kernel`` one output channel short: every other encoder
    leaf loads, that one is skipped, the decoder keeps its values."""
    _, _, jstate = _jax_state(seed=0)
    params, stats = _numpy(jstate.params), _numpy(jstate.batch_stats)
    _, _, other = _jax_state(seed=3)
    rng = np.random.default_rng(2)
    archive = {"params": {k: _numpy(other.params[k]) for k in ENCODER},
               "batch_stats": jax.tree.map(
                   lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                   {k: _numpy(other.batch_stats[k]) for k in ENCODER})}
    kernel = archive["params"]["Conv3"]["conv0"]["kernel"]
    archive["params"]["Conv3"]["conv0"]["kernel"] = kernel[..., :-1]
    path = str(tmp_path / "encoder.npz")
    jsave_npz(path, archive)
    tree = jload_npz(path)
    jp, jlo_p, jsk_p = jmerge(params, tree["params"])
    js, jlo_s, jsk_s = jmerge(stats, tree["batch_stats"])

    loaded, skipped = load_pretrained(_port_model(params, stats), path)
    assert loaded == jlo_p + jlo_s and skipped == jsk_p + jsk_s == ["Conv3/conv0/kernel"]
    assert len(jlo_p) == 29 and len(jlo_s) == 20 and not any(p.startswith("Up") for p in loaded)

    trainer = _trainer(FineTuneTrainer, data_root, tmp_path, max_channel=128)
    trainer._model.load_state_dict(flax_to_state_dict(params, stats))
    trainer.load_pretrained(path)
    trainer.init()
    got = state_dict_to_flax(trainer._model.state_dict())
    for ours, ref in ((got["params"], jp), (got["batch_stats"], js)):
        for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(ours)[0],
                             jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    assert not trainer._state.optimizer.state and trainer._state.optimizer.count == 0


# --- the class-count mismatch -----------------------------------------------------------

def test_class_count_mismatch_raises_as_jax(paths, tmp_path):
    """A 4-class checkpoint into a 2-class model (``acdc`` -> ``acdc_lv``)."""
    _, _, four = _jax_state(num_classes=4)
    jsave(tmp_path / "jax4", train_state=four, host_state={})
    bundle, tx, two = _jax_state(num_classes=2)
    restored = jextract(tmp_path / "jax4", two.params)
    assert restored["Deconv_1x1"]["kernel"].shape == (1, 1, 8, 4)
    step = jax.jit(jbuild(bundle, tx, [], raw=True, two_stage=True, mode="ft"))
    batch = {k: jnp.asarray(v % 2 if k == "labeled_target" else v) for k, v in _batch().items()}
    with pytest.raises(flax.errors.ScopeParamShapeError, match="Deconv_1x1"):
        step(two.replace(params=restored), batch, jax.random.PRNGKey(7), jnp.int32(0))

    cfg = port_main.parse_config(["-o", "Trainer.name=semi", "Trainer.device=cpu",
                                  "Arch.max_channel=32"])
    model4 = port_main._model(cfg, "cpu", torch.float32, None, torch.Generator(), 4)
    save_checkpoint(tmp_path / "port4", host_state={},
                    train_state={"model": model4.state_dict()})
    model2 = port_main._model(cfg, "cpu", torch.float32, None, torch.Generator(), 2)
    with pytest.raises(ValueError, match=r"_Deconv_1x1\.weight"):
        extract_model_params(tmp_path / "port4", model2)
    argv = ["-o", "Trainer.name=ft", "Data.name=acdc_lv", "Trainer.device=cpu",
            "Arch.max_channel=32", f"Arch.checkpoint={tmp_path / 'port4'}",
            "Trainer.save_dir=lv"]
    with pytest.raises(ValueError, match=r"_Deconv_1x1\.weight"):
        port_main.main(argv)
    assert not (paths / "lv" / "last").exists() and not (paths / "lv" / "storage.csv").exists()
