"""MixUp in the port (contrastyou_tpu_torch/hooks/mixup.py, trainers/mixup.py,
the ``ft`` step's hook draws in engine/steps.py and engine/trainer.py, the
``mixup`` base of main.py) held against the JAX package on the CPU.

JAX's hook splits ``ctx.rng`` into ``k_geo``, ``k_mix`` and ``k_mix`` into
``k_lam``, ``k_perm``; ``ctx.rng`` is the whole step key under ``ft``
(``Trainer.name=mixup``) and ``k_hook`` = ``split(key, 3)[2]`` under
``semi``. The tests replay those splits and hand the draws to the port.

- The hook's loss and its gradient w.r.t. the model's parameters on both
  keys, against JAX run op by op in f32 and, as the tighter witness, the
  same JAX code run in f64 (bounds and why in the test).
- The mixed forward leaves the BN running statistics bit-unchanged, and a
  step with the hook ends with the statistics of the step without it.
- One ``MixUpTrainer`` (``ft``) step and one ``semi`` step with the hook
  against JAX's, with tests/test_torch_step.py's bounds.
- A plain ``ft`` run draws nothing: its generators and metrics are those of
  the step without draws.
- ``main.main`` with ``-o Trainer.name=mixup``: ``storage.csv``'s header
  equals JAX's ``MixUpTrainer``'s on the same layout; ``MIXUP_CONFIG``
  equals config/base.yaml + config/hooks/mixup.yaml.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.data import get_data as jget_data
import contrastyou_tpu.hooks.mixup as jax_mixup
import contrastyou_tpu.models.unet as jax_unet
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine.hooks import StepContext as JContext
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.hooks.mixup import MixUpTrainHook as JMixUp
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu.trainers import trainer_zoo as jtrainer_zoo
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_cached_train_step,
                                                build_train_step, sample_ft_draws)
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.hooks.mixup import MixUpTrainHook
from contrastyou_tpu_torch.hooks.mt import EMAEvalTrainerHook
from contrastyou_tpu_torch.main import MIXUP_CONFIG
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.trainers import MixUpTrainer, trainer_zoo
from contrastyou_tpu_torch.utils.torch_convert import state_dict_to_flax
from test_torch_mt_loop import fast_jax_bundle  # noqa: F401 (a fixture)
from test_torch_simple_hooks import (MAXC, NL, S, batch, check_metrics, check_model, jax_step,
                                     l2, port_model, port_state, replayed_draws, simple_config)
from torch_parity import close

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MIXUP = {"MixUpParams": {"weight": 0.1, "enable_bn": True}}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def jax_mixup_draws(rng, nl, alpha=1.0):
    """The port's ``(geo, lam, perm)`` of JAX's hook on ``ctx.rng``."""
    k_geo, k_mix = jax.random.split(rng)
    geo = sample_geo_params(k_geo, nl)
    k_lam, k_perm = jax.random.split(k_mix)
    lam = float(np.asarray(jax.random.beta(k_lam, alpha, alpha)))
    perm = tuple(int(i) for i in np.asarray(jax.random.permutation(k_perm, 2 * nl)))
    return GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)), lam, perm


def _hook_rng(key, mode):
    return key if mode == "ft" else jax.random.split(key, 3)[2]


def _port_hook_grads(model, b, draws):
    """(loss, gradient leaves in flax order) of the port's hook (f32)."""
    ctx = StepContext(labeled_image=torch.tensor(b["labeled_image"]),
                      labeled_target=torch.tensor(b["labeled_target"]).long(),
                      labeled_logits=torch.zeros(NL, S, S, 4),
                      bundle=ModelBundle(model, (S, S, 1)), hook_draws={"mixup": draws})
    loss = MixUpTrainHook(weight=1.0).loss(ctx, {})[0]
    loss.backward()
    grads = state_dict_to_flax({**{k: p.grad for k, p in model.named_parameters()},
                                **dict(model.named_buffers())})["params"]
    return loss.detach(), [np.ravel(v) for v in jax.tree.leaves(grads)]


def _jax_hook_grads(tree, b, rng, dtype, *, op_by_op=True):
    """(loss, gradient leaves) of JAX's hook on ``ctx.rng = rng``, op by op
    (``jax.disable_jit``) or jitted, with the weights, the image and the
    model's compute dtype in ``dtype``."""
    t = jax.tree.map(lambda v: jnp.asarray(v, dtype), tree)
    jb = JBundle(JUNet(max_channel=MAXC, momentum=0.1, dtype=dtype), t["params"],
                 t["batch_stats"], (S, S, 1))

    def jloss(params):
        ctx = JContext(bundle=jb, params=params, batch_stats=t["batch_stats"], rng=rng,
                       labeled_image=jnp.asarray(b["labeled_image"], dtype),
                       labeled_target=jnp.asarray(b["labeled_target"]),
                       labeled_logits=jnp.zeros((NL, S, S, 4), dtype))
        return JMixUp(weight=1.0).loss(ctx, {}, {})[0]

    with jax.disable_jit(op_by_op):
        value, grads = jax.jit(jax.value_and_grad(jloss))(t["params"])
    return float(value), [np.ravel(np.asarray(v, np.float64)) for v in jax.tree.leaves(grads)]


def _jax_hook_grads_f64(monkeypatch, tree, b, rng):
    """:func:`_jax_hook_grads` in f64: x64 on, the f32 casts of JAX's U-Net
    (its BN statistics) promoted to f64, and the hook's draws pinned to
    those of f32 mode (x64 changes what ``jax.random`` draws)."""
    k_geo, k_mix = jax.random.split(rng)
    geo = [np.asarray(v) for v in sample_geo_params(k_geo, NL)]
    k_lam, k_perm = jax.random.split(k_mix)
    lam = float(np.asarray(jax.random.beta(k_lam, 1.0, 1.0)))
    perm = np.asarray(jax.random.permutation(k_perm, 2 * NL))
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64
    with jax.enable_x64(True), monkeypatch.context() as mp:
        mp.setattr(jax_unet, "jnp", promoted)
        mp.setattr(jax_mixup, "sample_geo_params", lambda key, n: type(
            sample_geo_params(key, n))(*(jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                                                    else v.dtype) for v in geo)))
        mp.setattr(jax_mixup, "mixup_data", lambda x, y, key, alpha=1.0: (
            lam * x + (1 - lam) * x[perm], lam * y + (1 - lam) * y[perm], lam))
        # jitted: XLA's fusions move an f64 gradient by far less than 1e-3
        return _jax_hook_grads(tree, b, rng, jnp.float64, op_by_op=False)


@pytest.mark.parametrize("mode", ["ft", "semi"])
def test_hook_loss_and_gradient_match_jax(mode, monkeypatch):
    """The hook alone on one labeled batch, JAX's ``ctx.rng`` the step key
    (``ft``) or ``k_hook`` (``semi``), JAX run op by op.

    - Against JAX in f32: the loss to rtol 1e-4; the gradient w.r.t. the
      model's parameters in L2 to 1e-1 per tensor and 5e-2 over all,
      looser than the step bounds (3e-2 / 2e-2) because JAX's own f32
      gradient is that far from exact here: the same JAX code in f64
      (second call below) lies 3.7% over all and 7.5% on one tensor from
      it on ``ft``'s draws, 1.2% / 1.8% on ``semi``'s (measured).
    - Against that f64 run of JAX's code: the loss to rtol 1e-5, the
      gradient to 1e-3 per tensor and over all. The port's f32 gradient
      lies 6e-6 over all and 1.1e-5 on its worst tensor from it
      (measured); a plain-PyTorch f64 U-Net without the port's autograd
      functions agrees with both to the same digits."""
    b = batch(1)
    rng = _hook_rng(jax.random.PRNGKey(11), mode)
    model = port_model(2)
    tree = state_dict_to_flax(model.state_dict())
    loss, grads = _port_hook_grads(model, b, jax_mixup_draws(rng, NL))
    for (value, jgrads), rtol, tensor_bound, all_bound in (
            (_jax_hook_grads(tree, b, rng, jnp.float32), 1e-4, 1e-1, 5e-2),
            (_jax_hook_grads_f64(monkeypatch, tree, b, rng), 1e-5, 1e-3, 1e-3)):
        close(loss, value, rtol=rtol, atol=1e-7, what="mixup loss")
        for g, j in zip(grads, jgrads):
            assert l2(g, j) <= tensor_bound, l2(g, j)
        assert l2(np.concatenate(grads), np.concatenate(jgrads)) <= all_bound


def test_mixed_forward_keeps_the_running_statistics():
    """The hook's forward of the mixed batch updates no running statistic,
    and a step with the hook ends with the statistics of the same step
    without it (``enable_bn`` has no effect, as in JAX)."""
    b = {k: torch.tensor(v) for k, v in batch(2).items()}
    b["labeled_target"] = b["labeled_target"].long()
    draws = StepDraws(None, None, {"mixup": jax_mixup_draws(jax.random.PRNGKey(3), NL)}, {})
    model = port_model(3)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    ctx = StepContext(labeled_image=b["labeled_image"], labeled_target=b["labeled_target"],
                      labeled_logits=torch.zeros(NL, S, S, 4),
                      bundle=ModelBundle(model, (S, S, 1)), hook_draws=draws.hooks)
    MixUpTrainHook(enable_bn=True).loss(ctx, {})
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v), k
    stats = []
    for hooks in ([MixUpTrainHook(enable_bn=False)], []):
        model = port_model(3)
        bundle, state = port_state(model, hooks)
        build_train_step(bundle, hooks, mode="ft")(state, b, draws)
        stats.append({k: v for k, v in model.state_dict().items() if "running" in k})
    for k, v in stats[0].items():
        assert torch.equal(v, stats[1][k]), k


@pytest.mark.parametrize("mode", ["ft", "semi"])
def test_step_with_mixup_matches_jax(mode):
    """``ft``: the ``MixUpTrainer`` step (the labeled batch alone, the hook
    active); ``semi``: the semi step with ``MixUpParams`` beside the
    consistency hook of config/hooks/consistency.yaml."""
    sections = dict(MIXUP) if mode == "ft" else {**MIXUP, "ConsistencyParameters": {"weight": 10}}
    config = simple_config(sections, name="mixup" if mode == "ft" else "semi")
    model = port_model(4)
    hooks = create_hook_from_config(config, channel_dim=model.get_channel_dim)
    jhooks = jcreate_hooks(config)
    assert [h.name for h in hooks] == [h.name for h in jhooks]
    b, key = batch(3), jax.random.PRNGKey(5)
    if mode == "ft":
        b = {k: v for k, v in b.items() if k.startswith("labeled")}
    params, _, jnew, jm = jax_step(model, b, key, jhooks, mode=mode)
    bundle, state = port_state(model, hooks)
    hook_draws = {"mixup": jax_mixup_draws(_hook_rng(key, mode), NL)}
    draws = (StepDraws(None, None, hook_draws, {}) if mode == "ft"
             else replayed_draws(key, hooks=hook_draws))
    m = build_train_step(bundle, hooks, mode=mode)(
        state, {k: torch.tensor(v) for k, v in b.items()}, draws)
    assert set(jm) == set(m)
    check_metrics(m, jm)
    check_model(state, params, jnew)


def test_a_plain_ft_run_draws_nothing():
    """Without a drawing hook ``sample_ft_draws`` leaves both generators as
    they were, and the cached ``ft`` step equals the step on the batch the
    same generator state samples, without draws."""
    gen, host = torch.Generator().manual_seed(3), np.random.default_rng(3)
    g0, h0 = gen.get_state(), host.bit_generator.state
    d = sample_ft_draws(gen, [EMAEvalTrainerHook()], host_rng=host, shape=(NL, S, S, 1))
    assert d.hooks == {} and torch.equal(gen.get_state(), g0) and host.bit_generator.state == h0
    rng = np.random.default_rng(0)
    images = rng.random((6, 40, 40)).astype(np.float32)
    targets = rng.integers(0, 4, (6, 40, 40))
    cache = DeviceDataCache.from_arrays(images, targets, crop=S, device="cpu")
    metrics = []
    for cached in (True, False):
        model = port_model(5)
        bundle, state = port_state(model, [])
        g = torch.Generator().manual_seed(9)
        if cached:
            m = build_cached_train_step(bundle, [], labeled_cache=cache, labeled_batch=NL)(
                state, g, 0, np.random.default_rng(1))
        else:
            lab = cache.sample(g, NL)
            m = build_train_step(bundle, [], mode="ft")(
                state, {"labeled_image": lab["image"], "labeled_target": lab["target"]}, None)
        metrics.append(m)
    for k in ("sup_loss", "total_loss", "dice_inter"):
        assert torch.equal(metrics[0][k], metrics[1][k]), k


def test_mixup_config_equals_the_yaml_files_and_the_trainer_is_registered():
    assert MIXUP_CONFIG == merge(yaml_load(REPO / "config/base.yaml"),
                                 yaml_load(REPO / "config/hooks/mixup.yaml"))
    assert trainer_zoo["mixup"] is MixUpTrainer
    assert (MixUpTrainer.train_mode, MixUpTrainer.activate_hooks) == ("ft", True)
    assert port_main.parse_config(["-o", "Trainer.name=mixup"]) == MIXUP_CONFIG


def jax_loop_header(cfg, tmp_path) -> list:
    """The ``storage.csv`` header of JAX's trainer of ``cfg`` (its model at
    max_channel 128, f32) after ``max_epoch`` x ``num_batches`` steps with
    validation and test."""
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


#: a short CPU run of ``main.main``
SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2",
         "Trainer.num_batches=2", "Trainer.max_epoch=1", "Trainer.device=cpu",
         "Arch.max_channel=32"]


@pytest.fixture
def layout(tmp_path, monkeypatch):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=3, num_val_scans=2,
                         slices_per_scan=4, size=48)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def test_mixup_loop_writes_jax_columns(layout, tmp_path, fast_jax_bundle):
    argv = ["-o", "Trainer.name=mixup", "Trainer.save_dir=mixup", *SMALL]
    assert port_main.main(argv) == 0
    run = layout / "mixup"
    for f in (".success", "inference_result.json", "last/train_state.pt", "config.yaml"):
        assert (run / f).exists(), f
    lines = (run / "storage.csv").read_text().splitlines()
    header, row = lines[0].split(","), dict(zip(*(line.split(",") for line in lines[:2])))
    assert len(lines) == 2 and np.isfinite(float(row["tra/mixup/metrics/loss"]))
    assert header == jax_loop_header(port_main.parse_config(argv), tmp_path)
