"""The simple hooks of the port (contrastyou_tpu_torch/losses/kl.py
``entropy_loss``, hooks/entmin.py, pseudolabel.py, orthogonal.py,
autoencoder.py) held against the JAX package on the CPU: each loss and its
gradient on the same numpy-seeded inputs (f32 rtol 1e-5, atol 1e-7), the DAE
conv across the weight bridge both ways and its initial shapes, and one
``semi`` step with the four hooks stacked against JAX's
``build_train_step(raw=True)`` on the same batch, weights and replayed key
splits, with tests/test_torch_step.py's bounds: losses rtol 1e-4, BN running
statistics 1e-3 of the largest value, parameter updates in L2 3e-2 per
tensor and 2e-2 over all (the DAE conv's too).

The helpers at the bottom (``jax_step``, ``port_state``, ``replayed_draws``,
``check_updates``) are shared with tests/test_torch_mixup.py and
tests/test_torch_ccblock.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.hooks import StepContext as JContext
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks.autoencoder import DenoisingAutoEncoderTrainerHook as JDAE
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.hooks.entmin import EntropyMinTrainerHook as JEntMin
from contrastyou_tpu.hooks.orthogonal import OrthogonalTrainerHook as JOrth
from contrastyou_tpu.hooks.pseudolabel import PseudoLabelTrainerHook as JPLab
from contrastyou_tpu.losses.kl import entropy_loss as jentropy
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
import contrastyou_tpu_torch as package
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import ModuleHook, StepContext, hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import StepDraws, build_train_step, init_train_state
from contrastyou_tpu_torch.hooks.autoencoder import AuxLayer, DenoisingAutoEncoderTrainerHook
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.hooks.entmin import EntropyMinTrainerHook
from contrastyou_tpu_torch.hooks.orthogonal import OrthogonalTrainerHook
from contrastyou_tpu_torch.hooks.pseudolabel import PseudoLabelTrainerHook
from contrastyou_tpu_torch.losses.kl import entropy_loss
from contrastyou_tpu_torch.main import _BASE
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        head_state_dict_to_flax,
                                                        state_dict_to_flax)
from test_torch_step import REPO
from torch_parity import close, hwio, n, scaled_close, t

torch.set_num_threads(1)

NL, NU, S, MAXC = 2, 2, 32, 128
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _logits(seed=0, shape=(2, 8, 8, 4), scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grad_pair(jfn, tfn, x):
    """(JAX value, grad) and (port value, grad) of a scalar fn of ``x``."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = tfn(tx)
    tv.backward()
    return (jv, jg), (tv, tx.grad)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_entropy_loss_matches_jax(reduction):
    probs = np.asarray(jax.nn.softmax(jnp.asarray(_logits(1)), -1))
    w = np.random.default_rng(2).random(probs.shape[:-1]).astype(np.float32)
    (jv, jg), (tv, tg) = _grad_pair(
        lambda p: (jentropy(p, reduction=reduction) * (w if reduction == "none" else 1)).sum(),
        lambda p: (entropy_loss(p, reduction=reduction)
                   * (torch.tensor(w) if reduction == "none" else 1)).sum(), probs)
    close(tv, jv, rtol=RTOL, atol=ATOL, what="entropy")
    close(tg, jg, rtol=RTOL, atol=ATOL, what="d entropy")
    assert entropy_loss(torch.tensor(probs), reduction=reduction).shape == \
        jentropy(jnp.asarray(probs), reduction=reduction).shape


@pytest.mark.parametrize("hooks", [(JEntMin(name="entropy"), EntropyMinTrainerHook(name="entropy")),
                                   (JPLab(name="plab"), PseudoLabelTrainerHook(name="plab"))],
                         ids=["entmin", "pseudolabel"])
def test_logit_hooks_match_jax(hooks):
    """Loss and gradient w.r.t. T(f(x)) of the entropy-min and pseudo-label
    hooks."""
    jhook, hook = hooks
    (jv, jg), (tv, tg) = _grad_pair(
        lambda x: jhook.loss(JContext(unlabeled_logits_tf=x), {}, {})[0],
        lambda x: hook.loss(StepContext(unlabeled_logits_tf=x), {})[0], _logits(3))
    close(tv, jv, rtol=RTOL, atol=ATOL, what=hook.name)
    close(tg, jg, rtol=RTOL, atol=ATOL, what=f"d {hook.name}")


def test_pseudo_label_ties_take_the_first_class():
    """Two equal top logits: the one-hot goes to the first, as jnp.argmax
    and torch.argmax both pick."""
    x = np.array([[[[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0]]]], np.float32)
    got = PseudoLabelTrainerHook().loss(StepContext(unlabeled_logits_tf=torch.tensor(x)), {})[0]
    ref = JPLab().loss(JContext(unlabeled_logits_tf=jnp.asarray(x)), {}, {})[0]
    p = np.asarray(jax.nn.softmax(jnp.asarray(x), -1))
    onehot = np.array([[[[1, 0, 0, 0], [0, 1, 0, 0]]]], np.float32)
    close(got, ref, rtol=RTOL, atol=ATOL)
    close(got, np.mean((p - onehot) ** 2), rtol=RTOL, atol=ATOL)


def test_orthogonal_hook_matches_jax_and_reaches_the_weight():
    """The prototypes are the live Deconv_1x1 weight [C, Cin, 1, 1] (JAX's
    kernel [1, 1, Cin, C]); the loss's gradient lands on it."""
    kernel = np.random.default_rng(4).standard_normal((1, 1, 32, 4)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda k: JOrth(weight=1.0).loss(
        JContext(params={"Deconv_1x1": {"kernel": k}}), {}, {})[0])(jnp.asarray(kernel))
    model = torch.nn.Module()
    model._Deconv_1x1 = torch.nn.Conv2d(32, 4, 1)
    with torch.no_grad():
        model._Deconv_1x1.weight.copy_(torch.tensor(np.transpose(kernel, (3, 2, 0, 1))))
    tv = OrthogonalTrainerHook(weight=1.0).loss(
        StepContext(bundle=types.SimpleNamespace(model=model)), {})[0]
    tv.backward()
    close(tv, jv, rtol=RTOL, atol=ATOL, what="orth")
    close(hwio(model._Deconv_1x1.weight.grad), jg, rtol=RTOL, atol=ATOL, what="d orth")
    assert OrthogonalTrainerHook.requires_unlabeled is False


def _dae_pair(seed=5, classes=4):
    jhook = JDAE(weight=1.0, num_classes=classes)
    params, _ = jhook.init(jax.random.PRNGKey(seed), None)
    params = jax.tree.map(np.asarray, params)
    hook = DenoisingAutoEncoderTrainerHook(weight=1.0, num_classes=classes)
    hook.projector.load_state_dict(flax_to_head_state_dict(params))
    return jhook, params, hook


def test_dae_hook_matches_jax():
    """Loss and gradients (conv kernel and bias, logits f(T(x))) of the
    sigmoid reconstruction of T(x)."""
    jhook, params, hook = _dae_pair()
    logits = _logits(6)
    image = np.random.default_rng(7).random((2, 8, 8, 1)).astype(np.float32)

    def jloss(p, x):
        return jhook.loss(JContext(unlabeled_tf_logits=x, unlabeled_image_tf=jnp.asarray(image)),
                          p, {})[0]

    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tv = hook.loss(StepContext(unlabeled_tf_logits=x, unlabeled_image_tf=torch.tensor(image)),
                   {})[0]
    tv.backward()
    close(tv, jv, rtol=RTOL, atol=ATOL, what="dae")
    close(x.grad, jgx, rtol=RTOL, atol=ATOL, what="d logits")
    conv = hook.projector.Conv_0
    grads = head_state_dict_to_flax({"Conv_0.weight": conv.weight.grad,
                                     "Conv_0.bias": conv.bias.grad})
    for k in ("kernel", "bias"):
        close(grads["Conv_0"][k], jgp["Conv_0"][k], rtol=RTOL, atol=ATOL, what=f"d {k}")


def test_dae_conv_crosses_the_bridge_both_ways_and_has_jax_init_shapes():
    """flax ``Conv_0`` {kernel [1,1,C,1], bias [1]} -> the port's AuxLayer
    and back, bitwise; both inits: a LeCun-scaled kernel of that shape and
    a zero bias."""
    _, params, hook = _dae_pair(classes=4)
    back = head_state_dict_to_flax(hook.projector.state_dict())
    assert set(back) == {"Conv_0"}
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(back["Conv_0"][k], params["Conv_0"][k])
    assert params["Conv_0"]["kernel"].shape == (1, 1, 4, 1)
    assert params["Conv_0"]["bias"].shape == (1,) and not params["Conv_0"]["bias"].any()
    wide = AuxLayer(4096).init_weights(torch.Generator().manual_seed(0))
    assert tuple(wide.Conv_0.weight.shape) == (1, 4096, 1, 1)
    assert not wide.Conv_0.bias.any()
    jwide = jax.tree.map(np.asarray, JDAE(num_classes=4096).init(jax.random.PRNGKey(0), None)[0])
    # flax's lecun_normal is a truncated normal of std 1/sqrt(fan_in); the
    # port draws an untruncated normal of that std
    assert abs(float(wide.Conv_0.weight.detach().std()) * 64 - 1) < 0.05
    assert abs(float(jwide["Conv_0"]["kernel"].std()) * 64 - 1) < 0.05



def test_module_hooks_declare_their_projector():
    """``ModuleHook.projector`` is None unless the hook sets a head;
    ``init_weights`` draws the head's weights from the generator, and does
    nothing without one."""
    bare = ModuleHook(hook_name="bare")
    assert bare.projector is None and not list(bare.parameters())
    assert bare.init_weights(torch.Generator()) is bare
    hooks = [DenoisingAutoEncoderTrainerHook(num_classes=4).init_weights(
        torch.Generator().manual_seed(3)) for _ in range(2)]
    assert all(isinstance(h.projector, AuxLayer) for h in hooks)
    a, b = (dict(h.named_parameters()) for h in hooks)
    assert set(a) == {"projector.Conv_0.weight", "projector.Conv_0.bias"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["projector.Conv_0.weight"].abs().sum() > 0 and not a["projector.Conv_0.bias"].any()

# --- the semi step -----------------------------------------------------------

#: config/hooks/entmin.yaml, pseudolabel.yaml, orthogonal.yaml and dae.yaml
SIMPLE_HOOKS = {"EntropyMinParameters": {"weight": 0.001}, "PsuedoLabelParams": {"weight": 0.1},
                "OrthogonalParameters": {"weight": 0.001}, "DAEParameters": {"weight": 0.1}}


def simple_config(sections, name="semi"):
    return merge(_BASE, {**sections, "Trainer": {"name": name, "max_epoch": 75}})


def batch(seed=0, nl=NL, nu=NU):
    rng = np.random.default_rng(seed)
    return {"labeled_image": rng.random((nl, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (nl, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((nu, S, S, 1)).astype(np.float32)}


def port_model(seed=0):
    return UNet(max_channel=MAXC, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(seed))


def jax_step(model, b, key, hooks, *, mode="semi", epoch=0):
    """JAX's raw step from ``model``'s weights (the hooks' parameters from
    their own init) -> (initial params, initial hook params, new state,
    metrics), numpy leaves."""
    tree = jax.tree.map(jnp.asarray, state_dict_to_flax(model.state_dict()))
    bundle = JBundle(JUNet(max_channel=MAXC, momentum=0.1, dtype=jnp.float32),
                     tree["params"], tree["batch_stats"], (S, S, 1))
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
    before = jax.tree.map(np.asarray, (state.params, state.hook_params))
    step = jax.jit(jbuild(bundle, tx, hooks, raw=True, two_stage=True, mode=mode))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key, jnp.int32(epoch))
    return before[0], before[1], new, jax.tree.map(np.asarray, metrics)


def replayed_draws(key, nu=NU, hooks=None):
    """The port's StepDraws of JAX's ``split(key, 3)`` (``hooks``: the
    hooks' draws, by name)."""
    k_geo, k_int, _ = jax.random.split(key, 3)
    geo = sample_geo_params(k_geo, nu)
    gammas = jax.random.uniform(k_int, (nu, 1, 1, 1), minval=0.5, maxval=2.0)
    return StepDraws(GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                     t(gammas).reshape(nu), hooks or {}, {})


def port_state(model, hooks):
    opt, _ = create_optimizer(list(model.parameters()) + hook_parameters(hooks), OPTIM, SCHED,
                              max_epoch=75, steps_per_epoch=200)
    bundle = ModelBundle(model, (S, S, 1))
    return bundle, init_train_state(bundle, hooks, opt)


def l2(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30)


def check_updates(upd, jupd, what="update"):
    """Per tensor L2 <= 3e-2, all tensors together <= 2e-2."""
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(upd)[0], jax.tree.leaves(jupd)):
        assert l2(a, b) <= 3e-2, f"{what} {jax.tree_util.keystr(path)}: {l2(a, b):.3e}"
    assert l2(*(np.concatenate([np.ravel(v) for v in jax.tree.leaves(u)])
                for u in (upd, jupd))) <= 2e-2, what


def check_model(state, params, jnew):
    """The model's parameter updates and running statistics against JAX's."""
    new = state_dict_to_flax(state.model.state_dict())
    check_updates(jax.tree.map(lambda a, b: a - b, new["params"], params),
                  jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.params, params))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jax.tree.map(np.asarray, jnew.batch_stats))):
        scaled_close(a, b, tol=1e-3, what=f"stats {jax.tree_util.keystr(path)}")


def check_metrics(m, jm):
    for k in jm:
        if k.startswith("dice"):
            assert np.abs(n(m[k]) - jm[k]).max() <= 1, k
        else:
            close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=k)


def test_semi_step_with_the_simple_hooks_matches_jax():
    """entropy-min, orthogonal, pseudo-label and DAE stacked under ``semi``:
    the factories' order and names agree; the DAE conv carried over by the
    bridge and optimized beside the model."""
    config = simple_config(SIMPLE_HOOKS)
    model = port_model()
    hooks = create_hook_from_config(config, channel_dim=model.get_channel_dim)
    jhooks = jcreate_hooks(config)
    assert [h.name for h in hooks] == [h.name for h in jhooks] == ["entropy", "orth", "plab",
                                                                   "dae"]
    b, key = batch(), jax.random.PRNGKey(7)
    params, hparams, jnew, jm = jax_step(model, b, key, jhooks)
    hooks[3].projector.load_state_dict(flax_to_head_state_dict(hparams["dae"]))
    dae0 = {k: v.clone() for k, v in hooks[3].projector.state_dict().items()}
    bundle, state = port_state(model, hooks)
    m = build_train_step(bundle, hooks)(state, {k: torch.tensor(v) for k, v in b.items()},
                                        replayed_draws(key))
    assert set(jm) == set(m)
    check_metrics(m, jm)
    check_model(state, params, jnew)
    got = head_state_dict_to_flax(hooks[3].projector.state_dict())
    check_updates(jax.tree.map(lambda a, b: a - b, got, hparams["dae"]),
                  jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.hook_params["dae"],
                               hparams["dae"]), what="update dae")
    assert not torch.equal(dae0["Conv_0.bias"], hooks[3].projector.Conv_0.bias)


@pytest.mark.parametrize("preset,name", [("entmin", "entropy"), ("pseudolabel", "plab"),
                                         ("orthogonal", "orth"), ("dae", "dae")])
def test_preset_runs_from_the_yaml_files(preset, name, tmp_path, monkeypatch):
    """``-p config/base.yaml config/hooks/<preset>.yaml -o Trainer.name=semi``
    through ``main.main`` on the CPU: the files of a ``semi`` run and the
    hook's loss column."""
    synthesize_acdc_like(tmp_path / "data", num_train_scans=3, num_val_scans=2,
                         slices_per_scan=4, size=32)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    argv = ["-p", str(REPO / "config/base.yaml"), str(REPO / f"config/hooks/{preset}.yaml"),
            "-o", "Trainer.name=semi", "Trainer.max_epoch=1", "Trainer.num_batches=2",
            "Trainer.save_dir=run", "Trainer.device=cpu", "Arch.max_channel=32",
            "Data.labeled_scan_num=1", "LabeledLoader.batch_size=2",
            "UnlabeledLoader.batch_size=2"]
    assert port_main.main(argv) == 0
    run = tmp_path / "runs" / "run"
    for f in (".success", "storage.csv", "inference_result.json", "last/train_state.pt"):
        assert (run / f).exists(), f
    lines = (run / "storage.csv").read_text().splitlines()
    row = dict(zip(*(line.split(",") for line in lines[:2])))
    assert np.isfinite(float(row[f"tra/{name}/metrics/loss"]))


def test_checkpoint_carries_the_dae_conv_and_the_imsat_weight(tmp_path):
    """A checkpoint restores the DAE hook's conv (a hook module, as the
    projection heads) and a cross-correlation hook's imsat weight (hook
    state) into a fresh run."""
    from contrastyou_tpu_torch.engine.checkpoint import (load_checkpoint, load_train_state,
                                                         save_checkpoint, train_state_dict)
    from contrastyou_tpu_torch.hooks.ccblock import CrossCorrelationHook

    def hooks(seed):
        gen = torch.Generator().manual_seed(seed)
        return [DenoisingAutoEncoderTrainerHook(weight=0.1).init_weights(gen),
                CrossCorrelationHook(name="cc_Up_conv2", feature_name="Up_conv2", in_dim=16,
                                     hooks={"imsat": {"weight": 0.1}}).init_weights(gen)]

    saved_hooks = hooks(0)
    _, state = port_state(port_model(0), saved_hooks)
    state.hook_states["cc_Up_conv2"]["imsat_weight"] += 0.25
    save_checkpoint(tmp_path / "ckpt", train_state=train_state_dict(state, saved_hooks),
                    host_state={})
    fresh = hooks(1)
    _, state2 = port_state(port_model(1), fresh)
    load_train_state(state2, fresh, load_checkpoint(tmp_path / "ckpt")["train_state"])
    for a, b in zip(saved_hooks, fresh):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), (a.name, k)
    assert float(state2.hook_states["cc_Up_conv2"]["imsat_weight"]) == 1.25
