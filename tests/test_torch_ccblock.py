"""The cross-correlation block of the port (contrastyou_tpu_torch/losses/
cross_correlation.py, losses/redundancy.py, the ``mlp`` cluster head of
models/projectors.py and its bridge, hooks/ccblock.py, the cc hooks under
``semi`` and under pretraining in trainers/pretrain.py) held against the JAX
package on the CPU, on the same numpy-seeded inputs and bridged weights.

Tolerances (f32): the losses, metrics and gradients of the pieces and of
each tiny hook rtol 1e-5, atol 1e-6 (the same sums in another order; the NCC's
window sums are an average pool times the window's area, where JAX adds in
``reduce_window``, so the variances, differences of sums, carry ~1e-7 of the
sums' scale); the antialiased bilinear resize within 1e-6 of
``jax.image.resize`` on [0, 1] images (measured 1.8e-7 at 224 -> 112 and
224 -> 56); the ``semi`` and ``pretrain_decoder`` steps with the bounds of
tests/test_torch_step.py (losses rtol 1e-4, BN running statistics 1e-3 of
the largest value, updates in L2 3e-2 per tensor and 2e-2 over all, the
cluster head's too), but for the ``cc`` metric of the pretrain step
(``CC_RTOL`` 1e-3, and why).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastyou_tpu_torch as package
from contrastyou_tpu.engine.hooks import StepContext as JContext
from contrastyou_tpu.hooks.ccblock import CrossCorrelationHook as JCCHook
from contrastyou_tpu.hooks.ccblock import cc_edge_loss as jcc_edge_loss
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.losses.cross_correlation import CCLoss as JCCLoss
from contrastyou_tpu.losses.cross_correlation import windowed_ncc_loss as jncc
from contrastyou_tpu.losses.redundancy import RedundancyCriterion as JRedundancyCriterion
from contrastyou_tpu.losses.redundancy import redundancy_criterion as jredundancy
from contrastyou_tpu.models.projectors import CrossCorrelationProjector as JProjector
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch import main as port_main
from contrastyou_tpu_torch.configure.config import merge
from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext, hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import build_train_step, init_train_state
from contrastyou_tpu_torch.hooks.ccblock import CrossCorrelationHook, cc_edge_loss, resize_bilinear
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.losses.cross_correlation import CCLoss, windowed_ncc_loss
from contrastyou_tpu_torch.losses.redundancy import RedundancyCriterion, redundancy_criterion
from contrastyou_tpu_torch.main import _BASE, build_pretrain_run, build_semi_run, parse_config
from contrastyou_tpu_torch.models.projectors import CrossCorrelationProjector
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.trainers.pretrain import (build_pretrain_step, check_pretrain_hooks,
                                                     feature_until_from_hooks, frozen_encoder,
                                                     pretrain_trainable)
from contrastyou_tpu_torch.utils.torch_convert import (cluster_head_state_dict_to_flax,
                                                        flax_to_cluster_head_state_dict,
                                                        flax_to_head_state_dict,
                                                        flax_to_state_dict,
                                                        head_state_dict_to_flax,
                                                        state_dict_to_flax)
from test_torch_mt_loop import fast_jax_bundle  # noqa: F401 (a fixture)
from test_torch_pretrain import OPTIM as PRE_OPTIM
from test_torch_pretrain import SCHED as PRE_SCHED
from test_torch_pretrain import _batch as pretrain_batch
from test_torch_pretrain import _hook_config, _jax_step as jax_pretrain_step, _replayed_draws
from test_torch_simple_hooks import (S, batch, check_metrics, check_model, check_updates,
                                     jax_step, port_model, port_state, replayed_draws,
                                     simple_config)
from test_torch_spinfonce import jax_storage_columns
from test_torch_step import REPO
from torch_parity import close, scaled_close

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
#: the ``cc`` metric of a whole step: a correlation of per-slice min-max
#: normalized maps of the U-Net's taps, whose own f32 value lies 2.4e-4 from
#: its f64 value on the pretrain step's weights (measured on the port), so
#: the two frameworks' f32 sums through the network may part it by as much
CC_RTOL = 1e-3
#: config/hooks/ccblocks2.yaml and ccblocks_imsat.yaml
CC2 = {"feature_name": "Up_conv2", "train_encoder": True, "num_clusters": 20,
       "head_type": "mlp", "num_subheads": 1, "save": False,
       "hooks": {"cc": {"weight": 0.1, "kernel_size": 5, "diff_power": 0.75},
                 "rr": {"weight": 1, "symmetric": True, "lamda": 1.5, "alpha": 0.5}}}
CC_IMSAT = dict(CC2, hooks={"cc": {"weight": 0.1, "kernel_size": 5, "diff_power": 0.75},
                            "imsat": {"weight": 0.1, "use_dynamic": True}})


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _rand(shape, seed, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random(shape)).astype(np.float32)


def _simplex(shape, seed):
    return np.asarray(jax.nn.softmax(jnp.asarray(_rand(shape, seed, -3, 3)), -1))


def _value_and_grads(jfn, tfn, *xs):
    """JAX's and the port's value and gradients w.r.t. every input."""
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(xs)))))(
        *map(jnp.asarray, xs))
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    tv = tfn(*txs)
    tv.backward()
    return (jv, jg), (tv, [x.grad for x in txs])


def _check(j, p, what):
    (jv, jg), (tv, tg) = j, p
    close(tv, jv, rtol=RTOL, atol=ATOL, what=what)
    for i, (a, b) in enumerate(zip(tg, jg)):
        close(a, b, rtol=RTOL, atol=ATOL, what=f"d{i} {what}")


@pytest.mark.parametrize("win", [3, 5, 9])
def test_windowed_ncc_matches_jax(win):
    a, b = _rand((2, 24, 20, 1), 0), _rand((2, 24, 20, 1), 1) ** 2
    _check(*_value_and_grads(lambda x, y: jncc(x, y, win=(win, win)),
                             lambda x, y: windowed_ncc_loss(x, y, win=(win, win)), a, b),
           f"ncc {win}")
    close(CCLoss((win, win))(torch.tensor(a), torch.tensor(b)),
          JCCLoss((win, win))(jnp.asarray(a), jnp.asarray(b)), rtol=RTOL, atol=ATOL,
          what=f"CCLoss {win}")
    with pytest.raises(ValueError, match="odd"):
        windowed_ncc_loss(torch.tensor(a), torch.tensor(b), win=(4, 4))


@pytest.mark.parametrize("size", [112, 56])
def test_antialiased_resize_matches_jax(size):
    x = _rand((2, 224, 224, 1), 2)
    ref = jax.image.resize(jnp.asarray(x), (2, size, size, 1), "bilinear")
    close(resize_bilinear(torch.tensor(x), (size, size)), ref, rtol=0, atol=1e-6,
          what=f"224 -> {size}")


@pytest.mark.parametrize("pred", [32, 16], ids=["same size", "resized"])
def test_cc_edge_loss_matches_jax(pred):
    """The edge map of a 32x32 image against the entropy map of a
    prediction of the same size, or of half the size (the image resized
    with the antialiased filter first)."""
    img, p = _rand((2, 32, 32, 1), 3), _simplex((2, pred, pred, 6), 4)
    _check(*_value_and_grads(lambda x: jcc_edge_loss(img, x, kernel_size=5, diff_power=0.75),
                             lambda x: cc_edge_loss(torch.tensor(img), x, kernel_size=5,
                                                    diff_power=0.75), p), f"cc {pred}")


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_redundancy_criterion_matches_jax(alpha, symmetric):
    x, y = _simplex((2, 12, 12, 7), 5), _simplex((2, 12, 12, 7), 6)
    kw = dict(alpha=alpha, lamda=1.5, symmetric=symmetric)
    _check(*_value_and_grads(lambda a, b: jredundancy(a, b, **kw),
                             lambda a, b: redundancy_criterion(a, b, **kw), x, y), "rr")
    _, joint = redundancy_criterion(torch.tensor(x), torch.tensor(y), return_joint=True, **kw)
    _, jjoint = jredundancy(jnp.asarray(x), jnp.asarray(y), return_joint=True, **kw)
    close(joint, jjoint, rtol=RTOL, atol=ATOL, what="joint")
    close(RedundancyCriterion(**kw)(torch.tensor(x), torch.tensor(y)),
          JRedundancyCriterion(**kw)(jnp.asarray(x), jnp.asarray(y)), rtol=RTOL, atol=ATOL,
          what="RedundancyCriterion")


def _jax_projector(in_dim, seed=0, **kw):
    proj = JProjector(num_clusters=kw.get("num_clusters", 20), hidden_dim=64,
                      num_subheads=kw.get("num_subheads", 1))
    params = proj.init(jax.random.PRNGKey(seed), jnp.zeros((2, 8, 8, in_dim)))["params"]
    return proj, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("subheads", [1, 2])
def test_mlp_projector_crosses_the_bridge_and_matches_jax(subheads):
    """The vmapped Conv_0 / Conv_1 of the mlp form -> the port's head and
    back, bitwise; the same distributions on f32 and on bf16 features, both
    computed in f32 (flax's ``nn.Conv`` without a dtype promotes bf16 inputs
    with f32 parameters to f32)."""
    proj, params = _jax_projector(16, num_subheads=subheads)
    head = CrossCorrelationProjector(16, num_subheads=subheads)
    head.load_state_dict(flax_to_cluster_head_state_dict(params))
    back = cluster_head_state_dict_to_flax(head.state_dict(), dense=True)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert params["Vmap_DenseSubHead_0"]["Conv_0"]["kernel"].shape == (subheads, 1, 1, 16, 64)
    x = _rand((2, 6, 6, 16), 7, -1, 1)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = proj.apply({"params": params}, jnp.asarray(x).astype(jdt))
        got = head(torch.tensor(x).to(dt))
        assert ref.dtype == jnp.float32 and got.dtype == torch.float32
        close(got, ref, rtol=RTOL, atol=ATOL, what=str(dt))
    fresh = CrossCorrelationProjector(16, num_subheads=subheads).init_weights(
        torch.Generator().manual_seed(0))
    assert {k: tuple(p.shape) for k, p in fresh.named_parameters()} == {
        "hidden_weight": (subheads, 16, 64), "hidden_bias": (subheads, 64),
        "weight": (subheads, 64, 20), "bias": (subheads, 20)}
    assert not fresh.hidden_bias.any() and not fresh.bias.any()


def _geo(key, b):
    return GeoParams(*(torch.tensor(np.asarray(v)) for v in sample_geo_params(key, b)))


#: the tiny hooks, alone and all together
TINY = {"cc": {"weight": 0.3, "kernel_size": 5, "diff_power": 0.75},
        "mi": {"weight": 0.5, "padding": 1, "lamda": 1.2},
        "rr": {"weight": 1.0, "symmetric": False, "lamda": 1.5, "alpha": 0.25},
        "imsat": {"weight": 0.2, "lamda": 1.3, "use_dynamic": True},
        "consist": {"weight": 0.7}}


def _hook_pair(feature, tiny, subheads=2, seed=0):
    """JAX's hook and the port's on ``feature`` (a 16-channel tap, or
    ``Deconv_1x1``) with the same head."""
    jhook = JCCHook(name=f"cc_{feature}", feature_name=feature, num_clusters=10,
                    num_subheads=subheads, hooks=tiny)
    bundle = types.SimpleNamespace(get_channel_dim=lambda name: 16)
    params, state = jhook.init(jax.random.PRNGKey(seed), bundle)
    hook = CrossCorrelationHook(name=f"cc_{feature}", feature_name=feature, in_dim=16,
                                num_clusters=10, num_subheads=subheads, hooks=tiny)
    if params is not None:
        params = jax.tree.map(np.asarray, params)
        hook.projector.load_state_dict(flax_to_cluster_head_state_dict(params))
    model = torch.nn.Linear(1, 1)
    return jhook, params, state, hook, hook.init_state(types.SimpleNamespace(model=model))


def _hook_inputs(seed=0, B=2, H=16):
    key = jax.random.PRNGKey(seed)
    return dict(feat=_rand((B, H, H, 16), seed, -1, 1),
                feat_tf=_rand((B, H, H, 16), seed + 1, -1, 1),
                logits_tf=_rand((B, H, H, 4), seed + 2, -2, 2),
                tf_logits=_rand((B, H, H, 4), seed + 3, -2, 2),
                image_tf=_rand((B, 2 * H, 2 * H, 1), seed + 4), key=key)


def _run_hook_pair(jhook, params, jstate, hook, state, inp, feature):
    """Both hooks' (loss, new state, metrics, input gradients, head gradients)."""
    geo = sample_geo_params(inp["key"], inp["feat"].shape[0])
    names = ("feat", "feat_tf", "logits_tf", "tf_logits")

    def jloss(p, *xs):
        d = dict(zip(names, xs))
        ctx = JContext(unlabeled_taps={feature: d["feat"]},
                       unlabeled_tf_taps={feature: d["feat_tf"]},
                       unlabeled_logits_tf=d["logits_tf"], unlabeled_tf_logits=d["tf_logits"],
                       unlabeled_image_tf=jnp.asarray(inp["image_tf"]), geo_params=geo)
        loss, new_state, metrics = jhook.loss(ctx, p, jstate)
        return loss, (new_state, metrics)

    (jv, (jstate2, jm)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        params, *(jnp.asarray(inp[k]) for k in names))
    xs = {k: torch.tensor(inp[k], requires_grad=True) for k in names}
    ctx = StepContext(unlabeled_taps={feature: xs["feat"]},
                      unlabeled_tf_taps={feature: xs["feat_tf"]},
                      unlabeled_logits_tf=xs["logits_tf"], unlabeled_tf_logits=xs["tf_logits"],
                      unlabeled_image_tf=torch.tensor(inp["image_tf"]),
                      geo_params=GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)))
    loss, state2, metrics = hook.loss(ctx, state)
    loss.backward()
    head = (cluster_head_state_dict_to_flax(
        {k: p.grad for k, p in hook.projector.named_parameters()}, dense=True)
        if params is not None else None)
    return ((jv, jstate2, jm, jg[1:], jg[0]),
            (loss, state2, metrics, [xs[k].grad for k in names], head))


@pytest.mark.parametrize("feature", ["Up_conv2", "Deconv_1x1"], ids=["tap", "logits"])
@pytest.mark.parametrize("tiny", [*TINY, "all"])
def test_tiny_hooks_match_jax(tiny, feature):
    """Each tiny hook alone and all five together, on a tapped feature map
    (an mlp head of two subheads, 10 clusters, the image twice the map's
    size so ``cc`` resizes it) and on the logits (the two softmaxes): the
    loss, every metric, the new imsat weight and the gradients w.r.t. the
    taps / logits and the head."""
    hooks = TINY if tiny == "all" else {tiny: TINY[tiny]}
    jhook, params, jstate, hook, state = _hook_pair(feature, hooks)
    (jv, jstate2, jm, jg, jhg), (tv, state2, tm, tg, thg) = _run_hook_pair(
        jhook, params, jstate, hook, state, _hook_inputs(), feature)
    close(tv, jv, rtol=RTOL, atol=ATOL, what="loss")
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k], rtol=RTOL, atol=ATOL, what=k)
    assert set(state2) == set(jstate2)
    for k in jstate2:
        close(state2[k], jstate2[k], rtol=RTOL, atol=ATOL, what=k)
    for i, (a, b) in enumerate(zip(tg, jg)):
        if a is None:                  # an input the hook does not read
            assert not np.asarray(b).any(), i
        else:
            close(a, b, rtol=RTOL, atol=ATOL, what=f"d input {i}")
    if params is not None:
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(thg)[0], jax.tree.leaves(jhg)):
            close(a, b, rtol=RTOL, atol=ATOL, what=f"d head {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("use_dynamic", [True, False])
def test_imsat_weight_over_two_steps(use_dynamic):
    """The imsat weight is hook state: ``w += (log K - mean marginal) *
    0.01`` after each loss with ``use_dynamic``, unchanged without; the
    second loss reads the first's weight."""
    tiny = {"imsat": dict(TINY["imsat"], use_dynamic=use_dynamic)}
    jhook, params, jstate, hook, state = _hook_pair("Up_conv2", tiny)
    weights = []
    for seed in (0, 10):
        (_, jstate, jm, _, _), (_, state, tm, _, _) = _run_hook_pair(
            jhook, params, jstate, hook, state, _hook_inputs(seed), "Up_conv2")
        close(tm["imsat_weight"], jm["imsat_weight"], rtol=RTOL, atol=ATOL)
        close(state["imsat_weight"], jstate["imsat_weight"], rtol=RTOL, atol=ATOL)
        weights.append(float(state["imsat_weight"]))
    assert (weights[0] != 1.3 and weights[1] != weights[0]) if use_dynamic else \
        weights == [np.float32(1.3)] * 2


def test_save_true_raises_and_unknown_tiny_hooks_too():
    """Unknown tiny hooks raise. ``save: true`` raised until the figure
    savers were ported; it now builds the hook, which emits the joint
    figure (``tests/test_torch_writer.py``)."""
    hook = CrossCorrelationHook(name="cc", feature_name="Up_conv2", in_dim=16, hooks={},
                                save=True)
    assert hook._save
    with pytest.raises(ValueError, match="unknown tiny hooks"):
        CrossCorrelationHook(name="cc", feature_name="Up_conv2", in_dim=16, hooks={"xx": {}})


def test_two_sections_on_one_feature_collide_as_in_jax():
    """``CrossCorrelationParameters`` and another ``*CrossCorrelationParameters*``
    section on the same feature both name their hook ``cc_Up_conv2``: the
    run refuses the duplicate name."""
    config = merge(_BASE, {"CrossCorrelationParameters": CC2,
                           "DecoderCrossCorrelationParameters": CC2})
    hooks = create_hook_from_config(config, channel_dim=UNet(max_channel=32).get_channel_dim)
    assert [h.name for h in hooks] == ["cc_Up_conv2", "cc_Up_conv2"]
    with pytest.raises(ValueError, match="duplicate hook names"):
        build_semi_run(config, device="cpu", dtype=torch.float32, raw_size=40, crop=32,
                       n_slices=8, max_channel=32)


def _load_cc_heads(hooks, hparams):
    for h in hooks:
        if isinstance(h, CrossCorrelationHook):
            h.projector.load_state_dict(flax_to_cluster_head_state_dict(hparams[h.name]))
        else:
            h.projector.load_state_dict(flax_to_head_state_dict(hparams[h.name]))


def _head_tree(h):
    if isinstance(h, CrossCorrelationHook):
        return cluster_head_state_dict_to_flax(h.projector.state_dict(), dense=True)
    return head_state_dict_to_flax(h.projector.state_dict())


def test_semi_step_with_ccblocks2_matches_jax():
    """config/base.yaml + config/hooks/ccblocks2.yaml under ``semi``: cc +
    rr on Up_conv2, 20 clusters, the mlp head bridged from JAX's init."""
    config = simple_config({"CrossCorrelationParameters": CC2})
    model = port_model(6)
    hooks = create_hook_from_config(config, channel_dim=model.get_channel_dim)
    jhooks = jcreate_hooks(config)
    assert [h.name for h in hooks] == [h.name for h in jhooks] == ["cc_Up_conv2"]
    b, key = batch(6), jax.random.PRNGKey(9)
    params, hparams, jnew, jm = jax_step(model, b, key, jhooks)
    _load_cc_heads(hooks, hparams)
    bundle, state = port_state(model, hooks)
    m = build_train_step(bundle, hooks)(state, {k: torch.tensor(v) for k, v in b.items()},
                                        replayed_draws(key))
    assert set(jm) == set(m)
    check_metrics(m, jm)
    check_model(state, params, jnew)
    h = hooks[0]
    check_updates(jax.tree.map(lambda a, b: a - b, _head_tree(h), hparams[h.name]),
                  jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.hook_params[h.name],
                               hparams[h.name]), what="update head")


def test_pretrain_decoder_step_with_infonce_encoder_and_ccblocks2_matches_jax(fast_jax_bundle):
    """``pretrain_decoder`` with config/hooks/infonce_encoder.yaml and
    ccblocks2.yaml (the ``pretrain_cc`` preset): the cut at Up_conv2,
    Deconv_1x1 frozen, the metrics, every trainable tensor's update and the
    BN statistics against JAX's step; the bounds of tests/test_torch_step.py
    at tests/test_torch_pretrain.py's lr 0.1, but for the ``cc`` metric
    (:data:`CC_RTOL`)."""
    sections = {"InfonceParams": {"feature_names": "Conv5", "weights": 1.0,
                                  "contrast_ons": "partition", "spatial_size": 1},
                "CrossCorrelationParameters": CC2}
    b = pretrain_batch()
    key = jax.random.PRNGKey(7)
    jhooks, (params, stats, hparams), jnew, jm = jax_pretrain_step(None, b, key,
                                                                  sections=sections)
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    hooks = create_hook_from_config(_hook_config(sections), channel_dim=model.get_channel_dim,
                                    is_pretrain=True)
    check_pretrain_hooks(hooks)
    assert [h.name for h in hooks] == [h.name for h in jhooks] == ["infonce/Conv5/partition",
                                                                   "cc_Up_conv2"]
    _load_cc_heads(hooks, hparams)
    until = feature_until_from_hooks(*hooks)
    assert until == "Up_conv2"
    trainable = pretrain_trainable(until)
    opt, _ = create_optimizer([p for k, p in model.named_parameters() if trainable(k)]
                              + hook_parameters(hooks), PRE_OPTIM, PRE_SCHED, max_epoch=75,
                              steps_per_epoch=200)
    bundle = ModelBundle(model, (S, S, 1))
    state = init_train_state(bundle, hooks, opt)
    m = build_pretrain_step(bundle, hooks, until=until)(
        state, {k: torch.tensor(v) for k, v in b.items()}, _replayed_draws(key, 6, (16, 16)))
    assert set(m) == set(jm)
    for k in jm:
        close(m[k], jm[k], rtol=CC_RTOL if k.endswith("/cc") else 1e-4, atol=1e-7, what=k)
    new = state_dict_to_flax(model.state_dict())
    np.testing.assert_array_equal(new["params"]["Deconv_1x1"]["kernel"],
                                  params["Deconv_1x1"]["kernel"])
    live = [k for k in new["params"] if k != "Deconv_1x1"]
    check_updates({k: jax.tree.map(lambda a, b: a - b, new["params"][k], params[k]) for k in live},
                  {k: jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.params[k], params[k])
                   for k in live})
    for h in hooks:
        check_updates(jax.tree.map(lambda a, b: a - b, _head_tree(h), hparams[h.name]),
                      jax.tree.map(lambda a, b: np.asarray(a) - b, jnew.hook_params[h.name],
                                   hparams[h.name]), what=f"update {h.name}")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jnew.batch_stats)):
        scaled_close(a, b, tol=1e-3, what=f"stats {jax.tree_util.keystr(path)}")


def test_train_encoder_false_freezes_the_whole_encoder():
    """``CrossCorrelationParameters.train_encoder: false`` under
    ``pretrain_decoder``: every encoder parameter bit-unchanged after two
    steps, the decoder up to the cut and the head moved, Deconv_1x1 frozen;
    the mask is JAX's ``_param_labels`` AND-merge."""
    cfg = merge(parse_config(["-o", "Trainer.name=pretrain_decoder", "~InfonceParams",
                              "Optim.lr=1e-2"]),
                {"CrossCorrelationParameters": dict(CC2, train_encoder=False)})
    assert frozen_encoder(cfg) and not frozen_encoder({"CrossCorrelationParameters": CC2})
    run = build_pretrain_run(cfg, device="cpu", dtype=torch.float32, raw_size=36, crop=32,
                             n_scans=6, max_channel=32)
    before = {k: v.clone() for k, v in run.state.model.named_parameters()}
    run.run(2)
    moved = {k.split(".")[0].lstrip("_") for k, v in run.state.model.named_parameters()
             if not torch.equal(v, before[k])}
    assert moved == {"Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3", "Up2", "Up_conv2"}
    trainable = pretrain_trainable("Up_conv2", True)
    assert [n for n in UNet.arch_elements if trainable(f"_{n}.w")] == sorted(
        moved, key=UNet.arch_elements.index)


#: a short CPU run of ``main.main``
SMALL = ["Data.labeled_scan_num=1", "LabeledLoader.batch_size=2", "UnlabeledLoader.batch_size=2",
         "Trainer.num_batches=2", "Trainer.device=cpu", "Arch.max_channel=32"]
#: config/hooks/ccblocks_imsat.yaml in the override form
CC_IMSAT_ARGV = ["~InfonceParams", "+CrossCorrelationParameters.feature_name=Up_conv2",
                 "+CrossCorrelationParameters.train_encoder=true",
                 "+CrossCorrelationParameters.num_clusters=20",
                 "+CrossCorrelationParameters.head_type=mlp",
                 "+CrossCorrelationParameters.num_subheads=1",
                 "+CrossCorrelationParameters.save=false",
                 "+CrossCorrelationParameters.hooks.cc.weight=0.1",
                 "+CrossCorrelationParameters.hooks.cc.kernel_size=5",
                 "+CrossCorrelationParameters.hooks.cc.diff_power=0.75",
                 "+CrossCorrelationParameters.hooks.imsat.weight=0.1",
                 "+CrossCorrelationParameters.hooks.imsat.use_dynamic=true"]


@pytest.fixture
def layout(tmp_path, monkeypatch):
    synthesize_acdc_like(tmp_path / "data", num_train_scans=4, num_val_scans=2,
                         slices_per_scan=6, size=32)
    monkeypatch.setattr(package, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(package, "RUN_PATH", str(tmp_path / "runs"))
    return tmp_path / "runs"


def test_pretrain_clusters_loop_writes_jax_columns(layout, tmp_path, fast_jax_bundle):
    """``pretrain_decoder`` with ccblocks_imsat.yaml's section (the
    ``pretrain_clusters`` preset) for 2 epochs: ``storage.csv``'s header
    equals JAX's trainer's, and the logged imsat weight moves between
    epochs (hook state across epochs)."""
    argv = ["-o", "Trainer.name=pretrain_decoder", *CC_IMSAT_ARGV, "Trainer.max_epoch=2",
            "Trainer.save_dir=clusters", "ContrastiveLoaderParams.scan_sample_num=1", *SMALL]
    cfg = port_main.parse_config(argv)
    assert cfg["CrossCorrelationParameters"] == CC_IMSAT
    assert port_main.main(argv) == 0
    run = layout / "clusters"
    assert (run / ".success").exists() and (run / "last").is_dir()
    lines = (run / "storage.csv").read_text().splitlines()
    header = lines[0].split(",")
    rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
    col = "tra/cc_Up_conv2/metrics/imsat_weight"
    assert len(rows) == 2 and rows[0][col] != rows[1][col]
    assert all(np.isfinite(float(v)) for row in rows for k, v in row.items() if k)
    jcfg = dict(cfg, Trainer=dict(cfg["Trainer"], max_epoch=1))
    assert header == jax_storage_columns(jcfg, tmp_path)


def test_ccblocks2_semi_preset_runs_from_the_yaml_files(layout):
    """``-p config/base.yaml config/hooks/ccblocks2.yaml -o Trainer.name=semi``
    on the CPU: the files of a ``semi`` run and the hook's columns."""
    argv = ["-p", str(REPO / "config/base.yaml"), str(REPO / "config/hooks/ccblocks2.yaml"),
            "-o", "Trainer.name=semi",
            "Trainer.max_epoch=1", "Trainer.save_dir=cc", *SMALL]
    assert port_main.main(argv) == 0
    run = layout / "cc"
    for f in (".success", "storage.csv", "inference_result.json"):
        assert (run / f).exists(), f
    header = (run / "storage.csv").read_text().splitlines()[0].split(",")
    assert {f"tra/cc_Up_conv2/metrics/{k}" for k in ("cc", "loss", "rr")} <= set(header)
