"""The port's dense-IIC joints (contrastyou_tpu_torch/ops/iic.py), discrete-MI
losses (losses/discrete_mi.py) and discrete-MI / output-space MI hooks
(hooks/discretemi.py, hooks/midl.py) held against the JAX package on the CPU.

The plain E1/E2 (the CPU side of the kernels) face the Pallas kernel
``fused_dense_iic_raw_joints`` itself, run in interpret mode on the CPU as
tests/test_iic_kernel.py runs it, and its ``jax.vjp``; the hooks face the JAX
hooks on their default CPU path (the merged XLA form).

Tolerances (f32): raw joints rtol/atol 2e-5 and gradients rtol 3e-4 / atol
3e-5, the bounds tests/test_iic_kernel.py holds the Pallas kernel to against
the merged XLA path (the same sums in another order; the kernel folds 1/T
into the weights). Losses rtol 1e-5 / atol 1e-6 (their gradients 1e-4 /
1e-6); a hook's loss rtol 1e-4 / atol 1e-6 (a feature map's nearest-
neighbour warp and the min-shift normalization in between).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.hooks.discretemi import DiscreteIMSATTrainHook as JIMSATFeature
from contrastyou_tpu.hooks.discretemi import DiscreteMITrainHook as JDiscreteMI
from contrastyou_tpu.hooks.midl import IIDSegmentationTrainerHook as JIIDSeg
from contrastyou_tpu.hooks.midl import IMSATTrainHook as JIMSAT
from contrastyou_tpu.engine.hooks import StepContext as JContext
from contrastyou_tpu.losses import discrete_mi as jmi
from contrastyou_tpu.ops.affine import identity_geo_params, sample_geo_params
from contrastyou_tpu.ops.pallas.iic import fused_dense_iic_raw_joints as jfused
from contrastyou_tpu_torch.engine.hooks import StepContext
from contrastyou_tpu_torch.hooks.discretemi import DiscreteIMSATTrainHook, DiscreteMITrainHook
from contrastyou_tpu_torch.hooks.midl import IIDSegmentationTrainerHook, IMSATTrainHook
from contrastyou_tpu_torch.losses import discrete_mi as mi
from contrastyou_tpu_torch.ops import iic
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import flax_to_cluster_head_state_dict
from torch_parity import close, n, t

torch.set_num_threads(1)

K, C = 20, 16
RAW_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")


def _inputs(S, B=2, H=16, W=12, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((C, S * K)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S * K,)) * 0.1).astype(np.float32)
    return f1, f2, w, b


def _jax_joints(w, b, f1, f2, S, padding, T):
    return jfused(jnp.asarray(w), jnp.asarray(b), jnp.asarray(f1), jnp.asarray(f2),
                  num_subheads=S, num_clusters=K, padding=padding, T=T)


@pytest.mark.parametrize("padding", [0, 1, 2])
@pytest.mark.parametrize("S,T", [(3, 0.5), (5, 1.0)])
def test_plain_joints_and_vjp_match_the_pallas_kernel(padding, S, T):
    """Raw joints [S, Td, Td, K, K] of an asymmetric image (16 x 12) and the
    gradients of <raw, Jbar> for a random Jbar in f1, f2, w and b (the
    latter two through the 1/T fold)."""
    f1, f2, w, b = _inputs(S)
    args = (jnp.asarray(w), jnp.asarray(b), jnp.asarray(f1), jnp.asarray(f2))
    jraw, vjp = jax.vjp(lambda *a: jfused(*a, num_subheads=S, num_clusters=K,
                                          padding=padding, T=T), *args)
    jbar = np.random.default_rng(1).standard_normal(jraw.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(jbar))

    ins = [t(a).requires_grad_() for a in (w, b, f1, f2)]
    raw = iic.fused_dense_iic_raw_joints(*ins, num_subheads=S, num_clusters=K,
                                         padding=padding, T=T)
    assert raw.shape == (S, 2 * padding + 1, 2 * padding + 1, K, K)
    close(raw, jraw, **RAW_TOL, what="raw joints")
    (raw * t(jbar)).sum().backward()
    for name, x, g in zip(("dw", "db", "df1", "df2"), ins, jgrads):
        close(x.grad, g, **GRAD_TOL, what=name)


@pytest.mark.parametrize("padding", [0, 1, 2])
def test_plain_backward_on_the_loss_cotangent_matches_jax(padding):
    """E2's plain version on the dense hook's own cotangent: the gradients in
    w, b, f1 and f2 of 0.05 x the summed IIC losses of the raw joints (min-
    shift normalized at padding > 0, divided by the pixel count at 0),
    against jax.grad through the Pallas kernel and the JAX loss. The loss
    normalizes the joints, so these gradients are 1e-7 to 1e-4: they are
    compared in units of the largest JAX gradient of the four, where
    GRAD_TOL's atol bounds the error relative to the gradient's scale rather
    than vacuously."""
    S, T = 3, 1.0
    f1, f2, w, b = _inputs(S, seed=6)
    count = f1.shape[0] * f1.shape[1] * f1.shape[2]

    def jloss(*a):
        raw = jfused(*a, num_subheads=S, num_clusters=K, padding=padding, T=T)
        return 0.05 * jmi.iid_loss_from_raw_joints(raw, padding=padding, count=count).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(f1), jnp.asarray(f2))
    ins = [t(a).requires_grad_() for a in (w, b, f1, f2)]
    raw = iic.fused_dense_iic_raw_joints(*ins, num_subheads=S, num_clusters=K,
                                         padding=padding, T=T)
    (0.05 * mi.iid_loss_from_raw_joints(raw, padding=padding, count=count).sum()).backward()
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads)
    for name, x, g in zip(("dw", "db", "df1", "df2"), ins, jgrads):
        close(x.grad / scale, np.asarray(g) / scale, **GRAD_TOL, what=name)


def test_plain_backward_is_the_vjp_of_the_plain_forward():
    """E2's plain version == torch autograd through E1's plain version (same
    folded parameters), at padding 1."""
    S, p = 3, 1
    f1, f2, w, b = (t(a) for a in _inputs(S, seed=4))
    jbar = torch.randn(S, 3, 3, K, K, generator=torch.Generator().manual_seed(2))
    ins = [x.clone().requires_grad_() for x in (f1, f2, w, b)]
    raw = iic.iic_joints_plain(*ins, num_subheads=S, num_clusters=K, padding=p)
    grads = torch.autograd.grad((raw * jbar).sum(), ins)
    got = iic.iic_joints_bwd_plain(f1, f2, w, b, jbar, num_subheads=S, num_clusters=K,
                                   padding=p)
    for name, a, r in zip(("df1", "df2", "dw", "db"), got, grads):
        close(a, r, rtol=1e-5, atol=1e-6, what=name)


def test_bf16_features_match_f32():
    """bf16-representable features passed as bf16 give the f32 joints and
    bf16 feature gradients (the kernel path's input dtype on a bf16 model)."""
    S = 3
    f1, f2, w, b = _inputs(S, seed=3)
    f1, f2 = (t(a).to(torch.bfloat16) for a in (f1, f2))
    kw = dict(num_subheads=S, num_clusters=K, padding=1)
    raw16 = iic.iic_joints(f1, f2, t(w), t(b), **kw)
    raw32 = iic.iic_joints(f1.float(), f2.float(), t(w), t(b), **kw)
    close(raw16, raw32, rtol=1e-5, atol=1e-5, what="bf16 vs f32")
    close(raw16, _jax_joints(w, b, n(f1), n(f2), S, 1, 1.0), **RAW_TOL, what="bf16 vs JAX")
    jbar = torch.randn(raw16.shape, generator=torch.Generator().manual_seed(0))
    df1, df2, dw, db = iic.iic_joints_bwd(f1, f2, t(w), t(b), jbar, **kw)
    assert df1.dtype == df2.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref = iic.iic_joints_bwd(f1.float(), f2.float(), t(w), t(b), jbar, **kw)
    close(dw, ref[2], rtol=1e-5, atol=1e-6, what="dw")
    close(df1, ref[0].to(torch.bfloat16), rtol=0, atol=0, what="df1")


# --- losses -----------------------------------------------------------------

def _simplex(shape, seed):
    return np.asarray(jax.nn.softmax(np.random.default_rng(seed).standard_normal(shape) * 2, -1),
                      np.float32)


def test_iid_loss_matches_jax():
    a, b = _simplex((40, 7), 0), _simplex((40, 7), 1)
    got = mi.iid_loss(t(a), t(b), lamb=1.5)
    ref = jmi.iid_loss(jnp.asarray(a), jnp.asarray(b), lamb=1.5)
    for g, r, what in zip(got, ref, ("loss", "loss_no_lamb", "joint")):
        close(g, r, rtol=1e-5, atol=1e-6, what=what)


@pytest.mark.parametrize("padding", [0, 1])
def test_iid_segmentation_loss_matches_jax(padding):
    a, b = _simplex((2, 9, 7, 5), 2), _simplex((2, 9, 7, 5), 3)
    ta = t(a).requires_grad_()
    got = mi.iid_segmentation_loss(ta, t(b), padding=padding, lamda=1.2)
    ref, jg = jax.value_and_grad(lambda x: jmi.iid_segmentation_loss(
        x, jnp.asarray(b), padding=padding, lamda=1.2))(jnp.asarray(a))
    close(got, ref, rtol=1e-5, atol=1e-6, what="loss")
    got.backward()
    close(ta.grad, jg, rtol=1e-4, atol=1e-6, what="grad")


@pytest.mark.parametrize("padding", [0, 1])
def test_iid_loss_from_raw_joints_matches_jax(padding):
    """Per-subhead losses and their gradient in the raw joints (which passes
    the detached minimum at padding > 0)."""
    td = 2 * padding + 1
    raw = np.random.default_rng(4).random((3, td, td, 6, 6)).astype(np.float32) * 50 + 1
    traw = t(raw).requires_grad_()
    got = mi.iid_loss_from_raw_joints(traw, padding=padding, count=900)
    ref, jvjp = jax.vjp(lambda r: jmi.iid_loss_from_raw_joints(r, padding=padding, count=900),
                        jnp.asarray(raw))
    close(got, ref, rtol=1e-5, atol=1e-6, what="losses")
    cot = np.arange(1, 4, dtype=np.float32)
    got.backward(t(cot))
    close(traw.grad, jvjp(jnp.asarray(cot))[0], rtol=1e-4, atol=1e-7, what="grad")


def test_imsat_loss_matches_jax():
    p = _simplex((3, 5, 6, 8), 5)
    close(mi.imsat_loss(t(p), lamda=0.7), jmi.imsat_loss(jnp.asarray(p), lamda=0.7),
          rtol=1e-5, atol=1e-6)
    for g, r in zip(mi.imsat_terms(t(p)), jmi.imsat_terms(jnp.asarray(p))):
        close(g, r, rtol=1e-5, atol=1e-6)


# --- hooks ------------------------------------------------------------------

B = 2
#: tapped layers at max_channel 128 on 16 x 12 slices: (shape, channels)
TAPS = {"Conv5": ((4, 3), 128), "Up_conv2": ((16, 12), 8)}


def _contexts(geo_key):
    """A JAX and a port StepContext on the same taps, logits and transform
    (identity when ``geo_key`` is None)."""
    rng = np.random.default_rng(7)
    taps = {k: rng.standard_normal((B, *hw, c)).astype(np.float32) for k, (hw, c) in TAPS.items()}
    taps_tf = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in taps.items()}
    logits = [rng.standard_normal((B, 16, 12, 4)).astype(np.float32) for _ in range(2)]
    geo = identity_geo_params(B) if geo_key is None else sample_geo_params(geo_key, B)
    jctx = JContext(unlabeled_taps={k: jnp.asarray(v) for k, v in taps.items()},
                    unlabeled_tf_taps={k: jnp.asarray(v) for k, v in taps_tf.items()},
                    unlabeled_tf_logits=jnp.asarray(logits[0]),
                    unlabeled_logits_tf=jnp.asarray(logits[1]), geo_params=geo,
                    rng=jax.random.PRNGKey(0), epoch=jnp.int32(0))
    ctx = StepContext(unlabeled_taps={k: t(v) for k, v in taps.items()},
                      unlabeled_tf_taps={k: t(v) for k, v in taps_tf.items()},
                      unlabeled_tf_logits=t(logits[0]), unlabeled_logits_tf=t(logits[1]),
                      geo_params=GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)))
    return jctx, ctx


def _head_params(jhook, layer, seed):
    _, c = TAPS[layer]
    return jhook._projector.init(jax.random.PRNGKey(seed), jnp.zeros((2, 8, 8, c)))["params"]


GEO = [None, jax.random.PRNGKey(5)]


def _check_hook(jhook, hook, layer, geo_key):
    jctx, ctx = _contexts(geo_key)
    params = _head_params(jhook, layer, 3)
    hook.projector.load_state_dict(flax_to_cluster_head_state_dict(params))
    jloss, _, jm = jhook.loss(jctx, params, {})
    loss, _, m = hook.loss(ctx, {})
    close(loss, jloss, rtol=1e-4, atol=1e-6, what=hook.name)
    assert set(m) == set(jm)
    for k in m:
        close(m[k], jm[k], rtol=1e-4, atol=1e-6, what=f"{hook.name}/{k}")


@pytest.mark.parametrize("geo_key", GEO, ids=["identity", "random"])
@pytest.mark.parametrize("layer,padding", [("Conv5", None), ("Up_conv2", 0), ("Up_conv2", 1)])
def test_discrete_mi_hook_matches_jax(layer, padding, geo_key):
    kw = dict(name="iic", feature_name=layer, weight=0.1, padding=padding)
    _check_hook(JDiscreteMI(**kw), DiscreteMITrainHook(in_dim=TAPS[layer][1], **kw), layer,
                geo_key)


@pytest.mark.parametrize("geo_key", GEO, ids=["identity", "random"])
@pytest.mark.parametrize("layer", ["Conv5", "Up_conv2"])
def test_discrete_imsat_hook_matches_jax(layer, geo_key):
    kw = dict(name="imsat_f", feature_name=layer, weight=0.1, num_clusters=10, num_subheads=3,
              cons_weight=0.5)
    _check_hook(JIMSATFeature(**kw), DiscreteIMSATTrainHook(in_dim=TAPS[layer][1], **kw),
                layer, geo_key)


@pytest.mark.parametrize("geo_key", GEO, ids=["identity", "random"])
def test_output_space_hooks_match_jax(geo_key):
    jctx, ctx = _contexts(geo_key)
    for jhook, hook in ((JIIDSeg(hook_name="iidseg", weight=0.1, mi_lambda=1.3),
                         IIDSegmentationTrainerHook(hook_name="iidseg", weight=0.1,
                                                    mi_lambda=1.3)),
                        (JIMSAT(hook_name="imsat"), IMSATTrainHook(hook_name="imsat"))):
        close(hook.loss(ctx, {})[0], jhook.loss(jctx, None, {})[0], rtol=1e-5, atol=1e-6,
              what=hook.name)
