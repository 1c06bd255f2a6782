"""The differentiable mean teacher of the port (contrastyou_tpu_torch/hooks/dmt.py,
trainers/dmt.py, losses/dice.py) and the differentiable backward of the
conv-block kernels it needs (ops/convblock.py), held against the JAX package
on the CPU.

- The double backward: for each kernel's Function (K1 with and without a
  skip and with the statistics' cotangents, on the 3x3 path below 8 input
  channels and on C2's above; K2; K3; C1 on the 3x3 and on Up2's taps; C2)
  the Hessian-vector product of ``sum(c * tanh(out))`` (plus the
  statistics) on the plain versions against ``jax.jvp(jax.grad(...))`` of
  the same function written with XLA convs, relative L2 1e-5 (f32 on both
  sides; measured ~1e-6). The same for the small U-Net's ``second_order``
  inner loss (max_channel 128, 32 x 32, f32): against JAX in f64 1e-3 per
  tensor, against JAX in f32 op by op 1e-1 / 5e-2, because JAX's f32
  second derivative through BN is the noisier side (see the test). A
  stand-in backward that returns detached buffers (the raw-launch path
  under ``create_graph``) fails both comparisons and makes the hook raise.
- One ``semi`` step pair (two steps) per ``method_name`` against JAX's
  ``build_train_step`` from the same weights and draws: losses and hook
  metrics rtol 1e-4, the student's and the teacher's updates per tensor
  3e-2 and together 2e-2 in L2 (tests/test_torch_mt.py's bounds), the
  teacher's statistics 1e-3 of the largest value, Adam's moments 5e-2 in
  L2 and its count, ``ema_step`` (method1 and method3: the teacher's Adam
  update as ``_check_adam_teacher`` says, and :func:`adam_step` against
  optax to f32 rounding).
- ``second_order``'s Hessian term alone: the student gradient of the meta
  loss less its first-order part (1 - alpha) d(meta)/d(t1), against JAX's
  from the same recipe in f64, relative L2 2e-3, and over 10% of the
  gradient.
- ``dice_loss`` against JAX, and ``dice`` as the meta criterion.
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
from contrastyou_tpu.hooks import dmt as jdmt
from contrastyou_tpu.losses import dice as jdice
from contrastyou_tpu.losses.kl import kl_div as jkl
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.models import unet as jax_unet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import StepDraws, build_train_step, init_train_state
from contrastyou_tpu_torch.hooks import dmt
from contrastyou_tpu_torch.losses import dice
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops import convblock as cb
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import (_adam_state, flax_to_hook_state,
                                                        flax_to_state_dict, hook_state_to_flax,
                                                        state_dict_to_flax)
from torch_parity import close, n, scaled_close, t

torch.set_num_threads(1)

NL, NU, S, C, MC = 2, 2, 32, 4, 128
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}
#: config/hooks/dmt.yaml's values (weight, alpha, decay, meta_weight)
HOOK = dict(weight=10.0, alpha=0.99, weight_decay=1e-6, meta_weight=1e-3)
HV_TOL = 1e-5


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _l2(a, b):
    a, b = n(a), n(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- the double backward of each kernel's Function -------------------------------

def _jconv(x, w):
    return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=jax.lax.Precision.HIGHEST)


def _jparity(x, taps):
    """conv3x3(upsample2x(x)) from the parity taps [4, 4, Cin, Cout]."""
    B, H, W, _ = x.shape
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = jnp.zeros((B, 2 * H, 2 * W, taps.shape[-1]), x.dtype)
    for p in range(4):
        a, b = divmod(p, 2)
        acc = 0.0
        for tp in range(4):
            dy, dx = cb._parity_offsets(p, tp)
            acc = acc + jnp.einsum("bhwi,io->bhwo", xp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W],
                                   taps[p, tp], precision=jax.lax.Precision.HIGHEST)
        out = out.at[:, a::2, b::2].set(acc)
    return out


def _stats_loss(out, s, sq, c, cs, cq):
    return (jnp.tanh(out) * c).sum() + 0.01 * (s * cs).sum() + 1e-3 * (sq * cq).sum()


def _jfns(name):
    """JAX's function of the same inputs -> its list of outputs."""
    if name.startswith("k1"):
        def f(x, w, *skip):
            out = _jconv(x, w) + (_jconv(*skip) if skip else 0.0)
            return [out, out.sum((1, 2)), (out * out).sum((1, 2))]
    elif name == "k2":
        def f(x, k3):
            up = jnp.repeat(jnp.repeat(x, 2, 1), 2, 2)
            out = _jconv(up, k3)
            return [out, out.sum((1, 2)), (out * out).sum((1, 2))]
    elif name == "k3":
        def f(g, taps):
            x0 = jnp.zeros((g.shape[0], g.shape[1] // 2, g.shape[2] // 2, taps.shape[2]))
            return [jax.vjp(lambda x: _jparity(x, taps), x0)[1](g)[0]]
    elif name == "c1":
        def f(x, g):
            w0 = jnp.zeros((3, 3, x.shape[-1], g.shape[-1]))
            return [jax.vjp(lambda w: _jconv(x, w), w0)[1](g)[0].reshape(9, *w0.shape[2:])]
    elif name == "c1_up2":
        def f(x, g):
            t0 = jnp.zeros((4, 4, x.shape[-1], g.shape[-1]))
            return [jax.vjp(lambda tp: _jparity(x, tp), t0)[1](g)[0].reshape(16, *t0.shape[2:])]
    else:                                          # c2
        def f(x, w, g):
            dx, dw = jax.vjp(lambda a, b: _jconv(a, b), x, w)[1](g)
            return [dx, dw]
    return f


def _port_fns(name):
    if name.startswith("k1"):
        return lambda x, w, *skip: list(cb.conv3x3_bn_stats(x, w, *skip))
    return {"k2": lambda x, k3: list(cb.upconv3x3_bn_stats(x, k3)),
            "k3": lambda g, taps: [cb._UpconvDx.apply(g, taps)],
            "c1": lambda x, g: [cb._ConvDw.apply(x, g, False)],
            "c1_up2": lambda x, g: [cb._ConvDw.apply(x, g, True)],
            "c2": lambda x, w, g: list(cb._Conv3x3Bwd.apply(x, w, g))}[name]


#: (inputs' shapes) per case: B 2, 6 x 6 images
HV_CASES = {"k1": [(2, 6, 6, 3), (3, 3, 3, 4)],
            "k1_skip": [(2, 6, 6, 3), (3, 3, 3, 4), (2, 6, 6, 3), (3, 3, 3, 4)],
            "k1_fused": [(2, 6, 6, 8), (3, 3, 8, 4)],
            "k1_fused_skip": [(2, 6, 6, 8), (3, 3, 8, 4), (2, 6, 6, 8), (3, 3, 8, 4)],
            "k2": [(2, 4, 4, 3), (3, 3, 3, 4)],
            "k3": [(2, 8, 8, 4), (4, 4, 3, 4)],
            "c1": [(2, 6, 6, 3), (2, 6, 6, 4)],
            "c1_up2": [(2, 4, 4, 3), (2, 8, 8, 4)],
            "c2": [(2, 6, 6, 8), (3, 3, 8, 4), (2, 6, 6, 4)]}


def _hv_inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    ins = [rng.normal(0, 0.5, s).astype(np.float32) for s in HV_CASES[name]]
    vs = [rng.normal(0, 1, s).astype(np.float32) for s in HV_CASES[name]]
    outs = _jfns(name)(*map(jnp.asarray, ins))
    cot = [rng.normal(0, 1, np.shape(o)).astype(np.float32) for o in outs]
    return ins, vs, cot


def _jax_hv(name, ins, vs, cot):
    f = _jfns(name)

    def loss(*xs):
        outs = f(*xs)
        if len(outs) == 3:
            return _stats_loss(*outs, *map(jnp.asarray, cot))
        return sum((jnp.tanh(o) * jnp.asarray(c)).sum() for o, c in zip(outs, cot))

    grad = jax.grad(loss, argnums=tuple(range(len(ins))))
    return jax.jvp(grad, tuple(map(jnp.asarray, ins)), tuple(map(jnp.asarray, vs)))[1]


def port_hv(fn, ins, vs, cot):
    """H v of the port's ``fn`` by double backward."""
    xs = [t(a).requires_grad_() for a in ins]
    outs = fn(*xs)
    if len(outs) == 3:
        c, cs, cq = map(t, cot)
        loss = (torch.tanh(outs[0]) * c).sum() + 0.01 * (outs[1] * cs).sum() \
            + 1e-3 * (outs[2] * cq).sum()
    else:
        loss = sum((torch.tanh(o) * t(c)).sum() for o, c in zip(outs, cot))
    grads = torch.autograd.grad(loss, xs, create_graph=True)
    dot = sum((g * t(v)).sum() for g, v in zip(grads, vs))
    if not dot.requires_grad:                    # a backward that kept no graph
        return [torch.zeros_like(x) for x in xs]
    return torch.autograd.grad(dot, xs, allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("name", sorted(HV_CASES))
def test_double_backward_matches_jax(name):
    ins, vs, cot = _hv_inputs(name)
    want = _jax_hv(name, ins, vs, cot)
    got = port_hv(_port_fns(name), ins, vs, cot)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _l2(g, w) <= HV_TOL, f"{name} input {i}: {_l2(g, w):.3e}"
        assert np.linalg.norm(n(w)) > 0


def _detached_backward(monkeypatch):
    """The create-graph branch taken out: every backward helper returns the
    raw launches' detached buffers, as a Function without a differentiable
    backward would."""
    for name in ("_conv", "_dw", "_bwd_fused", "_upconv", "_updx"):
        fn = getattr(cb, name)

        def stand_in(*args, _fn=fn, **kwargs):
            with torch.no_grad():
                return _fn(*args, **kwargs)

        monkeypatch.setattr(cb, name, stand_in)


@pytest.mark.parametrize("name", ["k1_fused_skip", "k2"])
def test_detached_backward_fails_the_comparison(name, monkeypatch):
    ins, vs, cot = _hv_inputs(name)
    want = _jax_hv(name, ins, vs, cot)
    _detached_backward(monkeypatch)
    got = port_hv(_port_fns(name), ins, vs, cot)
    assert max(_l2(g, w) for g, w in zip(got, want)) > 1e-2


# --- the small U-Net's inner loss ------------------------------------------------

def _weights(seed, max_channel=MC):
    """Port-initialized U-Net weights with running statistics away from 0
    and 1 -> (params, stats) numpy trees."""
    model = UNet(max_channel=max_channel, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(seed))
    tree = state_dict_to_flax(model.state_dict())
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if jax.tree_util.keystr(p).endswith(
            "['var']") else rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        tree["batch_stats"])
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.02, a.shape).astype(np.float32),
                          tree["params"])
    return params, stats


def _jbundle(params, stats):
    return JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=jnp.float32),
                   jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                   (S, S, 1))


def _port_model(params, stats):
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model


def _inner_inputs(seed=0):
    rng = np.random.default_rng(seed)
    lab = rng.random((NL, S, S, 1)).astype(np.float32)
    target = rng.integers(0, C, (NL, S, S))
    unl_tf = rng.random((NU, S, S, 1)).astype(np.float32)
    t_target = rng.dirichlet(np.ones(C), (NU, S, S)).astype(np.float32)
    return lab, target, unl_tf, t_target


def _jax_inner(bundle, lab, target, unl_tf, t_target):
    onehot = jax.nn.one_hot(target, C)

    def inner(p):
        (l_logits, _), _ = bundle.apply_train(p, bundle.batch_stats, lab, update_stats=False)
        (u_logits, _), _ = bundle.apply_train(p, bundle.batch_stats, unl_tf, update_stats=False)
        sup = jkl(jax.nn.softmax(l_logits, -1), onehot)
        return sup + 0.1 * jnp.mean((t_target - jax.nn.softmax(u_logits, -1)) ** 2)

    return inner


def _port_inner(model, lab, target, unl_tf, t_target):
    onehot = torch.nn.functional.one_hot(torch.tensor(target), C).float()
    l_logits = model(t(lab), train=True, update_stats=False)[0]
    u_logits = model(t(unl_tf), train=True, update_stats=False)[0]
    sup = dmt.kl_div(torch.softmax(l_logits, -1), onehot)
    return sup + 0.1 * torch.mean((t(t_target) - torch.softmax(u_logits, -1)) ** 2)


def _unet_hv(model, inputs, v):
    params = list(model.parameters())
    grads = torch.autograd.grad(_port_inner(model, *inputs), params, create_graph=True)
    dot = sum((g * vv).sum() for g, vv in zip(grads, v))
    if not dot.requires_grad:
        return [torch.zeros_like(p) for p in params]
    return torch.autograd.grad(dot, params, allow_unused=True, materialize_grads=True)


def _jax_unet_hv(params, stats, inputs, v, dtype, *, op_by_op):
    """JAX's H v of the inner loss with the weights and inputs in ``dtype``
    (jitted, or op by op with ``jax.disable_jit``)."""
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
    bundle = JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=dtype), cast(params),
                     cast(stats), (S, S, 1))
    ins = [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a) for a in inputs]
    inner = _jax_inner(bundle, *ins)
    with jax.disable_jit(op_by_op):
        hv = jax.jit(lambda p, d: jax.jvp(jax.grad(inner), (p,), (d,))[1])(cast(params), cast(v))
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(hv)]


@pytest.fixture(scope="module")
def unet_hv():
    """The inputs, and JAX's H v of the inner loss op by op in f32 and
    jitted in f64 (x64 on, the f32 casts of JAX's U-Net, its BN statistics,
    promoted to f64)."""
    params, stats = _weights(1)
    inputs = _inner_inputs()
    rng = np.random.default_rng(2)
    v = jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
    f32 = _jax_unet_hv(params, stats, inputs, v, jnp.float32, op_by_op=True)
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unet, "jnp", promoted)
        f64 = _jax_unet_hv(params, stats, inputs, v, jnp.float64, op_by_op=False)
    return params, stats, inputs, v, f32, f64


def _port_unet_hv(params, stats, inputs, v):
    """The port's H v (f32, plain versions) as flax-ordered leaves."""
    model = _port_model(params, stats)
    vd = flax_to_state_dict(v, stats)
    names = [k for k, _ in model.named_parameters()]
    got = _unet_hv(model, inputs, [vd[k] for k in names])
    tree = state_dict_to_flax({**dict(zip(names, got)), **dict(model.named_buffers())})
    return jax.tree.leaves(tree["params"])


def _flat(leaves):
    return np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in leaves])


def test_unet_inner_loss_hessian_vector_matches_jax(unet_hv):
    """Every parameter's H v of ``second_order``'s inner loss: the
    kernel-path levels (all of them at this width) through the
    differentiable Functions, BN and the head through torch's own double
    backward.

    - Against JAX in f64: 1e-3 per tensor and over all (measured: 6.0e-5 on
      the worst tensor, 1.4e-5 over all).
    - Against JAX in f32, op by op: 1e-1 per tensor, 5e-2 over all, because
      JAX's f32 second derivative is that far from its own f64 one here
      (3.4e-2 on BN scales of Conv1, measured); the port's f32 is not."""
    params, stats, inputs, v, f32, f64 = unet_hv
    got = _port_unet_hv(params, stats, inputs, v)
    for want, tensor_bound, all_bound in ((f64, 1e-3, 1e-3), (f32, 1e-1, 5e-2)):
        errs = [_l2(a, b) for a, b in zip(got, want)]
        assert max(errs) <= tensor_bound, max(errs)
        assert _l2(_flat(got), _flat(want)) <= all_bound
        assert all(np.linalg.norm(w) > 0 for w in want)


def test_detached_backward_fails_the_unet_comparison(unet_hv, monkeypatch):
    """Without the create-graph branch the conv weights' H v comes back
    zero and the comparison with JAX fails."""
    params, stats, inputs, v, _, f64 = unet_hv
    _detached_backward(monkeypatch)
    got = _port_unet_hv(params, stats, inputs, v)
    assert _l2(_flat(got), _flat(f64)) > 1e-1


# --- one step pair per update rule ---------------------------------------------

def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, C, (NL, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}


def _replayed_draws(key):
    k_geo, k_int, _ = jax.random.split(key, 3)
    gammas = jax.random.uniform(k_int, (NU, 1, 1, 1), minval=0.5, maxval=2.0)
    geo = sample_geo_params(k_geo, NU)
    return StepDraws(GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                     t(gammas).reshape(NU), {})


def _check_updates(got, ref, init, what):
    """Changes from ``init``: per tensor L2 <= 3e-2, together <= 2e-2."""
    upd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(got),
                                                          jax.tree.leaves(init))]
    jupd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(ref),
                                                           jax.tree.leaves(init))]
    errs = [_l2(a, b) for a, b in zip(upd, jupd)]
    assert max(errs) <= 3e-2, f"{what}: {max(errs):.3e}"
    assert _l2(_flat(upd), _flat(jupd)) <= 2e-2, what


def _run_steps(method, meta_criterion="ce", steps=2):
    """Two ``semi`` steps of JAX's and the port's step with the DMT hook from
    the same weights, batch and draws -> (port state, JAX state, metrics
    pairs, initial params)."""
    kw = dict(HOOK, meta_criterion=meta_criterion, method_name=method)
    jhook = jdmt.DifferentiableMeanTeacherTrainerHook(name="dmt", **kw)
    hook = dmt.DifferentiableMeanTeacherTrainerHook(name="dmt", **kw)
    params, stats = _weights(6)
    batch = _batch()
    jb = _jbundle(params, stats)
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    jstate = jinit(jb, [jhook], tx, jax.random.PRNGKey(1))
    jstep = jax.jit(jbuild(jb, tx, [jhook], raw=True, two_stage=True, mode="semi"))
    model = _port_model(params, stats)
    bundle = ModelBundle(model, (S, S, 1))
    opt, _ = create_optimizer(model.parameters(), OPTIM, SCHED, max_epoch=75,
                              steps_per_epoch=200)
    state = init_train_state(bundle, [hook], opt)
    state.hook_states["dmt"] = flax_to_hook_state(jstate.hook_states["dmt"])
    step = build_train_step(bundle, [hook])
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    pairs = []
    for i in range(steps):
        key = jax.random.PRNGKey(7 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           jnp.int32(1))
        pairs.append((step(state, tb, _replayed_draws(key), 1), jm))
    return state, jstate, pairs, params


def _check_adam_teacher(got, ref, init):
    """The teacher after two Adam steps of ``method1`` / ``method3``: Adam
    divides each element's meta gradient by its own magnitude, so an element
    whose gradient is near f32 noise moves by ~lr on either side whatever
    the gradient's value (0.3% of the conv elements flip sign between JAX
    and the port here, measured). Held: the update per tensor 1.5e-1 and
    over all 6e-2 in L2 (measured 8.5e-2 and 3.6e-2), and at most 1% of
    the elements apart by more than lr / 2 (measured 0.07%); the moments
    and :func:`adam_step` itself are held tightly elsewhere."""
    upd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(got),
                                                          jax.tree.leaves(init))]
    jupd = [np.asarray(a, np.float64) - b for a, b in zip(jax.tree.leaves(ref),
                                                           jax.tree.leaves(init))]
    assert max(_l2(a, b) for a, b in zip(upd, jupd)) <= 1.5e-1
    a, b = _flat(upd), _flat(jupd)
    assert _l2(a, b) <= 6e-2
    assert np.mean(np.abs(a - b) > HOOK["meta_weight"] / 2) <= 1e-2


def test_adam_step_matches_optax():
    """Two updates of ``chain(add_decayed_weights(1e-5), adam(1e-3))`` from
    the same gradients: moments, count and parameters to f32 rounding."""
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in (("a", (3, 4)), ("b", (5,)))}
    tx = jdmt.optax.chain(jdmt.optax.add_decayed_weights(1e-5), jdmt.optax.adam(1e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    tp = {k: t(v) for k, v in params.items()}
    opt = dmt.adam_init(tp)
    for _ in range(2):
        g = {k: rng.normal(0, 1e-2, v.shape).astype(np.float32) for k, v in params.items()}
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = jdmt.optax.apply_updates(jp, upd)
        tp = dmt.adam_step({k: t(v) for k, v in g.items()}, opt, tp, 1e-3)
    jadam = _adam_state(jopt)
    assert opt["count"] == int(jadam.count) == 2
    for k in params:
        close(tp[k], jp[k], rtol=1e-6, atol=1e-7, what=k)
        close(opt["mu"][k], jadam.mu[k], rtol=1e-5, atol=1e-9, what=f"mu {k}")
        close(opt["nu"][k], jadam.nu[k], rtol=1e-5, atol=1e-12, what=f"nu {k}")


@pytest.mark.parametrize("method", dmt.METHODS)
def test_dmt_steps_match_jax(method):
    state, jstate, pairs, params = _run_steps(method)
    for i, (m, jm) in enumerate(pairs):
        assert set(m) == set(jm)
        for k in jm:
            if not k.startswith("dice"):
                close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=f"step {i} {k}")
    got = state_dict_to_flax(state.model.state_dict())
    _check_updates(got["params"], jstate.params, params, "student")
    teacher = hook_state_to_flax(state.hook_states["dmt"])
    jteacher = jstate.hook_states["dmt"]
    assert teacher["ema_step"] == int(jteacher["ema_step"]) == 2
    if method in ("method1", "method3"):
        _check_adam_teacher(teacher["teacher_params"], jteacher["teacher_params"], params)
    else:
        _check_updates(teacher["teacher_params"], jteacher["teacher_params"], params, "teacher")
    for a, b in zip(jax.tree.leaves(teacher["teacher_batch_stats"]),
                    jax.tree.leaves(jteacher["teacher_batch_stats"])):
        scaled_close(a, b, tol=1e-3, what="teacher stats")
    if "teacher_opt" in jteacher:
        jadam = _adam_state(jteacher["teacher_opt"])
        assert teacher["teacher_opt"]["count"] == int(jadam.count) == 2
        for m in ("mu", "nu"):
            ours, theirs = teacher["teacher_opt"][m], getattr(jadam, m)
            # the second step's meta gradient is taken at teachers that are
            # already that far apart (measured 2.5e-2 for mu)
            assert _l2(_flat(jax.tree.leaves(ours)), _flat(jax.tree.leaves(theirs))) <= 5e-2, m
    else:
        assert "teacher_opt" not in teacher


# --- second_order: the Hessian term alone ----------------------------------------

SO_HOOK = dict(weight=1.0, alpha=0.5, meta_weight=0.1, method_name="second_order")


def _so_inputs():
    params, stats = _weights(4)
    t_params, t_stats = _weights(5)
    rng = np.random.default_rng(8)
    b = {"lab": rng.random((NL, S, S, 1)).astype(np.float32),
         "target": rng.integers(0, C, (NL, S, S)).astype(np.int32),
         "unl": rng.random((NU, S, S, 1)).astype(np.float32),
         "unl_tf": rng.random((NU, S, S, 1)).astype(np.float32)}
    geo = sample_geo_params(jax.random.PRNGKey(5), NU)
    return params, stats, t_params, t_stats, b, geo


def _jax_hessian_term(params, stats, t_params, t_stats, b, geo, dtype=jnp.float32):
    """JAX's student gradient of the meta loss, and that less (1 - alpha)
    d(meta)/d(t1), with t1 rebuilt from the hook's code (checked against
    the hook's own ``_second_order_meta``), jitted in ``dtype``."""
    hook = jdmt.DifferentiableMeanTeacherTrainerHook(name="dmt", **SO_HOOK)
    cast = lambda tree: jax.tree.map(lambda v: jnp.asarray(v, dtype), tree)  # noqa: E731
    jb = JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=dtype), cast(params), cast(stats),
                 (S, S, 1))
    state = {"teacher_params": cast(t_params), "teacher_batch_stats": cast(t_stats)}
    ctx = JContext(bundle=jb, batch_stats=jb.batch_stats, geo_params=type(geo)(*(
                       jnp.asarray(v, dtype) if v.dtype == np.float32 else v for v in geo)),
                   labeled_image=jnp.asarray(b["lab"], dtype),
                   labeled_target=jnp.asarray(b["target"]),
                   labeled_logits=jnp.zeros((NL, S, S, C), dtype),
                   unlabeled_image=jnp.asarray(b["unl"], dtype),
                   unlabeled_image_tf=jnp.asarray(b["unl_tf"], dtype))
    a, mw = SO_HOOK["alpha"], SO_HOOK["meta_weight"]
    onehot = jax.nn.one_hot(ctx.labeled_target, C, dtype=dtype)
    (t_logits, _), _ = jb.apply_train(state["teacher_params"], state["teacher_batch_stats"],
                                      ctx.unlabeled_image, update_stats=False)
    t_target = jax.nn.softmax(ctx.affine_transformer(t_logits), -1)

    def t1_of(p):
        def inner(q):
            (l_logits, _), _ = jb.apply_train(q, jb.batch_stats, ctx.labeled_image,
                                              update_stats=False)
            (u_logits, _), _ = jb.apply_train(q, jb.batch_stats, ctx.unlabeled_image_tf,
                                              update_stats=False)
            return (jkl(jax.nn.softmax(l_logits, -1), onehot)
                    + 0.1 * jnp.mean((t_target - jax.nn.softmax(u_logits, -1)) ** 2))
        g = jax.grad(inner)(p)
        return jax.tree.map(lambda vt, v, gr: a * vt + (1 - a) * (v - mw * gr),
                            state["teacher_params"], p, g)

    def meta(t1):
        return hook._meta_loss_fn(ctx, t1, state["teacher_batch_stats"], train=True)

    def hooked(p):
        ctx.params = p
        return hook._second_order_meta(ctx, state, None)

    @jax.jit
    def run(p):
        total = jax.grad(lambda q: meta(t1_of(q)))(p)
        first = jax.grad(meta)(t1_of(p))
        return total, jax.tree.map(lambda x, y: x - (1 - a) * y, total, first), jax.grad(hooked)(p)

    return [[np.asarray(v, np.float64) for v in jax.tree.leaves(tree)] for tree in run(jb.params)]


def _jax_hessian_term_f64(*args):
    """:func:`_jax_hessian_term` in f64: x64 on, the f32 casts of JAX's
    U-Net (its BN statistics) promoted to f64."""
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unet, "jnp", promoted)
        return _jax_hessian_term(*args, dtype=jnp.float64)


def test_second_order_hessian_term_matches_jax():
    """The student gradient of ``second_order``'s meta loss less its
    first-order part (1 - alpha) d(meta)/d(t1): the Hessian-vector term
    that a backward without a graph would drop (JAX's own
    ``test_dmt_second_order_student_meta_gradient`` cannot see it, its
    first-order part being nonzero by itself). alpha 0.5 and meta_weight
    0.1 make the term a measurable share of the gradient (67% here).

    Against JAX in f64 (jitted, x64): the whole gradient and the term to
    2e-3 in L2. JAX's f32 is the noisier side here (measured 3.2e-3 on the
    gradient, 2.5e-2 on the term from the port's f32 and so from JAX's
    f64), as in ``test_unet_inner_loss_hessian_vector_matches_jax``, which
    also holds the port to JAX's f32. The term is nonzero: over 10% of the
    gradient."""
    params, stats, t_params, t_stats, b, geo = _so_inputs()
    hook = dmt.DifferentiableMeanTeacherTrainerHook(name="dmt", **SO_HOOK)
    model = _port_model(params, stats)
    state = flax_to_hook_state({"teacher_params": t_params, "teacher_batch_stats": t_stats,
                                "ema_step": 0})
    ctx = StepContext(bundle=ModelBundle(model, (S, S, 1)),
                      geo_params=GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                      labeled_image=t(b["lab"]), labeled_target=torch.tensor(b["target"]),
                      labeled_logits=torch.zeros(NL, S, S, C), unlabeled_image=t(b["unl"]),
                      unlabeled_image_tf=t(b["unl_tf"]))
    t1 = hook.virtual_teacher(ctx, state)
    meta = hook._meta_loss(ctx, t1, state["teacher_batch_stats"], train=True)
    student = dict(model.named_parameters())
    names = list(student)
    total = torch.autograd.grad(meta, [student[k] for k in names], retain_graph=True)
    first = torch.autograd.grad(meta, [t1[k] for k in names])
    a = SO_HOOK["alpha"]
    term = [g - (1 - a) * f for g, f in zip(total, first)]

    def flat(tensors):
        sd = {**dict(zip(names, tensors)), **dict(model.named_buffers())}
        return _flat(jax.tree.leaves(state_dict_to_flax(sd)["params"]))

    got_total, got_term = flat(total), flat(term)
    assert np.linalg.norm(got_term) > 0.1 * np.linalg.norm(got_total)
    jtotal, jterm, jhooked = _jax_hessian_term_f64(params, stats, t_params, t_stats, b, geo)
    assert _l2(_flat(jtotal), _flat(jhooked)) <= 1e-6      # the rebuilt t1 is the hook's
    assert _l2(got_total, _flat(jtotal)) <= 2e-3
    assert _l2(got_term, _flat(jterm)) <= 2e-3


def test_second_order_raises_on_a_gradient_without_graph(monkeypatch):
    """A backward that returns detached buffers (the raw-launch path under
    ``create_graph``) makes ``second_order`` raise instead of dropping the
    term."""
    params, stats, t_params, t_stats, b, geo = _so_inputs()
    hook = dmt.DifferentiableMeanTeacherTrainerHook(name="dmt", **SO_HOOK)
    model = _port_model(params, stats)
    state = flax_to_hook_state({"teacher_params": t_params, "teacher_batch_stats": t_stats,
                                "ema_step": 0})
    ctx = StepContext(bundle=ModelBundle(model, (S, S, 1)),
                      geo_params=GeoParams(*(torch.tensor(np.asarray(v)) for v in geo)),
                      labeled_image=t(b["lab"]), labeled_target=torch.tensor(b["target"]),
                      labeled_logits=torch.zeros(NL, S, S, C), unlabeled_image=t(b["unl"]),
                      unlabeled_image_tf=t(b["unl_tf"]))
    hook.virtual_teacher(ctx, state)
    _detached_backward(monkeypatch)
    with pytest.raises(RuntimeError, match="has no graph"):
        hook.virtual_teacher(ctx, state)


# --- dice ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"ignore_index": 0}, {"weight": [0.5, 1.0, 2.0, 1.5]},
                                {"smooth": 0.1, "p": 1.0}])
def test_dice_loss_matches_jax(kw):
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(C), (3, 8, 8)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, (3, 8, 8))]
    close(dice.dice_loss(t(probs), t(onehot), **kw),
          jdice.dice_loss(jnp.asarray(probs), jnp.asarray(onehot), **kw),
          rtol=1e-6, atol=1e-7, what=str(kw))
    for red in ("mean", "sum", "none"):
        close(dice.BinaryDiceLoss(reduction=red)(t(probs[..., 1]), t(onehot[..., 1])),
              jdice.BinaryDiceLoss(reduction=red)(jnp.asarray(probs[..., 1]),
                                                  jnp.asarray(onehot[..., 1])),
              rtol=1e-6, atol=1e-7, what=red)


def test_dmt_dice_meta_criterion_matches_jax():
    """``meta_criterion: dice`` (soft dice without the background) on
    ``method2``, whose consistency target moves along the meta gradient:
    the step's losses and metrics as in ``test_dmt_steps_match_jax``."""
    _, _, pairs, _ = _run_steps("method2", meta_criterion="dice", steps=1)
    m, jm = pairs[0]
    assert set(m) == set(jm)
    for k in jm:
        if not k.startswith("dice"):
            close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=k)
