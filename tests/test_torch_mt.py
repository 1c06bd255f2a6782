"""The mean-teacher family of the port (contrastyou_tpu_torch/hooks/mt.py,
hooks/utils.py; the hook draws of engine/steps.py; hooks/creator.py; the
``mt`` base of main.py) held against the JAX package on the CPU.

- ``ema_update``, and each hook's ``loss`` + ``post_step`` (MT with
  ``update_bn`` both ways and ``hard_clip``, UAMT, ICT, the EMA eval hook)
  on the same student and teacher weights (max_channel 128, 32 x 32, f32),
  the same inputs and JAX's draws (UAMT's noise, ICT's ``lam`` and
  permutation from ``split(k_hook)``): losses and metrics, the teacher's
  running statistics after the loss, and the teacher after ``post_step``
  at ``ema_step`` 0, 1 and 2 (the justified alpha 0, 1/2, 2/3) to f32
  rtol 1e-5, atol 1e-6 of each other. UAMT's per-pass loop against JAX's
  ``bn_groups`` forward: logits to 1e-3 of the largest, the convention of
  tests/test_torch_unet.py for whole-network f32 values (measured 3.6e-5).
- Two ``semi`` steps with each hook through ``build_train_step`` against
  JAX's ``build_train_step(raw=True)`` on the same batch, weights and
  replayed key splits, with the tolerances of tests/test_torch_step.py:
  losses rtol 1e-4; the student's and the teacher's changes from their
  initial weights in L2, per tensor 3e-2 and together 2e-2; the teacher's
  running statistics 1e-3 of the largest value.
- The factory: the four sections in JAX's order, ``num_teachers`` 2
  raises, EvalEMAParameters wins the eval model; ``MTTrainer`` without a
  mean-teacher hook raises; ``MT_CONFIG`` and the UAMT and ICT override
  forms equal config/base.yaml plus the YAML files.
"""
from pathlib import Path

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
from contrastyou_tpu.hooks import mt as jmt
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_hooks
from contrastyou_tpu.hooks.utils import mixup_data as jmixup
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch.configure.config import merge, yaml_load
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import StepDraws, build_train_step, init_train_state
from contrastyou_tpu_torch.hooks import mt
from contrastyou_tpu_torch.hooks.creator import UNPORTED_SECTIONS, create_hook_from_config
from contrastyou_tpu_torch.hooks.utils import mixup_data
from contrastyou_tpu_torch.main import MT_CONFIG, parse_config
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_hook_state, flax_to_state_dict,
                                                        hook_state_to_flax, state_dict_to_flax)
from torch_parity import close, scaled_close, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NL, NU, S, C = 2, 2, 32, 4
RTOL, ATOL = 1e-5, 1e-6
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}
#: the hooks' keyword arguments (config/hooks/*.yaml's, num_teachers aside)
HOOKS = {"mt": dict(weight=10.0, alpha=0.99, weight_decay=1e-6),
         "uamt": dict(weight=10.0, alpha=0.99, weight_decay=1e-6, max_epoch=10),
         "ict": dict(weight=10.0, alpha=0.99, weight_decay=1e-6)}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _hooks(name, **kw):
    cls = {"mt": "MeanTeacherTrainerHook", "uamt": "UAMeanTeacherTrainerHook",
           "ict": "ICTMeanTeacherTrainerHook"}[name]
    kw = {**HOOKS[name], **kw}
    return getattr(jmt, cls)(name=name, **kw), getattr(mt, cls)(name=name, **kw)


def _weights(seed):
    """Port-initialized U-Net weights (flax's own init takes ~20 s to trace)
    with running statistics away from 0 and 1 -> (params, stats) numpy trees."""
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32).init_weights(
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
    return JBundle(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                   jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                   (S, S, 1))


def _port_model(params, stats):
    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model


def _port_geo(geo):
    return GeoParams(*(torch.tensor(np.asarray(v)) for v in geo))


def _teacher_state(params, stats, step):
    return {"teacher_params": jax.tree.map(jnp.asarray, params),
            "teacher_batch_stats": jax.tree.map(jnp.asarray, stats),
            "ema_step": jnp.int32(step)}


def _jax_hook_draws(name, hook, key, image_shape):
    """The port's draws replayed from JAX's ``k_hook``."""
    if name == "uamt":
        return t(jax.random.normal(key, (hook._num_noise, *image_shape)))
    if name == "ict":
        k_lam, k_perm = jax.random.split(key)
        lam = float(np.asarray(jax.random.beta(k_lam, hook._mix_alpha, hook._mix_alpha)))
        return lam, tuple(int(i) for i in np.asarray(
            jax.random.permutation(k_perm, 2 * image_shape[0])))
    return None


def _close_trees(got, ref, what, rtol=RTOL, atol=ATOL):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(ref)):
        close(a, b, rtol=rtol, atol=atol, what=f"{what} {jax.tree_util.keystr(path)}")


# --- ema_update, mixup --------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_ema_update_matches_jax(weight_decay):
    rng = np.random.default_rng(0)
    ema = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    new = [rng.normal(size=a.shape).astype(np.float32) for a in ema]
    for step in range(3):
        alpha = mt.justified_alpha(step, 0.99)
        jalpha = jnp.minimum(1.0 - 1.0 / (jnp.int32(step) + 1.0), 0.99)
        assert np.float32(alpha) == np.asarray(jalpha)
        want = jmt.ema_update([jnp.asarray(a) for a in ema], [jnp.asarray(a) for a in new],
                              jalpha, weight_decay)
        got = [t(a) for a in ema]
        mt.ema_update(got, [t(a) for a in new], alpha, weight_decay)
        for g, w in zip(got, want):
            close(g, w, rtol=RTOL, atol=ATOL, what=f"step {step}")
    assert mt.justified_alpha(5, 0.5, justify=False) == 0.5


def test_mixup_matches_jax():
    rng = np.random.default_rng(1)
    x, y = rng.random((6, 4, 4, 1)).astype(np.float32), rng.random((6, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jx, jy, jlam = jmixup(jnp.asarray(x), jnp.asarray(y), key, alpha=0.2)
    k_lam, k_perm = jax.random.split(key)
    perm = tuple(int(i) for i in np.asarray(jax.random.permutation(k_perm, 6)))
    gx, gy = mixup_data(t(x), t(y), float(np.asarray(jlam)), perm)
    close(gx, jx, rtol=RTOL, atol=ATOL, what="mixed x")
    close(gy, jy, rtol=RTOL, atol=ATOL, what="mixed y")


# --- one loss + post_step on the same state ---------------------------------------

def _unit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.random((NU, S, S, 1)).astype(np.float32)
    image_tf = rng.random((NU, S, S, 1)).astype(np.float32)
    tf_logits = rng.normal(0, 2, (NU, S, S, C)).astype(np.float32)
    return image, image_tf, tf_logits


UNIT_CASES = [("mt", {}), ("mt", {"update_bn": True}), ("mt", {"hard_clip": True}),
              ("uamt", {}), ("uamt", {"update_bn": True}),
              ("ict", {}), ("ict", {"update_bn": True})]


@pytest.mark.parametrize("name,kw", UNIT_CASES)
def test_hook_loss_and_post_step_match_jax(name, kw):
    """``loss`` then ``post_step`` three times (``ema_step`` 0, 1, 2), the
    student's weights, statistics and the teacher's own drawn apart."""
    jhook, hook = _hooks(name, **kw)
    s_params, s_stats = _weights(1)
    t_params, t_stats = _weights(2)
    n_params, _ = _weights(3)            # the student after its update
    image, image_tf, tf_logits = _unit_inputs()
    key = jax.random.PRNGKey(11)
    k_geo, _, k_hook = jax.random.split(key, 3)
    geo, epoch = sample_geo_params(k_geo, NU), 3

    jb = _jbundle(s_params, s_stats)
    jctx = JContext(bundle=jb, params=jb.params, batch_stats=jb.batch_stats, rng=k_hook,
                    epoch=jnp.int32(epoch), geo_params=geo, unlabeled_image=jnp.asarray(image),
                    unlabeled_image_tf=jnp.asarray(image_tf),
                    unlabeled_tf_logits=jnp.asarray(tf_logits))
    jloss, jstate, jmetrics = jhook.loss(jctx, None, _teacher_state(t_params, t_stats, 0))

    model = _port_model(s_params, s_stats)
    bundle = ModelBundle(model, (S, S, 1))
    state = flax_to_hook_state(_teacher_state(t_params, t_stats, 0))
    draws = _jax_hook_draws(name, hook, k_hook, image.shape)
    ctx = StepContext(bundle=bundle, epoch=epoch, geo_params=_port_geo(geo),
                      unlabeled_image=t(image), unlabeled_image_tf=t(image_tf),
                      unlabeled_tf_logits=t(tf_logits).requires_grad_(),
                      hook_draws={} if draws is None else {name: draws})
    loss, state, metrics = hook.loss(ctx, state)
    close(loss, jloss, rtol=RTOL, atol=ATOL, what="loss")
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], rtol=RTOL, atol=ATOL, what=k)
    loss.backward()                      # the student's graph, not the teacher's
    assert all(v.grad is None for v in state["teacher_params"].values())
    _close_trees(hook_state_to_flax(state)["teacher_batch_stats"],
                 jstate["teacher_batch_stats"], "teacher stats after the loss")

    load = flax_to_state_dict(n_params, s_stats)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(load[k])
    jstate = dict(jstate)
    for step in range(3):
        jctx.batch_stats = jax.tree.map(jnp.asarray, s_stats)
        jstate = jhook.post_step(jctx, jax.tree.map(jnp.asarray, n_params), jstate)
        state = hook.post_step(ctx, model, state)
        assert state["ema_step"] == int(jstate["ema_step"]) == step + 1
        got = hook_state_to_flax(state)
        _close_trees(got["teacher_params"], jstate["teacher_params"], f"teacher step {step}")
        _close_trees(got["teacher_batch_stats"], jstate["teacher_batch_stats"],
                     f"teacher stats step {step}")


@pytest.mark.parametrize("update_bn", [True, False])
def test_ema_eval_hook_post_step_matches_jax(update_bn):
    """The EMA of the student at ``ema_step`` 0, 1, 2: parameters with the
    configured weight decay, running statistics without; no eval statistics
    of its own without ``update_bn`` (the student's are taken)."""
    kw = dict(alpha=0.9, weight_decay=1e-3, update_bn=update_bn)
    jhook, hook = jmt.EMAEvalTrainerHook(**kw), mt.EMAEvalTrainerHook(**kw)
    params, stats = _weights(7)
    n_params, n_stats = _weights(8)
    jb = _jbundle(params, stats)
    _, jstate = jhook.init(jax.random.PRNGKey(0), jb)
    model = _port_model(params, stats)
    state = hook.init_state(ModelBundle(model, (S, S, 1)))
    model.load_state_dict(flax_to_state_dict(n_params, n_stats))
    jctx = JContext(batch_stats=jax.tree.map(jnp.asarray, n_stats))
    for step in range(3):
        jstate = jhook.post_step(jctx, jax.tree.map(jnp.asarray, n_params), jstate)
        state = hook.post_step(StepContext(), model, state)
        got = hook_state_to_flax(state)
        assert got["ema_step"] == int(jstate["ema_step"]) == step + 1
        _close_trees(got["ema_params"], jstate["ema_params"], f"ema step {step}")
        _close_trees(got["ema_batch_stats"], jstate["ema_batch_stats"], f"ema stats step {step}")
    assert (hook.eval_batch_stats(state) is None) == (jhook.eval_batch_stats(jstate) is None) \
        == (not update_bn)
    assert hook.eval_params(state) is state["ema_params"]


def test_uamt_noisy_passes_match_jax_bn_groups():
    """The port's loop of noisy passes (each over its own batch, running
    statistics untouched) equals JAX's one ``bn_groups`` forward."""
    params, stats = _weights(4)
    N = 3
    rng = np.random.default_rng(5)
    image = rng.random((NU, S, S, 1)).astype(np.float32)
    noise = rng.normal(size=(N, NU, S, S, 1)).astype(np.float32)
    noisy = (image[None] + 0.05 * noise).reshape(N * NU, S, S, 1)
    jb = _jbundle(params, stats)
    (jlogits, _), jstats = jb.apply_train(jb.params, jb.batch_stats, jnp.asarray(noisy),
                                          update_stats=False, bn_groups=(NU,) * N)
    assert getattr(jb.model, "supports_bn_groups", False)
    model = _port_model(params, stats)
    hook = mt.UAMeanTeacherTrainerHook(num_noise=N)
    state = hook.init_state(ModelBundle(model, (S, S, 1)))
    ctx = StepContext(bundle=ModelBundle(model, (S, S, 1)))
    got = torch.cat([hook._teacher_apply(ctx, state, t(image) + 0.05 * t(noise[i]), train=True,
                                         update_stats=False) for i in range(N)])
    scaled_close(got, jlogits, tol=1e-3, what="noisy logits")
    for k, v in state["teacher_batch_stats"].items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_hook_draws_consume_only_their_own_generator():
    """After the transform's draws, MT and the EMA hook draw nothing (the
    ``semi`` stream stays as it was), UAMT draws its noise from the step's
    generator, ICT its ``lam`` and permutation from the host generator."""
    from contrastyou_tpu_torch.engine.steps import sample_step_draws
    shape = (NU, S, S, 1)
    hooks = {"none": [], "mt": [mt.MeanTeacherTrainerHook(), mt.EMAEvalTrainerHook()],
             "uamt": [mt.UAMeanTeacherTrainerHook(num_noise=3)],
             "ict": [mt.ICTMeanTeacherTrainerHook()]}
    states = {}
    for key, hs in hooks.items():
        gen, host = torch.Generator().manual_seed(0), np.random.default_rng(0)
        draws = sample_step_draws(gen, NU, hs, host_rng=host, shape=shape)
        states[key] = gen.get_state(), host.bit_generator.state["state"]["state"]
        assert set(draws.hooks) == ({key} if key in ("uamt", "ict") else set())
    assert torch.equal(states["mt"][0], states["none"][0]) and states["mt"][1] == states["none"][1]
    assert not torch.equal(states["uamt"][0], states["none"][0])
    assert torch.equal(states["ict"][0], states["none"][0]) and states["ict"][1] != states["none"][1]
    lam, perm = sample_step_draws(torch.Generator().manual_seed(0), NU, hooks["ict"],
                                  host_rng=np.random.default_rng(0), shape=shape).hooks["ict"]
    assert 0.0 <= lam <= 1.0 and sorted(perm) == list(range(2 * NU))
    with pytest.raises(ValueError, match="host generator"):
        sample_step_draws(torch.Generator(), NU, hooks["ict"], shape=shape)


# --- two semi steps --------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, C, (NL, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32)}


def _replayed_draws(key, name, hook):
    k_geo, k_int, k_hook = jax.random.split(key, 3)
    gammas = jax.random.uniform(k_int, (NU, 1, 1, 1), minval=0.5, maxval=2.0)
    draws = _jax_hook_draws(name, hook, k_hook, (NU, S, S, 1))
    return StepDraws(_port_geo(sample_geo_params(k_geo, NU)), t(gammas).reshape(NU),
                     {} if draws is None else {name: draws})


def _l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_updates(got, ref, init, what):
    """Changes from ``init``: per tensor L2 <= 3e-2, together <= 2e-2."""
    upd = jax.tree.map(lambda a, b: np.asarray(a) - b, got, init)
    jupd = jax.tree.map(lambda a, b: np.asarray(a) - b, ref, init)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(upd)[0], jax.tree.leaves(jupd)):
        assert _l2(a, b) <= 3e-2, f"{what} {jax.tree_util.keystr(path)}: {_l2(a, b):.3e}"
    flat = [np.concatenate([np.ravel(v) for v in jax.tree.leaves(u)]) for u in (upd, jupd)]
    assert _l2(*flat) <= 2e-2, what


@pytest.mark.parametrize("name", ["mt", "uamt", "ict"])
def test_two_semi_steps_match_jax(name):
    jhook, hook = _hooks(name)
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
    step = build_train_step(bundle, [hook])
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for i, key in enumerate((jax.random.PRNGKey(7), jax.random.PRNGKey(8))):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           jnp.int32(1))
        m = step(state, tb, _replayed_draws(key, name, hook), 1)
        for k in jm:
            if not k.startswith("dice"):
                close(m[k], jm[k], rtol=1e-4, atol=1e-7, what=f"step {i} {k}")
    got = state_dict_to_flax(model.state_dict())
    _check_updates(got["params"], jstate.params, params, "student")
    teacher = hook_state_to_flax(state.hook_states[name])
    jteacher = jstate.hook_states[name]
    assert teacher["ema_step"] == int(jteacher["ema_step"]) == 2
    _check_updates(teacher["teacher_params"], jteacher["teacher_params"], params, "teacher")
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(teacher["teacher_batch_stats"])[0],
            jax.tree.leaves(jteacher["teacher_batch_stats"])):
        scaled_close(a, b, tol=1e-3, what=f"teacher stats {jax.tree_util.keystr(path)}")


# --- factory, trainer, configs ------------------------------------------------------

class _Trainer:
    hook = None

    def set_model4inference(self, hook):
        self.hook = hook


def _factory(config, **kw):
    return create_hook_from_config(merge({"Trainer": {"max_epoch": 5}}, config),
                                   channel_dim=UNet(max_channel=128).get_channel_dim, **kw)


def test_factory_builds_the_sections_in_jax_order():
    sections = {"EvalEMAParameters": {"alpha": 0.9},
                "ICTMeanTeacherParameters": {"weight": 1.0},
                "UAMeanTeacherParameters": {"weight": 1.0},
                "ConsistencyParameters": {"weight": 1.0},
                "MeanTeacherParameters": {"weight": 1.0, "alpha": 0.99, "num_teachers": 1}}
    cfg = {**sections, "Data": {"name": "acdc"}, "Trainer": {"max_epoch": 5}}
    tr, jtr = _Trainer(), _Trainer()
    hooks = _factory(cfg, trainer=tr)
    jhooks = jcreate_hooks(cfg, trainer=jtr)
    assert [h.name for h in hooks] == [h.name for h in jhooks] == [
        "mt", "uamt", "ict", "consistency", "ema_eval"]
    assert [type(h).__name__ for h in hooks] == [type(h).__name__ for h in jhooks]
    assert tr.hook is hooks[-1] and jtr.hook is jhooks[-1]
    assert hooks[1]._max_epoch == jhooks[1]._max_epoch == 5
    assert hooks[-1].always_active and not hooks[-1].requires_unlabeled and hooks[-1].weight == 0
    for s in sections:
        assert s not in UNPORTED_SECTIONS
    # the differentiable mean teacher, the last section without a port, has one now
    assert "DifferentiableMeanTeacherParameters" not in UNPORTED_SECTIONS == ()


@pytest.mark.parametrize("ema", [False, True])
def test_factory_picks_the_eval_model_as_jax(ema):
    cfg = {"MeanTeacherParameters": {"weight": 1.0}, "Data": {"name": "acdc"},
           "Trainer": {"max_epoch": 5}, **({"EvalEMAParameters": {"alpha": 0.9}} if ema else {})}
    tr, jtr = _Trainer(), _Trainer()
    hooks, jhooks = _factory(cfg, trainer=tr), jcreate_hooks(cfg, trainer=jtr)
    assert tr.hook.name == jtr.hook.name == ("ema_eval" if ema else "mt")
    assert tr.hook is hooks[-1]


def test_num_teachers_above_one_raises():
    for create in (_factory, jcreate_hooks):
        with pytest.raises(NotImplementedError, match="num_teachers"):
            create({"MeanTeacherParameters": {"weight": 1.0, "num_teachers": 2},
                    "Data": {"name": "acdc"}, "Trainer": {"max_epoch": 5}})


def test_mean_teacher_sections_refused_in_pretraining():
    for section in ("MeanTeacherParameters", "UAMeanTeacherParameters",
                    "ICTMeanTeacherParameters"):
        with pytest.raises(RuntimeError, match=section):
            _factory({section: {"weight": 1.0}}, is_pretrain=True)


def test_mt_trainer_without_a_mean_teacher_hook_raises(tmp_path):
    from contrastyou_tpu_torch.trainers import MTTrainer, trainer_zoo
    from contrastyou_tpu_torch.data.creator import get_data
    from contrastyou_tpu_torch.data.synthetic import synthesize_acdc_like
    synthesize_acdc_like(tmp_path / "data", num_train_scans=2, num_val_scans=1,
                         slices_per_scan=3, size=40)
    loaders = get_data({"name": "acdc", "labeled_scan_num": 1}, {"batch_size": 2},
                       {"batch_size": 2}, root_dir=str(tmp_path / "data"))
    model = UNet(max_channel=32, momentum=0.01, dtype=torch.float32)
    trainer = trainer_zoo["mt"](model=model, labeled_loader=loaders[0],
                                unlabeled_loader=loaders[1], save_dir=str(tmp_path / "run"),
                                config={"Optim": OPTIM, "Scheduler": SCHED})
    assert isinstance(trainer, MTTrainer)
    trainer.register_hooks(*_factory({"ConsistencyParameters": {"weight": 1.0}}))
    with pytest.raises(RuntimeError, match="MeanTeacher-family"):
        trainer.init()


#: the UAMT and ICT runs from the in-code mt base, as written in the README
UAMT_OVERRIDES = ["Trainer.name=mt", "~MeanTeacherParameters",
                  "+UAMeanTeacherParameters.weight=10", "+UAMeanTeacherParameters.alpha=0.99",
                  "+UAMeanTeacherParameters.weight_decay=0.000001",
                  "+UAMeanTeacherParameters.update_bn=false",
                  "+UAMeanTeacherParameters.hard_clip=false"]
ICT_OVERRIDES = ["Trainer.name=mt", "~MeanTeacherParameters",
                 "+ICTMeanTeacherParameters.weight=10", "+ICTMeanTeacherParameters.alpha=0.99",
                 "+ICTMeanTeacherParameters.weight_decay=0.000001",
                 "+ICTMeanTeacherParameters.update_bn=false"]


@pytest.mark.parametrize("overrides,hook_file", [(["Trainer.name=mt"], "mt.yaml"),
                                                 (UAMT_OVERRIDES, "uamt.yaml"),
                                                 (ICT_OVERRIDES, "ict.yaml")])
def test_mt_configs_equal_the_yaml_files(overrides, hook_file):
    want = merge(merge(yaml_load(REPO / "config/base.yaml"),
                       yaml_load(REPO / "config/hooks" / hook_file)), {"Trainer": {"name": "mt"}})
    assert parse_config(["-o", *overrides]) == want
    if hook_file == "mt.yaml":
        assert MT_CONFIG == merge(yaml_load(REPO / "config/base.yaml"),
                                  yaml_load(REPO / "config/hooks/mt.yaml"))
        assert "ConsistencyParameters" not in MT_CONFIG


def test_profile_step_builds_the_mean_teacher_runs():
    """``profile_step mt -o ...`` profiles the run the overrides describe."""
    from contrastyou_tpu_torch import profile_step
    size = dict(dtype=torch.float32, raw_size=40, crop=32, n_slices=8, max_channel=128)
    for overrides, name in (([], "mt"), (UAMT_OVERRIDES[1:], "uamt"), (ICT_OVERRIDES[1:], "ict")):
        run = profile_step._build("mt", "cpu", overrides, **size)
        assert [h.name for h in run.hooks] == [name]
        m = run.run(1)[0]
        assert np.isfinite(float(m[f"{name}/loss"]))
        assert run.state.hook_states[name]["ema_step"] == 1
