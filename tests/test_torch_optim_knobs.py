"""The step and optimizer knobs of the port (contrastyou_tpu_torch/engine/
{optim,steps,trainer}.py, main.py) held against the JAX package on the CPU:
``Optim.name`` adam / adamw / sgd, ``Scheduler.name`` poly / step,
``Trainer.accumulate_iter`` (optax.MultiSteps) and ``Trainer.two_stage=false``
(the entry point's runs of the new nets and knobs:
tests/test_torch_arch_loop.py).

Tolerances. Optimizer updates: rtol 1e-5 / atol 1e-8 per step against
optax jitted, as tests/test_torch_optim.py holds RAdam (the same f32
arithmetic in another order; updates of ~1e-3 read back as differences of
~1e-2 parameters). Schedules: rtol 1e-4 (optax evaluates them in f32; the
warmup line cancels at step 0 to ~2e-5). The one-pass ``semi`` step, against JAX's step in f64
on the same f32 draws, with sgd at lr 1 (the update is minus the
gradient): losses at rtol 1e-5, running statistics at relative L2 1e-5,
and each gradient tensor no farther from JAX's f64 than JAX's own f32 step
is (+1e-4), the whole gradient no farther either. The random U-Net's f32
gradient is ill-conditioned (a BN bias's gradient sums thousands of
sign-mixed terms; one pass over batch 6 couples the three batches through
the statistics): JAX's f32 lies 1.6% (median) to 4.8% from its f64 there,
the port's f32 0.4% to 0.8% (the test prints both); on the two-pass step
the port's lies within 2e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.optim import warmup_schedule as jschedule
from contrastyou_tpu.engine import steps as jax_steps
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.engine.steps import init_train_state as jinit
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.models import resunet as jax_resunet
from contrastyou_tpu.models import unet as jax_unet
from contrastyou_tpu.ops import affine as jax_affine
from contrastyou_tpu.ops.affine import GeoParams as JGeoParams
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch.engine.optim import create_optimizer, warmup_schedule
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.steps import build_train_step, init_train_state
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import flax_to_state_dict, state_dict_to_flax
from test_torch_step import _batch, _l2, _replayed_draws
from torch_parity import close, t

torch.set_num_threads(1)

SCHED = {"multiplier": 3, "warmup_max": 2}
SHAPES = [(3, 3, 4, 8), (8,), (8,), (16, 5), (5,)]


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _updates(optim, sched, n_calls, accumulate=1):
    """Per call, the parameter deltas of optax (``create_optimizer`` of the
    JAX package, jitted) and of the port on the same gradients."""
    rng = np.random.default_rng(0)
    params = [(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(n_calls)]
    tx, _ = jcreate(optim, sched, max_epoch=5, steps_per_epoch=3, accumulate_iter=accumulate)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    jdeltas = []
    for g in grads:
        upd, state = update([jnp.asarray(x) for x in g], state, jp)
        new = [p + u for p, u in zip(jp, upd)]
        jdeltas.append([np.asarray(a) - np.asarray(b) for a, b in zip(new, jp)])
        jp = new
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt, _ = create_optimizer(tp, optim, sched, max_epoch=5, steps_per_epoch=3,
                              accumulate_iter=accumulate)
    deltas = []
    for g in grads:
        before = [p.detach().clone() for p in tp]
        for p, x in zip(tp, g):
            p.grad = t(x)
        opt.step()
        deltas.append([p.detach() - b for p, b in zip(tp, before)])
    return deltas, jdeltas, opt


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 1e-2), ("adamw", 1e-2),
                                     ("sgd", 0.0), ("sgd", 1e-2)])
def test_optimizer_updates_match_optax(name, wd):
    """10 updates through the warmup into the cosine phase; ``adamw`` with
    its decoupled decay, ``adam`` / ``sgd`` with the coupled L2 term."""
    deltas, jdeltas, _ = _updates({"name": name, "lr": 1e-3, "weight_decay": wd}, SCHED, 10)
    for step, (a, b) in enumerate(zip(deltas, jdeltas)):
        for x, y in zip(a, b):
            close(x, y, rtol=1e-5, atol=1e-8, what=f"{name} update {step + 1}")


@pytest.mark.parametrize("name", ["radam", "adam"])
def test_accumulate_iter_is_multisteps(name):
    """``accumulate_iter=3`` over 9 calls: zero updates on the calls in
    between, the inner update of the running mean of 3 gradients on every
    third, the inner count (and so the schedule) advancing once per 3."""
    deltas, jdeltas, opt = _updates({"name": name, "lr": 1e-3, "weight_decay": 1e-2},
                                    SCHED, 9, accumulate=3)
    for call, (a, b) in enumerate(zip(deltas, jdeltas)):
        for x, y in zip(a, b):
            close(x, y, rtol=1e-5, atol=1e-8, what=f"call {call + 1}")
            assert bool((x == 0).all()) == (call % 3 != 2)
    assert opt.count == 3 and opt.mini_step == 0
    sd = opt.state_dict()
    assert (sd["count"], sd["mini_step"]) == (3, 0)


def test_accumulate_iter_moves_statistics_every_step():
    """Under ``accumulate_iter=2`` the step's BN running statistics move on
    every call, as in JAX's step, and the parameters on every second."""
    from contrastyou_tpu_torch.main import build_semi_run, parse_config
    run = build_semi_run(parse_config(["-o", "Trainer.name=semi", "Trainer.accumulate_iter=2"]),
                         device="cpu", dtype=torch.float32, raw_size=40, crop=32, n_slices=8,
                         max_channel=32)
    model = run.state.model

    def snapshot():
        return ({k: p.detach().clone() for k, p in model.named_parameters()},
                {k: b.clone() for k, b in model.named_buffers()})

    params, stats = snapshot()
    for call in (1, 2):
        run.step(run.state, run.generator)
        new_params, new_stats = snapshot()
        moved = [not torch.equal(v, params[k]) for k, v in new_params.items()]
        assert all(not torch.equal(v, stats[k]) for k, v in new_stats.items()), call
        assert (any(moved) if call == 2 else not any(moved)), call
        params, stats = new_params, new_stats
    assert run.state.optimizer.count == 1 and run.state.step == 2


@pytest.mark.parametrize("name,extra", [
    ("poly", {"power": 0.9}),
    ("step", {"milestones": [0, 1, 3, 5, 5], "gamma": 0.5})])
def test_schedule_matches_optax(name, extra):
    """The schedule at the boundary steps: the warmup join, each milestone
    (epochs from the start of training; 0 and 1 clamp to the join, 5 twice
    multiplies twice), the end of training and after it."""
    kw = dict(base_lr=1e-4, multiplier=300, warmup_max_epoch=2, max_epoch=7,
              steps_per_epoch=10, eta_min=1e-7, name=name, **extra)
    sched, jsched = warmup_schedule(**kw), jschedule(**kw)
    for step in (0, 1, 19, 20, 21, 29, 30, 31, 49, 50, 51, 69, 70, 80):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-4,
                                   err_msg=f"{name} step {step}")
    if name == "step":
        assert sched(20) == pytest.approx(1e-4 * 300 * 0.25)
        assert sched(50) == pytest.approx(1e-4 * 300 * 0.25 * 0.5 * 0.25)


def jax_semi_step_f64(net, params, stats, batch, key, *, two_stage: bool, weight: float = 10.0):
    """JAX's ``semi`` step with the consistency hook, jitted in f64 (x64 on,
    the f32 casts of JAX's nets promoted to f64) on the transform JAX draws
    in f32 from ``key`` (the draws the port replays), with optax's sgd at lr
    1 so the update is minus the gradient -> (new params, batch_stats,
    metrics) as numpy."""
    k_geo, k_int, _ = jax.random.split(key, 3)
    n_u = batch["unlabeled_image"].shape[0]
    geo = jax.tree.map(np.asarray, sample_geo_params(k_geo, n_u))
    gammas = np.asarray(jax.random.uniform(k_int, (n_u, 1, 1, 1), minval=0.5, maxval=2.0))
    promoted = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    promoted.float32 = jnp.float64

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                            if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), tree)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in (jax_unet, jax_resunet):
            mp.setattr(module, "jnp", promoted)
        mp.setattr(jax_steps, "sample_geo_params", lambda k, b: JGeoParams(*f64(tuple(geo))))
        mp.setattr(jax_steps, "transform_image", lambda x, g, k: jax_affine.apply_geometric(
            jnp.clip(x, 0.0, 1.0) ** jnp.asarray(gammas, jnp.float64), g, order=0))
        bundle = JBundle(net, f64(params), f64(stats), batch["labeled_image"].shape[1:])
        hooks = [JConsistency(weight=weight)]
        tx, _ = jcreate({"name": "sgd", "lr": 1.0}, None, max_epoch=1, steps_per_epoch=1)
        state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
        new, metrics = jax.jit(jbuild(bundle, tx, hooks, raw=True, two_stage=two_stage,
                                      mode="semi"))(state, f64(batch), key, jnp.int32(0))
        return jax.tree.map(np.asarray, (new.params, new.batch_stats, metrics))


def test_one_stage_semi_step_matches_jax():
    """``two_stage=false``: one forward over cat(labeled, unlabeled,
    unlabeled_tf) with shared batch statistics and one running update,
    against JAX's step in f64 and as accurate as JAX's own f32 step (sgd at
    lr 1: the update is minus the gradient)."""
    batch, key = _batch(), jax.random.PRNGKey(7)
    bundle = JBundle.create(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                            jax.random.PRNGKey(0), (32, 32, 1))
    params, stats = jax.tree.map(np.asarray, (bundle.params, bundle.batch_stats))
    jparams, jstats, jm = jax_semi_step_f64(
        JUNet(max_channel=128, momentum=0.1, dtype=jnp.float64), params, stats, batch, key,
        two_stage=False)
    hooks = [JConsistency(weight=10.0)]
    tx, _ = jcreate({"name": "sgd", "lr": 1.0}, None, max_epoch=1, steps_per_epoch=1)
    j32, _ = jax.jit(jbuild(bundle, tx, hooks, raw=True, two_stage=False, mode="semi"))(
        jinit(bundle, hooks, tx, jax.random.PRNGKey(1)),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.int32(0))

    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    pbundle, phooks = ModelBundle(model, (32, 32, 1)), [ConsistencyTrainerHook(weight=10.0)]
    opt, _ = create_optimizer(model.parameters(), {"name": "sgd", "lr": 1.0}, None,
                              max_epoch=1, steps_per_epoch=1)
    pstate = init_train_state(pbundle, phooks, opt)
    m = build_train_step(pbundle, phooks, two_stage=False)(
        pstate, {k: torch.tensor(v) for k, v in batch.items()}, _replayed_draws(key))
    for k in ("sup_loss", "reg_loss", "consistency/loss"):
        close(m[k], jm[k], rtol=1e-5, atol=1e-8, what=k)
    new = state_dict_to_flax(pstate.model.state_dict())
    ref = [b - p for b, p in zip(jax.tree.leaves(jparams), jax.tree.leaves(params))]
    port = [a - p for a, p in zip(jax.tree.leaves(new["params"]), jax.tree.leaves(params))]
    jax32 = [np.asarray(a) - p for a, p in zip(jax.tree.leaves(j32.params),
                                                jax.tree.leaves(params))]
    names = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    errs = [(n, float(_l2(a, r)), float(_l2(b, r))) for n, a, b, r in
            zip(names, port, jax32, ref)]
    print(f"one-pass gradient against JAX f64, per tensor: port worst "
          f"{max(e[1] for e in errs):.2e} (median {np.median([e[1] for e in errs]):.2e}), "
          f"JAX f32 worst {max(e[2] for e in errs):.2e} (median "
          f"{np.median([e[2] for e in errs]):.2e})")
    for name, port_err, jax_err in errs:
        assert port_err <= jax_err + 1e-4, name

    def flat(leaves):
        return np.concatenate([np.ravel(a) for a in leaves])

    assert _l2(flat(port), flat(ref)) <= _l2(flat(jax32), flat(ref))
    for a, b in zip(jax.tree.leaves(new["batch_stats"]), jax.tree.leaves(jstats)):
        assert _l2(a, b) <= 1e-5
