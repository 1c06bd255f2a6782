"""The dense hooks under ``semi`` (the port's engine/steps.py
``StepDraws.points`` and ``sample_step_draws``, hooks/infonce.py) held
against the JAX package on the CPU, with the same numpy-seeded inputs and
bridged weights:

- the semi step's point draws: one ``draw_points`` per distinct grid of the
  dense hooks, shared by the hooks on it, and none without a dense hook
  (the generator then ends where the geometry, gamma and hook draws alone
  leave it, so the ``semi``, ``udaiic``, ``mt`` and ``ft`` streams are
  unchanged);
- one ``semi`` step with dense InfoNCE on [Conv5, Up_conv2] (the step that
  raised ``KeyError`` before the semi step drew points) and one with dense,
  self-paced and superpixel hooks together (as JAX's tests/test_hooks.py
  combines them), each against JAX's step on the same batch, weights and
  replayed draws (the points are JAX's ``sample_points`` splits of its hook
  key; JAX's step op by op, see ``_check_semi_step_against_jax``).
  Tolerances of tests/test_torch_pretrain.py: losses f32 rtol 1e-5;
  gradients and updates L2 5e-2 per tensor and 2e-2 together; BN statistics
  1e-4 of the largest value; dice counts within a pixel per class (a tie of
  two logits at f32 precision).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks.creator import create_hook_from_config as jcreate_from_config
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext, hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_train_step, draw_points,
                                                init_train_state, point_grids,
                                                sample_step_draws)
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.creator import create_hook_from_config
from contrastyou_tpu_torch.hooks.infonce import INFONCEHook
from contrastyou_tpu_torch.hooks.mt import ICTMeanTeacherTrainerHook, UAMeanTeacherTrainerHook
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams, sample_gammas, sample_geo_params as psgp
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        flax_to_state_dict,
                                                        head_state_dict_to_flax,
                                                        state_dict_to_flax)
from test_torch_pretrain import _check_l2, _hook_config, _recording
from test_torch_superpixel import S, _superpixels
from torch_parity import close, n, scaled_close, t

torch.set_num_threads(1)

#: labeled and unlabeled slices, and the points a dense hook samples per image
NL, NU, P = 2, 3, 5
OPTIM = {"name": "RAdam", "lr": 0.1, "weight_decay": 1e-2}
SCHED = {"multiplier": 400, "warmup_max": 10}


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _dense(name, grid):
    return INFONCEHook(name=name, feature_name="Up_conv2", in_dim=32, spatial_size=grid,
                       contrast_on="self")


def test_semi_draws_consume_nothing_new_without_dense_hooks():
    """Without a dense hook the generators end where the geometry, gamma and
    hook draws leave them (ICT draws from the host generator); with dense
    hooks, one ``draw_points`` per distinct grid after those, in grid order,
    shared by the hooks on a grid."""
    shape = (5, S, S, 1)
    plain = [ConsistencyTrainerHook(weight=1.0), UAMeanTeacherTrainerHook(name="uamt", max_epoch=4),
             ICTMeanTeacherTrainerHook(name="ict"),
             INFONCEHook(name="enc", feature_name="Conv5", in_dim=256)]

    def by_hand(hooks, grids):
        g, host = torch.Generator().manual_seed(4), np.random.default_rng(4)
        psgp(g, 5)
        sample_gammas(g, 5)
        drawn = [h.draw(g, host, shape) for h in hooks]
        points = {grid: draw_points(g, 5, grid) for grid in grids}
        return g, host, drawn, points

    g, host = torch.Generator().manual_seed(4), np.random.default_rng(4)
    draws = sample_step_draws(g, 5, plain, host_rng=host, shape=shape)
    g2, host2, drawn, _ = by_hand(plain, ())
    assert draws.points == {} and point_grids(plain) == []
    assert torch.equal(g.get_state(), g2.get_state())
    assert host.bit_generator.state == host2.bit_generator.state
    assert torch.equal(draws.hooks["uamt"], drawn[1])
    for a, b in zip(draws.hooks["ict"], drawn[2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    dense = plain + [_dense("a", (8, 8)), _dense("b", (6, 6)), _dense("c", (8, 8))]
    g = torch.Generator().manual_seed(4)
    draws = sample_step_draws(g, 5, dense, host_rng=np.random.default_rng(4), shape=shape)
    g2, _, _, points = by_hand(dense, [(6, 6), (8, 8)])
    assert list(draws.points) == [(6, 6), (8, 8)]
    assert torch.equal(g.get_state(), g2.get_state())
    for grid, (ys, xs) in points.items():
        assert torch.equal(draws.points[grid][0], ys) and torch.equal(draws.points[grid][1], xs)
        assert ys.shape == (5, P) and int(ys.max()) < grid[0]
    ctx = StepContext(point_draws=draws.points)
    assert dense[4]._points(ctx) is dense[6]._points(ctx)
    with pytest.raises(ValueError, match="fewer than 5"):
        draw_points(g, 5, (4, 8))           # JAX's choice without replacement raises too


def _replayed_semi_draws(key, nu, grids):
    """JAX's semi draws from ``key``: ``split(key, 3)`` into geometry,
    gamma and the hooks' key; each grid's points are ``sample_points``'s
    splits of the hooks' key (per image, then into rows and columns)."""
    k_geo, k_int, k_hook = jax.random.split(key, 3)
    geo = GeoParams(*(torch.tensor(np.asarray(v)) for v in sample_geo_params(k_geo, nu)))
    gammas = t(jax.random.uniform(k_int, (nu, 1, 1, 1), minval=0.5, maxval=2.0)).reshape(nu)
    points = {}
    for grid in grids:
        ys, xs = [], []
        for k in jax.random.split(k_hook, nu):
            kh, kw = jax.random.split(k)
            ys.append(np.asarray(jax.random.choice(kh, grid[0], (P,), replace=False)))
            xs.append(np.asarray(jax.random.choice(kw, grid[1], (P,), replace=False)))
        points[grid] = (torch.tensor(np.stack(ys)).long(), torch.tensor(np.stack(xs)).long())
    return StepDraws(geo, gammas, None, points)


def _semi_batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((NL, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (NL, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((NU, S, S, 1)).astype(np.float32),
            "unlabeled_partition": np.array([0, 1, 2]), "unlabeled_patient": np.array([1, 1, 2]),
            "unlabeled_scan_id": np.array([0, 0, 1]), "unlabeled_cycle": np.array([0, 1, 0]),
            "unlabeled_superpixel": _superpixels(NU, 1)}


def _check_semi_step_against_jax(sections, epoch=0):
    """One semi step of both packages on ``_semi_batch`` with the hooks of
    ``sections``: metrics, gradients and updates of the model and the heads,
    BN statistics. JAX's step runs op by op (``jax.disable_jit``), the
    arithmetic it is written as: jitted, XLA's fusions on the CPU move its
    backbone gradients by 2.6% in L2 on a dense InfoNCE hook (measured),
    more than the port's distance to either (0.4-0.8%, as with consistency
    alone)."""
    batch, key = _semi_batch(), jax.random.PRNGKey(7)
    config = _hook_config(sections)
    bundle = JBundle.create(JUNet(max_channel=128, momentum=0.1, dtype=jnp.float32),
                            jax.random.PRNGKey(0), (S, S, 1))
    jhooks = jcreate_from_config(config)
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    tx = _recording(tx)
    jstate = jinit(bundle, jhooks, tx, jax.random.PRNGKey(1))
    params, stats, hparams = jax.tree.map(
        np.asarray, (jstate.params, jstate.batch_stats, jstate.hook_params))
    # op by op: XLA's fusions of the jitted step move its own gradients by up
    # to 2.6% in L2 on these dense hooks (0.003% with consistency alone)
    with jax.disable_jit():
        jnew, jm = jbuild(bundle, tx, jhooks, raw=True, two_stage=True, mode="semi")(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.int32(epoch))
    jnew, jm = jax.tree.map(np.asarray, jnew), jax.tree.map(np.asarray, jm)

    model = UNet(max_channel=128, momentum=0.1, dtype=torch.float32)
    model.load_state_dict(flax_to_state_dict(params, stats))
    hooks = create_hook_from_config(config, channel_dim=model.get_channel_dim)
    assert [h.name for h in hooks] == [h.name for h in jhooks]
    heads = [h for h in hooks if isinstance(h, torch.nn.Module)]
    for h in heads:
        h.projector.load_state_dict(flax_to_head_state_dict(hparams[h.name]))
    opt, _ = create_optimizer(list(model.parameters()) + hook_parameters(hooks), OPTIM, SCHED,
                              max_epoch=75, steps_per_epoch=200)
    state = init_train_state(ModelBundle(model, (S, S, 1)), hooks, opt)
    step = build_train_step(ModelBundle(model, (S, S, 1)), hooks)
    m = step(state, {k: torch.tensor(v) for k, v in batch.items()},
             _replayed_semi_draws(key, NU, point_grids(hooks)), epoch)

    assert set(jm) <= set(m)
    for k in jm:
        if k.startswith("dice"):
            assert np.abs(n(m[k]) - jm[k]).max() <= 1, k
        else:
            close(m[k], jm[k], rtol=1e-5, atol=0, what=k)
    jgrads, jhgrads = jnew.opt_state["grads"]
    grads = state_dict_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                for k, p in model.state_dict(keep_vars=True).items()})
    _check_l2([(jax.tree_util.keystr(path), g, jg) for (path, g), jg in zip(
        jax.tree_util.tree_flatten_with_path(grads["params"])[0], jax.tree.leaves(jgrads))],
        "grad")
    new = state_dict_to_flax(model.state_dict())
    _check_l2([(jax.tree_util.keystr(path), a - b0, b - b0) for (path, a), b, b0 in zip(
        jax.tree_util.tree_flatten_with_path(new["params"])[0], jax.tree.leaves(jnew.params),
        jax.tree.leaves(params))], "update")
    for h in heads:
        hg = head_state_dict_to_flax({k: p.grad for k, p in h.projector.named_parameters()})
        _check_l2([(f"{layer}/{k}", v, jhgrads[h.name][layer][k])
                   for layer, leaves in hg.items() for k, v in leaves.items()], f"grad {h.name}")
        _check_l2([(f"{layer}/{k}", v - hparams[h.name][layer][k],
                    jnew.hook_params[h.name][layer][k] - hparams[h.name][layer][k])
                   for layer, leaves in head_state_dict_to_flax(h.projector.state_dict()).items()
                   for k, v in leaves.items()], f"update {h.name}")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jnew.batch_stats)):
        scaled_close(a, b, tol=1e-4, what=f"stats {jax.tree_util.keystr(path)}")
    return m


def test_dense_infonce_semi_step_matches_jax():
    """The repair: ``semi`` with ``InfonceParams`` on [Conv5, Up_conv2] (by
    partition, and dense by self on a 6 x 6 grid) draws its points and
    matches JAX's semi step."""
    m = _check_semi_step_against_jax({"InfonceParams": {
        "feature_names": ["Conv5", "Up_conv2"], "weights": [1.0, 0.5],
        "contrast_ons": ["partition", "self"], "spatial_size": [1, 6]}})
    assert {"infonce/Conv5/partition/loss", "infonce/Up_conv2/self/loss"} <= set(m)


def test_dense_self_paced_and_superpixel_semi_step_matches_jax():
    """Dense InfoNCE, self-paced InfoNCE (encoder by patient, dense on its
    16 x 16 grid) and superpixel InfoNCE (sharing the dense hook's 8 x 8
    draws) with consistency, at epoch 2 of 10 of the self-paced ramp."""
    m = _check_semi_step_against_jax({
        "InfonceParams": {"feature_names": "Up_conv2", "weights": 0.5, "contrast_ons": "self",
                          "spatial_size": 8},
        "SPInfonceParams": {"feature_names": ["Conv5", "Up_conv2"], "weights": [0.3, 0.2],
                            "contrast_ons": ["patient", "self"], "begin_values": 4.0,
                            "end_values": 10.0, "mode": "hard"},
        "ConsistencyParameters": {"weight": 1.0},
        "InfonceSuperPixelParams": {"feature_names": "Up_conv2", "weights": 0.7,
                                    "spatial_size": 8}}, epoch=2)
    assert 0.0 < float(m["spinfonce/Conv5/patient/sp_weight"]) <= 1.0
    assert np.isfinite(float(m["infonce/Up_conv2/superpixel/loss"]))
