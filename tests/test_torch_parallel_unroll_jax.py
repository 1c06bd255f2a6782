"""K = 2 train steps a call on two gloo ranks of the port against JAX's
mesh x unroll on ``make_mesh(2)`` (tests/test_parallel.py's
``test_sharded_unrolled_step_matches_single_device`` and
``test_cached_sharded_matches_unsharded``), on the CPU: ``semi`` with the
consistency hook host-fed (JAX's ``build_unrolled_train_step`` on batches
stacked [2, B, ...] and sharded on dim 1) and device-cached (JAX's
``build_cached_train_step(unroll=2)`` on caches placed on the mesh); the
mean teacher, MixUp under the ``ft`` step and DMT ``method1`` host-fed in
tests/test_torch_parallel_unroll_jax_hooks.py (a file of their own, so
the two spawns and their JAX compiles run on two workers). The U-Net at
max_channel 128 (JAX's least), f32, a global batch of 4 + 4 slices of 32 x
32 (2 + 2 a rank), the port's initial weights bridged to JAX, RAdam; JAX's
draws of each step's key replayed at the global batch and cut by the
port's rule (tests/torch_dp.py ``hooks_worker``, one spawn, running while
JAX's steps compile).

Tolerances, those of tests/test_torch_parallel_rest_jax.py for one step
(JAX's own sharded-vs-unsharded ones): every step's losses rel 2e-3; the
parameters after both steps atol 5e-5 (DMT, whose teacher takes a meta
step, 3e-3); device-cached, the sampled scan ids equal. DMT's second step
reads a teacher that the first step left within that 3e-3 of JAX's, so its
losses are held to rel 1e-2 (measured 4.4e-3 on its consistency loss).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.data.device_cache import DeviceDataCache as JCache
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_cached_train_step as jbuild_cached
from contrastyou_tpu.engine.steps import build_unrolled_train_step as jbuild_unrolled
from contrastyou_tpu.engine.steps import stack_batches as jstack
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.hooks import MeanTeacherTrainerHook as JMT
from contrastyou_tpu.hooks import dmt as jdmt
from contrastyou_tpu.hooks.mixup import MixUpTrainHook as JMixUp
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.parallel import make_mesh, replicate as jreplicate
from contrastyou_tpu.parallel import shard_batch as jshard_batch
from contrastyou_tpu_torch.engine.steps import StepDraws
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import state_dict_to_flax
from test_torch_mixup import jax_mixup_draws
from test_torch_parallel_hooks_jax import ENV, np_batch
from test_torch_semi_dense import _replayed_semi_draws
from torch_dp import DMT_HOOK, MIXUP_WEIGHT, hooks_worker, spawn

B, S, MC, W, K = 4, 32, 128, 2, 2
KEY = 11
RAW, SLICES = 40, (5, 6)
#: configuration -> (JAX hooks, step mode, atol of the parameters, rel of
#: the second step's losses)
CONFIGS = {"consistency": (lambda: [JConsistency(weight=1.0)], "semi", 5e-5, 2e-3),
           "mt": (lambda: [JMT(weight=1.0, alpha=0.9)], "semi", 5e-5, 2e-3),
           "mixup": (lambda: [JMixUp(weight=MIXUP_WEIGHT)], "ft", 5e-5, 2e-3),
           "dmt_method1": (lambda: [jdmt.DifferentiableMeanTeacherTrainerHook(
               name="dmt", method_name="method1", **DMT_HOOK)], "semi", 3e-3, 1e-2)}
#: this file's host-fed configurations
NAMES = ["consistency"]
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}
EPOCH = {"dmt_method1": 1}


def _weights():
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(2))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = state_dict_to_flax(sd)
    return sd, tree["params"], tree["batch_stats"]


def _jax_state(make_hooks, params, stats):
    bundle = JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=jnp.float32),
                     jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                     (S, S, 1))
    hooks = make_hooks()
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
    return bundle, hooks, tx, jinit(bundle, hooks, tx, jax.random.PRNGKey(1))


def _keys():
    return [jax.random.PRNGKey(KEY + i) for i in range(K)]


def _replayed(name: str, key):
    if CONFIGS[name][1] == "ft":
        return StepDraws(None, None, {"mixup": jax_mixup_draws(key, B)}, {})
    return _replayed_semi_draws(key, B, [])._replace(hooks={})


def _caches(seed: int = 3):
    """Two splits of RAW x RAW slices: numpy (for the ranks) and JAX's
    caches."""
    rng = np.random.default_rng(seed)
    arrays, jcaches = [], []
    for n in SLICES:
        images = rng.random((n, RAW, RAW)).astype(np.float32)
        targets = rng.integers(0, 4, (n, RAW, RAW))
        ids = {k: np.arange(n) % m for k, m in (("scan_id", 3), ("partition", 3),
                                                  ("patient", 2), ("cycle", 2))}
        arrays.append({"images": images, "targets": targets, "crop": S, **ids})
        jcaches.append(JCache(images, targets, scan_names=["a", "b", "c"], crop=S, **ids))
    return arrays, jcaches


def _cached_draws(key):
    """JAX's cached step's per-step keys (``fold_in``, ``split`` into the
    sample and step keys, the sample key into the two caches' index and
    crop keys) replayed as the port's draws of the global batches."""
    drawn = []
    for i in range(K):
        k_sample, k_step = jax.random.split(jax.random.fold_in(key, i))
        parts = {"draws": _replayed_semi_draws(k_step, B, [])._replace(hooks={})}
        for name, k, n in zip(("labeled", "unlabeled"), jax.random.split(k_sample), SLICES):
            ki, ky, kx = jax.random.split(k, 3)
            parts[name] = tuple(torch.tensor(np.asarray(v), dtype=torch.long) for v in (
                jax.random.randint(ki, (B,), 0, n), jax.random.randint(ky, (B,), 0, RAW - S + 1),
                jax.random.randint(kx, (B,), 0, RAW - S + 1)))
        drawn.append(parts)
    return drawn


def _jax_runs(weights, names, jcaches=None):
    """JAX's mesh x unroll call of each of ``names``, and with ``jcaches``
    of the cached step: name -> (state after, metrics), numpy trees."""
    _, params, stats = weights
    mesh = make_mesh(W)
    out = {}
    b = np_batch()
    for name in names:
        make, mode = CONFIGS[name][:2]
        bundle, hooks, tx, state = _jax_state(make, params, stats)
        batch = b if mode == "semi" else {k: b[k] for k in ("labeled_image", "labeled_target")}
        step = jbuild_unrolled(bundle, tx, hooks, unroll=K, two_stage=True, mode=mode)
        stacked = jstack([{k: jnp.asarray(v) for k, v in batch.items()}] * K)
        new, m = step(jreplicate(state, mesh), jshard_batch(stacked, mesh, batch_dim=1),
                      jnp.stack(_keys()), jnp.int32(EPOCH.get(name, 0)))
        out[name] = jax.tree.map(np.asarray, (new, m))
    if jcaches is None:
        return out
    bundle, hooks, tx, state = _jax_state(CONFIGS["consistency"][0], params, stats)
    for c in jcaches:
        c.place_on_mesh(mesh)
    step = jbuild_cached(bundle, tx, hooks, labeled_cache=jcaches[0],
                         unlabeled_cache=jcaches[1], labeled_batch=B, unlabeled_batch=B,
                         unroll=K, two_stage=True)
    out["cached"] = jax.tree.map(np.asarray, step(jreplicate(state, mesh),
                                                  jax.random.PRNGKey(KEY), jnp.int32(0)))
    return out


def spawned_runs(d, names, cached: bool):
    """(weights, JAX's runs, the ranks' results) of ``names`` (and of the
    cached step): the ranks run while JAX's steps compile and run."""
    weights = _weights()
    arrays, jcaches = _caches() if cached else (None, None)
    batch = {k: torch.tensor(v).long() if v.dtype == np.int32 else torch.tensor(v)
             for k, v in np_batch().items()}
    job = {"max_channel": MC, "size": S, "seed": 4, "steps": K, "unroll": K, "batch": batch,
           "models": {name: weights[0] for name in [*names, "consistency"]},
           "draws": {name: [_replayed(name, k) for k in _keys()] for name in names},
           "configs": names}
    if cached:
        job.update(cache=arrays, per_rank=B // W,
                   cached_draws=_cached_draws(jax.random.PRNGKey(KEY)))
    torch.save(job, d / "job.pt")
    started = spawn(hooks_worker, W, str(d / "job.pt"), str(d), join=False)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        jax_runs = _jax_runs(weights, names, jcaches)
    while not started.join():
        pass
    return weights, jax_runs, [torch.load(d / f"rank{r}.pt", weights_only=False)
                               for r in range(W)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawned_runs(tmp_path_factory.mktemp("dp_unroll_jax"), NAMES, cached=True)


def _check(got_metrics, got_params, jnew, jm, atol, rel2, what):
    for i in range(K):
        for k, v in jm.items():
            if not k.startswith("dice") and k not in ("labeled_scan_id", "lr"):
                assert float(got_metrics[i][k]) == pytest.approx(
                    float(v[i]), rel=2e-3 if i == 0 else rel2), (what, i, k)
    new = state_dict_to_flax({**got_params})["params"]
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(new)[0]}
    for p, v in jax.tree_util.tree_flatten_with_path(jnew.params)[0]:
        np.testing.assert_allclose(flat[jax.tree_util.keystr(p)], v, rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(p)}")


def check_config(runs, name):
    """Rank 0's call of configuration ``name`` against JAX's; the ranks'
    parameters equal."""
    weights, jax_runs, ranks = runs
    jnew, jm = jax_runs[name]
    got = ranks[0][name]
    params = {**weights[0], **{k: v for k, v in got["params"].items() if "/" not in k},
              **got["buffers"]}
    _check(got["metrics"], params, jnew, jm, *CONFIGS[name][2:], what=name)
    assert ranks[0][name]["params"].keys() == ranks[1][name]["params"].keys()
    for k, v in ranks[0][name]["params"].items():
        assert torch.equal(v, ranks[1][name]["params"][k]), k


def test_unrolled_ranks_match_jax_mesh_unroll(runs):
    check_config(runs, "consistency")


def test_cached_unrolled_ranks_match_jax_mesh_unroll(runs):
    weights, jax_runs, ranks = runs
    jnew, jm = jax_runs["cached"]
    got = ranks[0]["cached"]
    np.testing.assert_array_equal(
        np.stack([m["labeled_scan_id"].numpy() for m in got["metrics"]]), jm["labeled_scan_id"])
    _check(got["metrics"], {**weights[0], **got["params"], **got["buffers"]}, jnew, jm, 5e-5,
           2e-3, "cached")
