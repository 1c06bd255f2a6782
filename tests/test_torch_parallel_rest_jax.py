"""The cross-correlation block, MixUp, multicore, DMT and the pretrain step
of the PyTorch port on two gloo ranks held against JAX's sharded step on
``make_mesh(2)`` (tests/test_parallel.py's
``test_hook_zoo_sharded_matches_single_device`` and
``test_pretrain_infonce_sharded_matches_single_device``), on the CPU: the
configurations of tests/torch_dp.py ``REST_CONFIGS`` named in ``NAMES``
(the block on Up_conv2 with cc, mi, rr and imsat; MixUp under the ``ft``
step; multicore with the IIC segmentation hook; DMT ``method1``,
``method4`` and ``second_order``; the pretrain step with the encoder
InfoNCE hook on Conv5 by partition, colour jitter 0.5), each with the JAX
hook of the same parameters. The U-Net at max_channel 128 (JAX's least), f32, a global
batch of 4 + 4 slices of 32 x 32 from a seeded numpy generator; the port's
initial weights bridged to JAX (``utils/torch_convert.py``), JAX's hook
heads bridged to the port, JAX's draws (the transforms, MixUp's GeoParams,
``lam`` and permutation, the pretrain views' draws) replayed at the global
batch and cut by the port's rule; RAdam, one step, JAX's step jitted (the
pretrain step's optimizer freezing the layers after Conv5, as JAX's
trainer labels them). The ranks spawn once for the module
(tests/torch_dp.py ``hooks_worker``).

Tolerances, JAX's own sharded-vs-unsharded ones (tests/test_parallel.py):
the losses rel 2e-3; the model's parameters, the hooks' heads and states
atol 5e-5, for DMT (the teacher, its statistics and Adam moments) 3e-3;
here over every tensor, where JAX's test reads the first.
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
from contrastyou_tpu.hooks import dmt as jdmt
from contrastyou_tpu.hooks.ccblock import CrossCorrelationHook as JCCHook
from contrastyou_tpu.hooks.infonce import INFONCEHook as JINFONCEHook
from contrastyou_tpu.hooks.midl import IIDSegmentationTrainerHook as JIIDSeg
from contrastyou_tpu.hooks.mixup import MixUpTrainHook as JMixUp
from contrastyou_tpu.losses import multicore as jmc
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.models import trainable_mask as jtrainable_mask
from contrastyou_tpu.parallel import make_mesh, replicate as jreplicate
from contrastyou_tpu.parallel import shard_batch as jshard_batch
from contrastyou_tpu.trainers.multicore import prototype_groups as jgroups
from contrastyou_tpu.trainers.pretrain import build_pretrain_step as jbuild_pretrain
from contrastyou_tpu_torch.engine.steps import StepDraws
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_cluster_head_state_dict,
                                                        flax_to_head_state_dict,
                                                        flax_to_hook_state, state_dict_to_flax)
from test_torch_mixup import jax_mixup_draws
from test_torch_parallel_hooks_jax import ENV, np_batch
from test_torch_pretrain import _replayed_draws as replayed_pretrain_draws
from test_torch_semi_dense import _replayed_semi_draws
from torch_dp import (CC_TINY, DMT_HOOK, DMT_LARGE_META, DMT_SO_HOOK, MIXUP_WEIGHT,
                      PRETRAIN_JITTER, REST_CONFIGS, hooks_worker, pretrain_batch, spawn)

B, S, MC, W = 4, 32, 128, 2
KEY = 11
NAMES = ["cc_tap", "dmt_method1", "dmt_method4", "dmt_second_order", "mixup", "multicore",
         "pretrain"]
#: the pretrain configuration's cut (its hook's tap)
UNTIL = "Conv5"


def _dmt(method):
    kw = DMT_SO_HOOK if method in DMT_LARGE_META else DMT_HOOK
    return lambda: jdmt.DifferentiableMeanTeacherTrainerHook(name="dmt", method_name=method,
                                                              **kw)


#: configuration -> (JAX hooks, atol)
JAX_HOOKS = {
    "cc_tap": (lambda: [JCCHook(name="cc_Up_conv2", feature_name="Up_conv2", num_clusters=5,
                                num_subheads=2, hooks=CC_TINY)], 5e-5),
    "dmt_method1": (lambda: [_dmt("method1")()], 3e-3),
    "dmt_method4": (lambda: [_dmt("method4")()], 3e-3),
    "dmt_second_order": (lambda: [_dmt("second_order")()], 3e-3),
    "mixup": (lambda: [JMixUp(weight=MIXUP_WEIGHT)], 5e-5),
    "multicore": (lambda: [JIIDSeg(weight=0.01)], 5e-5),
    "pretrain": (lambda: [JINFONCEHook(name="infonce", feature_name=UNTIL, weight=1.0,
                                       contrast_on="partition")], 5e-5),
}
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


def _classes(name: str) -> int:
    return 4 * REST_CONFIGS[name][3].get("multiplier", 1)


def initial_weights(name: str):
    """Port-initialized U-Net weights of configuration ``name``:
    (state_dict, flax params, flax stats)."""
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32,
                 num_classes=_classes(name)).init_weights(torch.Generator().manual_seed(2))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = state_dict_to_flax(sd)
    return sd, tree["params"], tree["batch_stats"]


def _pretrain_labels(trainables):
    params, hook_params = trainables
    mask = jtrainable_mask(params, elements=JUNet.arch_elements, enable=False, start=UNTIL,
                           include_start=False)
    return (jax.tree.map(lambda m: "train" if m else "freeze", mask),
            jax.tree.map(lambda _: "train", hook_params))


def jax_sharded_step(name: str, params, stats):
    """Configuration ``name``'s JAX hooks, their initial params, and its step
    on ``make_mesh(2)`` from the flax ``params`` and ``stats``: ``run()`` ->
    (state after, metrics), numpy trees."""
    make, _ = JAX_HOOKS[name]
    jhooks = make()
    mode, epoch = REST_CONFIGS[name][:2]
    b = np_batch()
    if mode == "ft":
        b = {k: b[k] for k in ("labeled_image", "labeled_target")}
    elif mode == "pretrain":
        b = pretrain_batch(b)
    bundle = JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=jnp.float32,
                           num_classes=_classes(name)),
                     jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                     (S, S, 1))
    labels = _pretrain_labels if mode == "pretrain" else None
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200, param_labels=labels)
    state = jinit(bundle, jhooks, tx, jax.random.PRNGKey(1))
    if mode == "pretrain":
        step = jbuild_pretrain(bundle, tx, jhooks, until=UNTIL, color_jitter=PRETRAIN_JITTER)
    else:
        kw = {}
        if name.startswith("multicore"):
            crit = jmc.MultiCoreKL(jgroups(4, REST_CONFIGS[name][3]["multiplier"]))
            kw = dict(sup_criterion=crit, prob_transform=crit.reduced_simplex,
                      target_num_classes=4)
        step = jbuild(bundle, tx, jhooks, two_stage=True, mode=mode, **kw)

    def run():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in ENV.items():
                mp.setenv(k, v)
            mesh = make_mesh(W)
            new, m = step(jreplicate(state, mesh),
                          jshard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh),
                          jax.random.PRNGKey(KEY), jnp.int32(epoch))
        return jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, m)

    return jhooks, jax.tree.map(np.asarray, state.hook_params), run


def replayed_draws(name: str):
    """JAX's draws of the step key at the global batch, in the port's form."""
    key = jax.random.PRNGKey(KEY)
    mode = REST_CONFIGS[name][0]
    if mode == "pretrain":
        return replayed_pretrain_draws(key, B, (16, 16), PRETRAIN_JITTER)
    if mode == "ft":
        return StepDraws(None, None, {"mixup": jax_mixup_draws(key, B)}, {})
    return _replayed_semi_draws(key, B, [])._replace(hooks={})


def _heads(jhooks, hparams) -> dict:
    out = {}
    for h in jhooks:
        if hparams.get(h.name):
            convert = (flax_to_cluster_head_state_dict if isinstance(h, JCCHook)
                       else flax_to_head_state_dict)
            out[h.name] = convert(hparams[h.name])
    return out


@pytest.fixture(scope="module")
def weights():
    return {name: initial_weights(name) for name in NAMES}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """(JAX's sharded steps, the ranks' results): the ranks start from
    JAX's initial heads and run while JAX's steps compile and run."""
    d = tmp_path_factory.mktemp("dp_rest_jax")
    steps = {name: jax_sharded_step(name, *weights[name][1:]) for name in NAMES}
    b = {k: torch.tensor(v).long() if v.dtype == np.int32 else torch.tensor(v)
         for k, v in np_batch().items()}
    job = {"max_channel": MC, "size": S, "seed": 4, "steps": 1, "batch": b,
           "models": {name: weights[name][0] for name in NAMES},
           "heads": {name: _heads(*steps[name][:2]) for name in NAMES},
           "draws": {name: [replayed_draws(name)] for name in NAMES}, "configs": NAMES}
    torch.save(job, d / "job.pt")
    started = spawn(hooks_worker, W, str(d / "job.pt"), str(d), join=False)
    jax_runs = {name: (jhooks, hparams, *run()) for name, (jhooks, hparams, run)
                in steps.items()}
    while not started.join():
        pass
    return jax_runs, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_jax_sharded_step(runs, weights, name):
    """Rank 0's step of configuration ``name`` against JAX's sharded step:
    the losses, the model's parameters (the trainable ones under
    ``pretrain``), the hooks' heads, DMT's teacher and its optimizer state,
    and the block's ``imsat_weight``."""
    jax_runs, ranks = runs
    jhooks, hparams, jnew, jm = jax_runs[name]
    atol = JAX_HOOKS[name][1]
    got = ranks[0][name]
    metrics = got["metrics"][0]
    for k, v in jm.items():
        if not k.startswith("dice"):
            assert float(metrics[k]) == pytest.approx(float(v), rel=2e-3), k
    sd = dict(weights[name][0])
    sd.update({k: v for k, v in got["params"].items() if "/" not in k})
    sd.update(got["buffers"])
    new = _leaves(state_dict_to_flax(sd)["params"])
    before = _leaves(weights[name][1])
    moved = 0
    for path, v in _leaves(jnew.params).items():
        np.testing.assert_allclose(new[path], v, rtol=0, atol=atol, err_msg=f"params {path}")
        moved += int(not np.array_equal(v, before[path]))
    assert moved, name
    heads = _heads(jhooks, jax.tree.map(np.asarray, jnew.hook_params))
    for h, sd_h in heads.items():
        for k, v in sd_h.items():
            np.testing.assert_allclose(got["params"][f"{h}/projector.{k}"].numpy(), v.numpy(),
                                       rtol=0, atol=atol, err_msg=f"{h} head {k}")
    hs = got["hook_states"]
    for h in jhooks:
        state = jnew.hook_states.get(h.name)
        if isinstance(h, jdmt.DifferentiableMeanTeacherTrainerHook):
            teacher = flax_to_hook_state(state)
            assert int(hs["dmt/ema_step"]) == teacher["ema_step"] == 1
            trees = ["teacher_params", "teacher_batch_stats"]
            if "teacher_opt" in teacher:
                assert int(hs["dmt/teacher_opt/count"]) == teacher["teacher_opt"]["count"]
                trees += ["teacher_opt/mu", "teacher_opt/nu"]
            for tree in trees:
                part = teacher
                for key in tree.split("/"):
                    part = part[key]
                for k, v in part.items():
                    np.testing.assert_allclose(hs[f"dmt/{tree}/{k}"].numpy(), v.numpy(),
                                               rtol=0, atol=atol, err_msg=f"{tree} {k}")
        elif isinstance(h, JCCHook):
            np.testing.assert_allclose(float(hs[f"{h.name}/imsat_weight"]),
                                       float(state["imsat_weight"]), rtol=0, atol=atol)
