"""The hooks of the PyTorch port on two gloo ranks held against JAX's sharded
step on ``make_mesh(2)`` (tests/test_parallel.py's
``test_hook_zoo_sharded_matches_single_device``), on the CPU: MT, UAMT (2
noisy passes, epoch 1 of 4), ICT, IIC on Conv5 (5 clusters, 2 subheads),
dense InfoNCE on Up_conv2 (an 8 x 8 grid, by self) and the dense udaiic
hook (Up_conv2, padding 1, 20 clusters, 5 subheads; JAX's E1 in interpret
mode, ``CONTRASTYOU_IIC_MERGED=kernel``, the port's E1/E2 through their
plain versions). The U-Net at max_channel 128, f32, a global batch of 4 + 4
slices of 32 x 32 from a seeded numpy generator; the port's initial weights
bridged to JAX (``utils/torch_convert.py``), JAX's hook heads bridged to the
port, JAX's draws (the transform, UAMT's noise, ICT's ``lam`` and
permutation, the dense points) replayed at the global batch and cut by the
port's ``shard_step_draws``; RAdam, one step. The ranks spawn once for the
module (tests/torch_dp.py ``hooks_worker``).

JAX's step is jitted, except for dense InfoNCE: its jitted dense hooks drift
from its op-by-op run by more than the port does (tests/test_torch_semi_
dense.py), so that one runs op by op (``jax.disable_jit``) on the mesh, in
tests/test_torch_parallel_hooks_jax_dense.py (~90 s of JAX alone).

Tolerances, JAX's own sharded-vs-unsharded ones (tests/test_parallel.py):
the losses rel 2e-3; the model's parameters and the hooks' states (the
teachers' parameters and running statistics) atol 5e-5 (MT, ICT, IIC),
3e-4 (UAMT), 2e-3 (dense InfoNCE), here over every tensor where JAX's test
reads the first; the dense udaiic hook under IIC's 5e-5.
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
from contrastyou_tpu.hooks import INFONCEHook as JINFONCEHook
from contrastyou_tpu.hooks import mt as jmt
from contrastyou_tpu.hooks.discretemi import DiscreteMITrainHook as JDiscreteMI
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.parallel import make_mesh, replicate as jreplicate
from contrastyou_tpu.parallel import shard_batch as jshard_batch
from contrastyou_tpu_torch.engine.steps import StepDraws
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_cluster_head_state_dict,
                                                        flax_to_head_state_dict,
                                                        flax_to_hook_state, state_dict_to_flax)
from test_torch_semi_dense import _replayed_semi_draws
from torch_dp import HOOK_CONFIGS, OPTIM, SCHED, hooks_worker, spawn
from torch_parity import t

B, S, MC, W = 4, 32, 128, 2
KEY = 11
#: configuration -> (JAX hook, its atol, run op by op)
JAX_HOOKS = {
    "mt": (lambda: jmt.MeanTeacherTrainerHook(weight=1.0, alpha=0.9), 5e-5, False),
    "uamt": (lambda: jmt.UAMeanTeacherTrainerHook(weight=1.0, alpha=0.9, num_noise=2,
                                                  max_epoch=4), 3e-4, False),
    "ict": (lambda: jmt.ICTMeanTeacherTrainerHook(weight=1.0, alpha=0.9), 5e-5, False),
    "iic": (lambda: JDiscreteMI(name="iic", feature_name="Conv5", num_clusters=5,
                                num_subheads=2), 5e-5, False),
    "dense_nce": (lambda: JINFONCEHook(name="dense_nce", feature_name="Up_conv2", weight=0.5,
                                       spatial_size=(8, 8), contrast_on="self"), 2e-3, True),
    "iic_dense": (lambda: JDiscreteMI(name="iic", feature_name="Up_conv2", weight=0.05,
                                      padding=1), 5e-5, False),
}
#: this file's configurations; dense InfoNCE, run op by op on JAX's side,
#: has a file of its own (tests/test_torch_parallel_hooks_jax_dense.py)
NAMES = ["ict", "iic", "iic_dense", "mt", "uamt"]
ENV = {"CONTRASTYOU_PALLAS_CONV": "0", "CONTRASTYOU_FAST_WARP": "0",
       "CONTRASTYOU_FUSED_TWOSTAGE": "0", "CONTRASTYOU_IIC_MERGED": "kernel"}


def np_batch() -> dict:
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((B, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (B, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((B, S, S, 1)).astype(np.float32),
            "unlabeled_partition": rng.integers(0, 3, (B,)).astype(np.int32),
            "unlabeled_scan_id": rng.integers(0, 4, (B,)).astype(np.int32),
            "unlabeled_patient": rng.integers(0, 4, (B,)).astype(np.int32),
            "unlabeled_cycle": np.zeros((B,), np.int32)}


def replayed_draws(name: str, jhook) -> StepDraws:
    """JAX's draws of the step key at the global batch, in the port's form."""
    key = jax.random.PRNGKey(KEY)
    grids = [(8, 8)] if name == "dense_nce" else []
    draws = _replayed_semi_draws(key, B, grids)
    k_hook = jax.random.split(key, 3)[2]
    hooks = {}
    if name == "uamt":
        hooks[name] = t(jax.random.normal(k_hook, (jhook._num_noise, B, S, S, 1)))
    elif name == "ict":
        k_lam, k_perm = jax.random.split(k_hook)
        lam = float(np.asarray(jax.random.beta(k_lam, jhook._mix_alpha, jhook._mix_alpha)))
        hooks[name] = lam, tuple(int(i) for i in np.asarray(
            jax.random.permutation(k_perm, 2 * B)))
    return draws._replace(hooks=hooks)


def initial_weights():
    """Port-initialized U-Net weights: (state_dict, flax params, flax stats)."""
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(2))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = state_dict_to_flax(sd)
    return sd, tree["params"], tree["batch_stats"]


def jax_sharded_step(name: str, params, stats):
    """Configuration ``name``'s JAX step on ``make_mesh(2)`` from the flax
    ``params`` and ``stats``: (hook, hook params before, state after,
    metrics), numpy trees."""
    make, _, op_by_op = JAX_HOOKS[name]
    jhook = make()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mesh = make_mesh(W)
        batch = jshard_batch({k: jnp.asarray(v) for k, v in np_batch().items()}, mesh)
        bundle = JBundle(JUNet(max_channel=MC, momentum=0.1, dtype=jnp.float32),
                         jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                         (S, S, 1))
        tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
        state = jinit(bundle, [jhook], tx, jax.random.PRNGKey(1))
        hparams = jax.tree.map(np.asarray, state.hook_params)
        epoch = jnp.int32(HOOK_CONFIGS[name][1])
        key = jax.random.PRNGKey(KEY)
        if op_by_op:
            with jax.disable_jit():
                new, m = jbuild(bundle, tx, [jhook], raw=True, two_stage=True, mode="semi")(
                    jreplicate(state, mesh), batch, key, epoch)
        else:
            new, m = jbuild(bundle, tx, [jhook], two_stage=True, mode="semi")(
                jreplicate(state, mesh), batch, key, epoch)
    return jhook, hparams, jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, m)


def rank_results(names, sd, jax_runs: dict, out_dir) -> list:
    """Each rank's one step of every configuration of ``names`` from the
    weights ``sd``, JAX's heads and JAX's replayed draws."""
    heads, draws = {}, {}
    for name, (jhook, hparams, _, _) in jax_runs.items():
        if hparams and hparams.get(jhook.name):
            convert = (flax_to_cluster_head_state_dict if name.startswith("iic")
                       else flax_to_head_state_dict)
            heads[name] = {jhook.name: convert(hparams[jhook.name])}
        draws[name] = [replayed_draws(name, jhook)]
    b = {k: torch.tensor(v).long() if v.dtype == np.int32 else torch.tensor(v)
         for k, v in np_batch().items()}
    job = {"max_channel": MC, "size": S, "seed": 4, "steps": 1, "batch": b, "model": sd,
           "heads": heads, "draws": draws, "configs": list(names)}
    torch.save(job, out_dir / "job.pt")
    spawn(hooks_worker, W, str(out_dir / "job.pt"), str(out_dir))
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(W)]


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_against_jax(got: dict, jax_run: tuple, atol: float) -> None:
    """Rank 0's step against JAX's sharded step, JAX's tolerances."""
    jhook, _, jnew, jm = jax_run
    metrics = got["metrics"][0]
    for k, v in jm.items():
        if not k.startswith("dice"):
            assert float(metrics[k]) == pytest.approx(float(v), rel=2e-3), k
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32)
    model.load_state_dict({**{k: v for k, v in got["params"].items() if "/" not in k},
                           **got["buffers"]})
    new = _leaves(state_dict_to_flax(model.state_dict())["params"])
    for path, v in _leaves(jnew.params).items():
        np.testing.assert_allclose(new[path], v, rtol=0, atol=atol, err_msg=f"params {path}")
    if isinstance(jhook, jmt.MeanTeacherTrainerHook):
        hs = got["hook_states"]
        teacher = flax_to_hook_state(jnew.hook_states[jhook.name])
        assert int(hs[f"{jhook.name}/ema_step"]) == teacher["ema_step"] == 1
        for tree in ("teacher_params", "teacher_batch_stats"):
            for k, v in teacher[tree].items():
                np.testing.assert_allclose(hs[f"{jhook.name}/{tree}/{k}"].numpy(), v.numpy(),
                                           rtol=0, atol=atol, err_msg=f"{tree} {k}")


@pytest.fixture(scope="module")
def weights():
    return initial_weights()


@pytest.fixture(scope="module")
def jax_runs(weights):
    _, params, stats = weights
    return {name: jax_sharded_step(name, params, stats) for name in NAMES}


@pytest.fixture(scope="module")
def ranks(weights, jax_runs, tmp_path_factory):
    return rank_results(NAMES, weights[0], jax_runs, tmp_path_factory.mktemp("dp_hooks_jax"))


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_jax_sharded_step(ranks, jax_runs, name):
    check_against_jax(ranks[0][name], jax_runs[name], JAX_HOOKS[name][1])
