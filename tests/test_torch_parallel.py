"""Data parallelism of the PyTorch port (contrastyou_tpu_torch/parallel,
the data-parallel ``semi`` step of engine/steps.py) on the CPU: two gloo
ranks on 127.0.0.1 (``torch.multiprocessing.spawn``), each holding half of
the global batch, against one process on the whole batch and against JAX's
``make_mesh(2)`` sharded step (tests/test_parallel.py's setup: the U-Net at
max_channel 128, 32x32, f32; consistency and the encoder InfoNCE hook on
Conv5 by partition; the kernels' plain versions).

Tolerances:

- 2 ranks against 1 process (same weights, batch and draws): the losses
  rel 1e-5 (measured 4e-7), parameters and BN running statistics atol 2e-5
  (measured 2e-7), dice counts equal. The gradients, compared before the
  update, differ only by the order of the global sums (BatchNorm's, the
  loss shares', the gradient all-reduce): per tensor in L2 at most 2e-3, all
  together 1e-3. Reordering the rows of the one-process batch alone moves
  the deep decoder's BN biases by 5.7e-4 in L2 (measured on the CPU), the
  floor of this comparison.
- 2 ranks against JAX's sharded step (weights through
  ``utils/torch_convert.py``, JAX's draws replayed as in
  tests/test_torch_step.py): the losses rel 2e-3 and parameters atol 2e-5,
  the tolerances of JAX's own sharded-vs-unsharded test; the parameter
  updates in L2 as tests/test_torch_step.py holds them (3e-2 a tensor, 2e-2
  together), BN running statistics 1e-3 of the largest value, dice counts
  within a pixel.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.data.sampler import InfiniteRandomSampler as JSampler
from contrastyou_tpu.engine import ModelBundle as JBundle
from contrastyou_tpu.engine import init_train_state as jinit
from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu.engine.steps import build_train_step as jbuild
from contrastyou_tpu.hooks import ConsistencyTrainerHook as JConsistency
from contrastyou_tpu.hooks import INFONCEHook as JINFONCEHook
from contrastyou_tpu.models import UNet as JUNet
from contrastyou_tpu.ops.affine import sample_geo_params
from contrastyou_tpu.parallel import make_mesh, replicate as jreplicate
from contrastyou_tpu.parallel import shard_batch as jshard_batch
from contrastyou_tpu_torch.data.sampler import InfiniteRandomSampler
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (build_cached_train_step, build_train_step,
                                                check_data_parallel, init_train_state)
from contrastyou_tpu_torch.hooks.autoencoder import DenoisingAutoEncoderTrainerHook
from contrastyou_tpu_torch.hooks.ccblock import CrossCorrelationHook
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.discretemi import DiscreteIMSATTrainHook, DiscreteMITrainHook
from contrastyou_tpu_torch.hooks.dmt import DifferentiableMeanTeacherTrainerHook
from contrastyou_tpu_torch.hooks.entmin import EntropyMinTrainerHook
from contrastyou_tpu_torch.hooks.infonce import (INFONCEHook, SelfPacedINFONCEHook,
                                                 SuperPixelInfoNCEHook)
from contrastyou_tpu_torch.hooks.midl import IIDSegmentationTrainerHook, IMSATTrainHook
from contrastyou_tpu_torch.hooks.mixup import MixUpTrainHook
from contrastyou_tpu_torch.hooks.mt import (EMAEvalTrainerHook, ICTMeanTeacherTrainerHook,
                                            MeanTeacherTrainerHook, UAMeanTeacherTrainerHook)
from contrastyou_tpu_torch.hooks.orthogonal import OrthogonalTrainerHook
from contrastyou_tpu_torch.hooks.pseudolabel import PseudoLabelTrainerHook
from contrastyou_tpu_torch.losses.multicore import MultiCoreKL
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.parallel import (DataGroup, init_distributed, is_master, multi_rank,
                                            shard_batch)
from contrastyou_tpu_torch.trainers import trainer_zoo
from contrastyou_tpu_torch.utils.torch_convert import (flax_to_head_state_dict,
                                                        flax_to_state_dict, state_dict_to_flax)
from torch_dp import OPTIM, SCHED, run_cached_step, run_step, spawn, step_worker
from torch_parity import n, scaled_close, t

REPO = Path(__file__).resolve().parents[1]
#: the global batch (labeled and unlabeled), its image size, the U-Net's
#: width, the ranks, the slices of the device caches
B, S, MC, W, CACHE_N = 4, 32, 128, 2, 12
KEY = 7
LOSSES = ("sup_loss", "reg_loss", "total_loss", "consistency/loss", "nce/loss")
#: a group of two ranks that no process group backs: for the checks made
#: before any collective
TWO_RANKS = DataGroup(0, 2, torch.device("cpu"))


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.setenv("CONTRASTYOU_PALLAS_CONV", "0")
    monkeypatch.setenv("CONTRASTYOU_FAST_WARP", "0")
    monkeypatch.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")


def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((B, S, S, 1)).astype(np.float32),
            "labeled_target": rng.integers(0, 4, (B, S, S)).astype(np.int32),
            "unlabeled_image": rng.random((B, S, S, 1)).astype(np.float32),
            "unlabeled_partition": rng.integers(0, 3, (B,)).astype(np.int32),
            "unlabeled_scan_id": rng.integers(0, 4, (B,)).astype(np.int32),
            "unlabeled_patient": rng.integers(0, 4, (B,)).astype(np.int32),
            "unlabeled_cycle": np.zeros((B,), np.int32)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's initial weights and its sharded step on ``make_mesh(2)``:
    (weights before, state after, metrics)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CONTRASTYOU_PALLAS_CONV", "0")
        mp.setenv("CONTRASTYOU_FAST_WARP", "0")
        mp.setenv("CONTRASTYOU_FUSED_TWOSTAGE", "0")
        bundle = JBundle.create(JUNet(max_channel=MC, momentum=0.1, dtype=jnp.float32),
                                jax.random.PRNGKey(0), (S, S, 1))
        hooks = [JConsistency(weight=1.0),
                 JINFONCEHook(name="nce", feature_name="Conv5", weight=0.5,
                              contrast_on="partition")]
        tx, _ = jcreate(OPTIM, SCHED, max_epoch=75, steps_per_epoch=200)
        state = jinit(bundle, hooks, tx, jax.random.PRNGKey(1))
        before = jax.tree.map(np.asarray, (state.params, state.batch_stats, state.hook_params))
        step = jbuild(bundle, tx, hooks, two_stage=True, mode="semi")
        mesh = make_mesh(W)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        new, metrics = step(jreplicate(state, mesh), jshard_batch(batch, mesh),
                            jax.random.PRNGKey(KEY), jnp.int32(0))
        return before, jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, metrics)


@pytest.fixture(scope="module")
def job(jax_run):
    """The port's inputs: JAX's weights, the batch, JAX's draws replayed, and
    device caches for the cached step."""
    (params, stats, hparams), _, _ = jax_run
    k_geo, k_int, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
    geo = sample_geo_params(k_geo, B)
    gammas = jax.random.uniform(k_int, (B, 1, 1, 1), minval=0.5, maxval=2.0)
    rng = np.random.default_rng(1)
    cache = {}
    for k in ("labeled", "unlabeled"):
        cache.update({f"{k}_images": torch.tensor(rng.random((CACHE_N, S + 4, S + 4))),
                      f"{k}_targets": torch.tensor(rng.integers(0, 4, (CACHE_N, S + 4, S + 4))),
                      f"{k}_scan_id": torch.tensor(rng.integers(0, 3, CACHE_N)),
                      f"{k}_partition": torch.tensor(rng.integers(0, 3, CACHE_N))})
    return {"max_channel": MC, "size": S, "per_rank": B // W, "world": W, "seed": 5,
            "model": flax_to_state_dict(params, stats), "head": flax_to_head_state_dict(hparams["nce"]),
            "batch": {k: torch.tensor(v).long() if v.dtype == np.int32 else torch.tensor(v)
                      for k, v in _batch().items()},
            "geo": {f: torch.tensor(np.asarray(v)) for f, v in geo._asdict().items()},
            "gammas": t(gammas).reshape(B), "cache": cache}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    """Each rank's results of one semi step and one cached step."""
    d = tmp_path_factory.mktemp("dp")
    torch.save(job, d / "job.pt")
    spawn(step_worker, W, str(d / "job.pt"), str(d))
    return [torch.load(d / f"rank{r}.pt") for r in range(W)]


@pytest.fixture(scope="module")
def one_process(job):
    torch.set_num_threads(1)
    return {"step": run_step(job), "cached": run_cached_step(job)}


def _l2(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _equal_ranks(ranks, kind):
    for key in ("params", "buffers", "grads", "head_grads"):
        for name, v in ranks[0][kind][key].items():
            assert torch.equal(v, ranks[1][kind][key][name]), f"{kind} {key} {name}"


@pytest.mark.parametrize("kind", ["step", "cached"])
def test_two_ranks_match_one_process(ranks, one_process, kind):
    """The 2-rank step (host batch, or the device caches' draws) equals one
    process on the global batch; both ranks end bitwise equal."""
    _equal_ranks(ranks, kind)
    got, ref = ranks[0][kind], one_process[kind]
    for k in LOSSES:
        assert float(got["metrics"][k]) == pytest.approx(float(ref["metrics"][k]), rel=1e-5), k
    for k in ("dice_inter", "dice_union"):
        assert torch.equal(got["metrics"][k], ref["metrics"][k]), k
    for key in ("params", "buffers"):
        for name, v in ref[key].items():
            torch.testing.assert_close(got[key][name], v, rtol=0, atol=2e-5, msg=name)
    for key in ("grads", "head_grads"):
        for name, g in ref[key].items():
            assert _l2(got[key][name], g) <= 2e-3, f"{key} {name}: {_l2(got[key][name], g):.2e}"
    flat = [torch.cat([d[name].reshape(-1) for name in ref["grads"]])
            for d in (got["grads"], ref["grads"])]
    assert _l2(*flat) <= 1e-3


def test_cached_step_keeps_its_rows_of_the_global_draws(ranks, one_process):
    """Each rank of the cached step sees its rows of what one process draws
    at the global batch: images, targets, group ids, the transform and its
    result, bitwise; the scan ids of the metrics are the global batch's."""
    full = one_process["cached"]
    per = B // W
    for r, res in enumerate(ranks):
        for k, v in full["seen"].items():
            assert torch.equal(res["cached"]["seen"][k], v[r * per:(r + 1) * per]), (r, k)
        assert torch.equal(res["cached"]["metrics"]["labeled_scan_id"],
                           full["metrics"]["labeled_scan_id"])


def test_two_ranks_match_jax_sharded_step(ranks, jax_run):
    (params, stats, _), jnew, jm = jax_run
    got = ranks[0]["step"]
    for k in LOSSES:
        assert float(got["metrics"][k]) == pytest.approx(float(jm[k]), rel=2e-3), k
    for k in ("dice_inter", "dice_union"):
        assert np.abs(n(got["metrics"][k]) - jm[k]).max() <= 1, k
    model = UNet(max_channel=MC, momentum=0.1, dtype=torch.float32)
    model.load_state_dict({**got["params"], **got["buffers"]})
    new = state_dict_to_flax(model.state_dict())
    leaves = jax.tree_util.tree_flatten_with_path(new["params"])[0]
    for (path, a), b, p0 in zip(leaves, jax.tree.leaves(jnew.params), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5, err_msg=jax.tree_util.keystr(path))
        upd, jupd = a - p0, b - p0
        err = np.linalg.norm(upd - jupd) / max(np.linalg.norm(jupd), 1e-30)
        assert err <= 3e-2, f"update {jax.tree_util.keystr(path)}: {err:.3e}"
    cat = [np.concatenate([np.ravel(x - p) for x, p in zip(xs, jax.tree.leaves(params))])
           for xs in ([a for _, a in leaves], jax.tree.leaves(jnew.params))]
    assert np.linalg.norm(cat[0] - cat[1]) <= 2e-2 * np.linalg.norm(cat[1])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                            jax.tree.leaves(jnew.batch_stats)):
        scaled_close(a, b, tol=1e-3, what=f"stats {jax.tree_util.keystr(path)}")


def test_one_rank_group_runs_no_collective(job):
    """A group of one rank takes the one-process path: no process group
    exists here, so any collective would raise; the results are bitwise
    those without a group."""
    torch.set_num_threads(1)
    a, b = run_step(job), run_step(job, DataGroup.single())
    for key in ("params", "grads", "buffers"):
        for name, v in a[key].items():
            assert torch.equal(v, b[key][name]), (key, name)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_strides_match_jax(world, shuffle):
    """Rank r of the port's sampler yields JAX's process r's stride
    ``order[r::world]`` of the same seeded permutations."""
    size, draws = 11, 30
    for r in range(world):
        port = iter(InfiniteRandomSampler(size, seed=4, shuffle=shuffle, process_index=r,
                                          process_count=world))
        ref = iter(JSampler(size, shuffle=shuffle, seed=4, process_index=r,
                            process_count=world))
        assert [next(port) for _ in range(draws)] == [next(ref) for _ in range(draws)]


def test_shard_batch_cuts_rows_and_keeps_scalars():
    batch = {"x": torch.arange(12).reshape(6, 2), "lam": torch.tensor(0.5),
             "pair": (torch.arange(6), None)}
    out = shard_batch(batch, DataGroup(1, 3, torch.device("cpu")))
    assert torch.equal(out["x"], torch.tensor([[4, 5], [6, 7]]))
    assert torch.equal(out["lam"], batch["lam"]) and out["pair"][1] is None
    assert torch.equal(out["pair"][0], torch.tensor([2, 3]))
    assert shard_batch(batch, None) is batch
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": torch.zeros(5)}, TWO_RANKS)


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1", "RANK": "0"}])
def test_one_process_starts_no_process_group(monkeypatch, env):
    """Without torchrun's variables, or with a world of one, the run is one
    process: a group of one rank on the device asked for, nothing started,
    and this process writes the run's files."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    group = init_distributed(device="cpu")
    assert group == DataGroup.single("cpu") and multi_rank(group) is None
    assert not torch.distributed.is_initialized() and is_master()


class _UnportedHook(ConsistencyTrainerHook):
    """A hook whose batch reductions are not global: the step refuses it on
    W > 1 ranks (every hook of the port runs there now)."""

    data_parallel = False


#: hooks that do not run on W > 1 ranks: a stub, every hook of the port
#: running there
UNPORTED_HOOKS = {
    "stub": lambda: _UnportedHook(name="stub"),
}
#: the hooks beyond consistency and the encoder InfoNCE hook that run on
#: W > 1 ranks (tests/test_torch_parallel_hooks.py holds them against one
#: process)
PORTED_HOOKS = {
    "entmin": lambda: EntropyMinTrainerHook(),
    "pseudolabel": lambda: PseudoLabelTrainerHook(),
    "orth": lambda: OrthogonalTrainerHook(),
    "dae": lambda: DenoisingAutoEncoderTrainerHook(),
    "mt": lambda: MeanTeacherTrainerHook(),
    "uamt": lambda: UAMeanTeacherTrainerHook(),
    "ict": lambda: ICTMeanTeacherTrainerHook(),
    "ema_eval": lambda: EMAEvalTrainerHook(),
    "iic": lambda: DiscreteMITrainHook(name="iic", feature_name="Conv5", in_dim=8),
    "discrete_imsat": lambda: DiscreteIMSATTrainHook(name="discrete_imsat",
                                                     feature_name="Conv5", in_dim=8),
    "midl_hook": lambda: IIDSegmentationTrainerHook(),
    "imsat": lambda: IMSATTrainHook(),
    "dense_nce": lambda: INFONCEHook(name="dense_nce", feature_name="Up_conv2", in_dim=8,
                                     spatial_size=(8, 8), contrast_on="self"),
    "spnce": lambda: SelfPacedINFONCEHook(name="spnce", feature_name="Conv5", in_dim=8),
    "spixel": lambda: SuperPixelInfoNCEHook(name="spixel", feature_name="Up_conv2", in_dim=8,
                                            spatial_size=(8, 8)),
    "mixup": lambda: MixUpTrainHook(),
    "dmt": lambda: DifferentiableMeanTeacherTrainerHook(),
    "cc": lambda: CrossCorrelationHook(name="cc", feature_name="Conv5", in_dim=8, hooks={}),
}
#: the trainers beyond SemiTrainer that run on W > 1 ranks
PORTED_TRAINERS = ("ft", "mt", "mixup", "multicore", "dmt")
#: the trainers that refuse W > 1 ranks, and why: JAX's loops of these do
#: not shard their batches
REFUSED_TRAINERS = {"adv": "adversarial loop does not shard",
                    "pretrain": "pretraining loop does not shard",
                    "pretrain_decoder": "pretraining loop does not shard"}


def _bundle():
    model = UNet(max_channel=16, dtype=torch.float32)
    return ModelBundle(model, (S, S, 1))


@pytest.mark.parametrize("name", sorted(UNPORTED_HOOKS))
def test_unported_hook_raises_on_two_ranks(name):
    hook = UNPORTED_HOOKS[name]()
    with pytest.raises(NotImplementedError, match=f"hook '{name}' \\({type(hook).__name__}\\)"):
        build_train_step(_bundle(), [ConsistencyTrainerHook(), hook], data_group=TWO_RANKS)
    build_train_step(_bundle(), [hook])     # one process: as before


@pytest.mark.parametrize("name", sorted(PORTED_HOOKS) + [f"trainer:{k}" for k in PORTED_TRAINERS])
def test_ported_hook_or_trainer_passes_the_check_on_two_ranks(name, tmp_path):
    """Each hook and trainer this port runs on W ranks builds its step (or
    the trainer) on two ranks without raising."""
    if name.startswith("trainer:"):
        key = name.split(":")[1]
        extra = {"true_num_classes": 4} if key == "multicore" else {}
        trainer = trainer_zoo[key](model=None, labeled_loader=None, data_group=TWO_RANKS,
                                   save_dir=str(tmp_path), **extra)
        assert trainer.data_parallel
        return
    hook = PORTED_HOOKS[name]()
    assert hook.data_parallel
    build_train_step(_bundle(), [ConsistencyTrainerHook(), hook], data_group=TWO_RANKS)
    if not hook.requires_unlabeled or hook.always_active:
        build_train_step(_bundle(), [hook], mode="ft", data_group=TWO_RANKS)


def test_ported_hooks_and_semi_step_pass_the_check():
    """The semi, ft and pretrain steps pass the check, and so does a
    criterion that declares itself a batch mean (``MultiCoreKL``); a mode
    without data parallelism and any other criterion raise."""
    hooks = [ConsistencyTrainerHook(), INFONCEHook(name="nce", feature_name="Conv5", in_dim=8)]
    check_data_parallel(hooks, TWO_RANKS)
    check_data_parallel([], TWO_RANKS, mode="ft")
    check_data_parallel(hooks, TWO_RANKS, mode="pretrain")
    with pytest.raises(NotImplementedError, match="the adversarial step"):
        check_data_parallel(hooks, TWO_RANKS, mode="adversarial")
    check_data_parallel(hooks, TWO_RANKS, sup_criterion=MultiCoreKL([[0, 1], [2, 3]]))
    bundle = _bundle()
    opt, _ = create_optimizer(bundle.model.parameters(), OPTIM, None, max_epoch=1,
                              steps_per_epoch=1)
    init_train_state(bundle, [], opt)
    with pytest.raises(NotImplementedError, match="supervised criterion"):
        build_cached_train_step(bundle, [], labeled_cache=None, unlabeled_cache=object(),
                                data_group=TWO_RANKS, sup_criterion=lambda p, o: p.sum())


@pytest.mark.parametrize("name", sorted(set(trainer_zoo) - {"semi", *PORTED_TRAINERS}))
def test_unported_trainer_raises_on_two_ranks(name):
    """The trainers left refuse W > 1 ranks and say why: JAX's loops of
    these do not shard their batches."""
    cls = trainer_zoo[name]
    with pytest.raises(NotImplementedError, match=f"{cls.__name__} does not run on 2 ranks: "
                                                  f"JAX's {REFUSED_TRAINERS[name]}"):
        cls(model=None, labeled_loader=None, data_group=TWO_RANKS)


def test_parallel_package_imports_no_jax():
    """``parallel/``, the trainer and the CUDA-graph module import none of
    JAX's modules, and a chunk of the chunked eval step runs with them
    blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'contrastyou_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "import contrastyou_tpu_torch.parallel, contrastyou_tpu_torch.engine.trainer\n"
            "from contrastyou_tpu_torch.engine.graph import EvalGraph, StepGraph\n"
            "from contrastyou_tpu_torch.engine.bundle import ModelBundle\n"
            "from contrastyou_tpu_torch.engine.steps import build_scanned_eval_step\n"
            "from contrastyou_tpu_torch.models.unet import UNet\n"
            "m = UNet(max_channel=32, dtype=torch.float32)"
            ".init_weights(torch.Generator().manual_seed(0))\n"
            "loss, inter, union = build_scanned_eval_step(ModelBundle(m, (16, 16, 1)))(\n"
            "    m, torch.rand(2, 1, 16, 16, 1), torch.zeros(2, 1, 16, 16, dtype=torch.long),\n"
            "    torch.tensor([[True], [False]]))\n"
            "assert loss.shape == (2,) and float(loss[1]) == 0 and not union[1].any()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'contrastyou_tpu') and sys.modules[m] is not None]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
