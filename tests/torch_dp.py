"""Helpers of the data-parallel CPU tests of the PyTorch port
(tests/test_torch_parallel*.py): W gloo ranks on 127.0.0.1 through
``torch.multiprocessing.spawn``, and the rank workers. The spawned processes
import this module, so it imports neither jax nor the JAX package; jobs and
results go through ``torch.save`` files."""
from __future__ import annotations

import hashlib
import socket
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from contrastyou_tpu_torch.data.creator import (create_infinite_loader, create_val_loader,
                                                split_dataset)
from contrastyou_tpu_torch.data.datasets import data_zoo
from contrastyou_tpu_torch.augment.host import make_crop_transforms
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import StepContext, hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_cached_train_step,
                                                build_train_step, build_unrolled_train_step,
                                                init_train_state, sample_ft_draws,
                                                sample_step_draws, shard_step_draws,
                                                stack_batches)
from contrastyou_tpu_torch.hooks.autoencoder import DenoisingAutoEncoderTrainerHook
from contrastyou_tpu_torch.hooks.ccblock import CrossCorrelationHook
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.discretemi import DiscreteIMSATTrainHook, DiscreteMITrainHook
from contrastyou_tpu_torch.hooks.dmt import METHODS, DifferentiableMeanTeacherTrainerHook
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
from contrastyou_tpu_torch.models.unet import BatchNorm
from contrastyou_tpu_torch.ops.affine import GeoParams, transform_image
from contrastyou_tpu_torch.parallel import (data_parallel, gather_rows, init_distributed,
                                            num_ranks, replicate, shard_batch, sum_over_ranks)
from contrastyou_tpu_torch.parallel.mesh import _map
from contrastyou_tpu_torch.trainers import FineTuneTrainer, MTTrainer, SemiTrainer
from contrastyou_tpu_torch.trainers.multicore import prototype_groups
from contrastyou_tpu_torch.trainers.pretrain import (build_pretrain_step,
                                                     feature_until_from_hooks,
                                                     pretrain_trainable, sample_pretrain_draws)

#: the optimizer of the step tests (tests/test_torch_step.py's): RAdam, lr 1e-3
#: at the first step
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(worker, world: int, *args, join: bool = True):
    """Run ``worker(group, *args)`` on ``world`` gloo ranks of CPU processes;
    with ``join`` False, return at once the processes' context, whose
    ``join()`` is True once they have all ended."""
    return mp.spawn(_entry, args=(world, free_port(), worker, args), nprocs=world, join=join)


def _entry(rank, world, port, worker, args):
    torch.set_num_threads(1)
    group = init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                             device="cpu")
    try:
        worker(group, *args)
    finally:
        dist.destroy_process_group()


# --- one semi step ----------------------------------------------------------

class RecordingConsistency(ConsistencyTrainerHook):
    """The consistency hook, keeping what the step handed it: the rank's
    batch rows and the transformed unlabeled batch."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.seen = {}

    def loss(self, ctx, state):
        self.seen = {"labeled_image": ctx.labeled_image, "labeled_target": ctx.labeled_target,
                     "unlabeled_image": ctx.unlabeled_image,
                     "unlabeled_image_tf": ctx.unlabeled_image_tf,
                     "partition": ctx.partition_group,
                     **{f"geo_{k}": v for k, v in ctx.geo_params._asdict().items()}}
        return super().loss(ctx, state)


def build_step_state(job: dict):
    """(bundle, hooks, state) of a job: a float32 U-Net of ``max_channel``
    with the job's weights, the recording consistency hook and the encoder
    InfoNCE hook on Conv5 by partition, RAdam over both."""
    model = UNet(max_channel=job["max_channel"], momentum=0.1, dtype=torch.float32)
    model.load_state_dict(job["model"])
    hooks = [RecordingConsistency(weight=1.0),
             INFONCEHook(name="nce", feature_name="Conv5", weight=0.5, contrast_on="partition",
                         in_dim=model.get_channel_dim("Conv5"))]
    hooks[1].projector.load_state_dict(job["head"])
    bundle = ModelBundle(model, (job["size"], job["size"], 1))
    opt, _ = create_optimizer(list(model.parameters()) + hook_parameters(hooks), OPTIM, SCHED,
                              max_epoch=75, steps_per_epoch=200)
    return bundle, hooks, init_train_state(bundle, hooks, opt)


def job_draws(job: dict) -> StepDraws:
    return StepDraws(GeoParams(**job["geo"]), job["gammas"])


def job_caches(job: dict):
    c = job["cache"]
    return [DeviceDataCache.from_arrays(c[f"{k}_images"], c[f"{k}_targets"], crop=job["size"],
                                        device="cpu", scan_id=c[f"{k}_scan_id"],
                                        partition=c[f"{k}_partition"])
            for k in ("labeled", "unlabeled")]


def step_result(state, hooks, metrics) -> dict:
    """What the tests compare after a step."""
    model = state.model
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "head_grads": {k: p.grad.clone() for k, p in hooks[1].named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "seen": {k: v.clone() for k, v in hooks[0].seen.items()}}


def run_step(job: dict, group=None) -> dict:
    """One semi step on the job's global batch and draws (this rank's rows)."""
    bundle, hooks, state = build_step_state(job)
    for module in (state.model, hooks[1]):
        replicate(module, group)
    step = build_train_step(bundle, hooks, data_group=group)
    metrics = step(state, shard_batch(job["batch"], group), shard_batch(job_draws(job), group))
    return step_result(state, hooks, metrics)


def run_cached_step(job: dict, group=None) -> dict:
    """One cached semi step at ``job['per_rank']`` slices a rank."""
    bundle, hooks, state = build_step_state(job)
    lab, unl = job_caches(job)
    b = job["per_rank"] * (job["world"] if group is None else 1)
    step = build_cached_train_step(bundle, hooks, labeled_cache=lab, unlabeled_cache=unl,
                                   labeled_batch=b, unlabeled_batch=b, data_group=group)
    gen = torch.Generator().manual_seed(job["seed"])
    return step_result(state, hooks, step(state, gen))


def step_worker(group, job_path: str, out_dir: str) -> None:
    job = torch.load(job_path)
    out = {"step": run_step(job, group), "cached": run_cached_step(job, group)}
    torch.save(out, Path(out_dir) / f"rank{group.rank}.pt")


# --- the trainer loop -----------------------------------------------------------

def semi_trainer(spec: dict, save_dir: str, *, per_rank: int, device_cache: bool,
                 max_epoch: int, group=None, kind: str = "semi"):
    """A trainer on the synthetic layout of ``spec`` at the test's small
    size: the U-Net of ``max_channel`` (f32), loaders of ``per_rank`` slices
    a rank (host-fed, rank r reads its stride of the indices). ``kind``:
    ``semi``, a SemiTrainer with consistency and the encoder InfoNCE hook;
    ``mt``, an MTTrainer with the MT hook (evaluated on its teacher);
    ``ft``, a FineTuneTrainer with the EMA eval hook evaluated in the
    student's place."""
    size = spec["size"]
    transforms = make_crop_transforms(size)
    tra = data_zoo["acdc"](root_dir=spec["root"], mode="train", transforms=transforms.train)
    test = data_zoo["acdc"](root_dir=spec["root"], mode="val", transforms=transforms.val)
    lab_set, unlab_set, *_ = split_dataset(tra, 2, seed=1)
    rank, world = (0, 1) if group is None else (group.rank, group.size)
    lab, unlab = (create_infinite_loader(d, batch_size=per_rank, seed=0, process_index=rank,
                                         process_count=world) for d in (lab_set, unlab_set))
    val, test = create_val_loader(test_dataset=test, data_name="acdc", group_scan=True)
    model = UNet(max_channel=spec["max_channel"], momentum=0.1, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    model.init_weights(gen)
    if kind == "semi":
        cls = SemiTrainer
        hooks = [ConsistencyTrainerHook(weight=1.0),
                 INFONCEHook(name="nce", feature_name="Conv5", weight=0.5,
                             contrast_on="partition",
                             in_dim=model.get_channel_dim("Conv5")).init_weights(gen)]
    else:
        cls, hooks = {"mt": (MTTrainer, [MeanTeacherTrainerHook(weight=1.0, alpha=0.9)]),
                      "ft": (FineTuneTrainer, [EMAEvalTrainerHook(alpha=0.9)])}[kind]
    trainer = cls(model=model, labeled_loader=lab,
                  unlabeled_loader=None if kind == "ft" else unlab, val_loader=val,
                  test_loader=test, save_dir=save_dir, max_epoch=max_epoch,
                  num_batches=spec["num_batches"], seed=0, device_cache=device_cache,
                  data_group=group, config={"Optim": OPTIM, "Scheduler": SCHED})
    trainer.register_hooks(*hooks)
    if kind == "ft":
        trainer.set_model4inference(hooks[0])
    trainer.init()
    return trainer


def digest(tensors) -> str:
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def params_digest(module: torch.nn.Module) -> str:
    return digest(module.parameters())


def loop_worker(group, spec: dict, out_dir: str) -> None:
    """Device-cached: one epoch, then a fresh trainer resumed from rank 0's
    ``last`` for a second; host-fed: one epoch. Each rank writes into a
    save_dir of its own, so the test sees what each wrote."""
    out, r = Path(out_dir), group.rank
    kw = dict(per_rank=spec["per_rank"], group=group)
    semi_trainer(spec, str(out / f"cached_r{r}"), device_cache=True, max_epoch=1,
                 **kw).start_training()
    trainer = semi_trainer(spec, str(out / f"cached_r{r}"), device_cache=True, max_epoch=2,
                           **kw)
    trainer.resume_from_path(str(out / "cached_r0" / "last"))
    resumed_at = trainer.cur_epoch
    trainer.start_training()
    cached_digest = params_digest(trainer._model)
    trainer.inference()
    host = semi_trainer(spec, str(out / f"host_r{r}"), device_cache=False, max_epoch=1, **kw)
    host_score = host.start_training()
    torch.save({"resumed_at": resumed_at, "cached_digest": cached_digest,
                "host_digest": params_digest(host._model), "host_score": host_score,
                "host_params": {k: p.detach().clone() for k, p in host._model.named_parameters()}},
               out / f"rank{r}.pt")


def one_process_run(spec: dict, save_dir: str, kind: str = "semi"):
    """The device-cached run of :func:`loop_worker` (or, for ``kind`` mt or
    ft, of :func:`slice_loop_worker`) in one process at the global batch,
    for two epochs unbroken."""
    torch.set_num_threads(1)
    trainer = semi_trainer(spec, save_dir, per_rank=spec["per_rank"] * spec["world"],
                           device_cache=True, max_epoch=2, kind=kind)
    trainer.start_training()
    return trainer


# --- the hooks and trainers beyond consistency and the encoder InfoNCE ---------

def _dim(model, name):
    return model.get_channel_dim(name)


#: the configurations held on W ranks against one process: name -> (step
#: mode, epoch, hooks of a model); one hook each, named as it is refused
#: without a port (tests/test_torch_parallel.py), and ``ft`` with the EMA
HOOK_CONFIGS = {
    "entmin": ("semi", 0, lambda m: [EntropyMinTrainerHook()]),
    "pseudolabel": ("semi", 0, lambda m: [PseudoLabelTrainerHook()]),
    "orth": ("semi", 0, lambda m: [ConsistencyTrainerHook(), OrthogonalTrainerHook(weight=0.5)]),
    "dae": ("semi", 0, lambda m: [DenoisingAutoEncoderTrainerHook(
        weight=0.5, num_classes=_dim(m, "Deconv_1x1"))]),
    "mt": ("semi", 0, lambda m: [MeanTeacherTrainerHook(weight=1.0, alpha=0.9)]),
    "mt_update_bn": ("semi", 0, lambda m: [MeanTeacherTrainerHook(
        name="mt", weight=1.0, alpha=0.9, update_bn=True)]),
    "uamt": ("semi", 1, lambda m: [UAMeanTeacherTrainerHook(weight=1.0, alpha=0.9, num_noise=2,
                                                            max_epoch=4)]),
    "ict": ("semi", 0, lambda m: [ICTMeanTeacherTrainerHook(weight=1.0, alpha=0.9)]),
    "ema_eval": ("semi", 0, lambda m: [ConsistencyTrainerHook(),
                                       EMAEvalTrainerHook(alpha=0.9)]),
    "ft": ("ft", 0, lambda m: [EMAEvalTrainerHook(alpha=0.9)]),
    "iic": ("semi", 0, lambda m: [DiscreteMITrainHook(
        name="iic", feature_name="Conv5", in_dim=_dim(m, "Conv5"), num_clusters=5,
        num_subheads=2)]),
    "iic_dense": ("semi", 0, lambda m: [DiscreteMITrainHook(
        name="iic", feature_name="Up_conv2", in_dim=_dim(m, "Up_conv2"), weight=0.05,
        padding=1)]),
    "iic_dense_p0": ("semi", 0, lambda m: [DiscreteMITrainHook(
        name="iic", feature_name="Up_conv2", in_dim=_dim(m, "Up_conv2"), num_clusters=5,
        num_subheads=2, padding=0)]),
    "discrete_imsat": ("semi", 0, lambda m: [DiscreteIMSATTrainHook(
        name="discrete_imsat", feature_name="Conv5", in_dim=_dim(m, "Conv5"), num_clusters=5,
        num_subheads=2)]),
    "midl_hook": ("semi", 0, lambda m: [IIDSegmentationTrainerHook()]),
    "imsat": ("semi", 0, lambda m: [IMSATTrainHook()]),
    "dense_nce": ("semi", 0, lambda m: [INFONCEHook(
        name="dense_nce", feature_name="Up_conv2", in_dim=_dim(m, "Up_conv2"), weight=0.5,
        spatial_size=(8, 8), contrast_on="self")]),
    "spnce": ("semi", 2, lambda m: [
        SelfPacedINFONCEHook(name="spnce", feature_name="Conv5", in_dim=_dim(m, "Conv5"),
                             weight=0.3, contrast_on="patient", mode="hard", begin_value=4.0,
                             end_value=10.0, max_epoch=10),
        SelfPacedINFONCEHook(name="spnce_dense", feature_name="Up_conv2",
                             in_dim=_dim(m, "Up_conv2"), weight=0.2, spatial_size=(8, 8),
                             contrast_on="self", mode="soft", begin_value=4.0, end_value=10.0,
                             correct_grad=True, max_epoch=10)]),
    "spixel": ("semi", 0, lambda m: [SuperPixelInfoNCEHook(
        name="spixel", feature_name="Up_conv2", in_dim=_dim(m, "Up_conv2"), weight=0.7,
        spatial_size=(8, 8))]),
}


#: the cross-correlation block, MixUp, multicore, DMT and the pretrain step
#: on W > 1 ranks (tests/test_torch_parallel_rest*.py): name -> (step mode,
#: epoch, hooks of a model, options); options ``multiplier`` (multicore:
#: the model predicts that many prototypes a class, the step takes
#: ``MultiCoreKL``), mode ``pretrain`` (the forward cut at the hooks'
#: deepest tap, the later layers frozen, the unlabeled batch the
#: contrastive one)
CC_TINY = {"cc": {"weight": 0.3, "kernel_size": 5, "diff_power": 0.75},
           "mi": {"weight": 0.5, "lamda": 1.5, "padding": 0},
           "rr": {"weight": 1.0, "alpha": 0.5, "lamda": 1.5, "symmetric": True},
           "imsat": {"weight": 0.1, "use_dynamic": True}}
#: the DMT hook of the rest configurations (tests/test_torch_dmt.py's);
#: ``second_order`` and ``method2`` with a meta weight large enough for the
#: Hessian term and for the meta gradient's step to show in the loss
DMT_HOOK = dict(weight=10.0, alpha=0.99, weight_decay=1e-6, meta_weight=1e-3)
DMT_SO_HOOK = dict(weight=1.0, alpha=0.5, meta_weight=0.1)
DMT_LARGE_META = ("second_order", "method2")
MIXUP_WEIGHT = 0.1


def _cc(m, feature, tiny, subheads=2):
    return CrossCorrelationHook(name=f"cc_{feature}", feature_name=feature,
                                in_dim=_dim(m, feature), num_clusters=5,
                                num_subheads=subheads, hooks=tiny)


def _nce_encoder(m, weight=1.0):
    return INFONCEHook(name="infonce", feature_name="Conv5", in_dim=_dim(m, "Conv5"),
                       weight=weight, contrast_on="partition")


def _dmt(method):
    kw = DMT_SO_HOOK if method in DMT_LARGE_META else DMT_HOOK
    return lambda m: [DifferentiableMeanTeacherTrainerHook(name="dmt", method_name=method, **kw)]


REST_CONFIGS = {
    "cc_tap": ("semi", 0, lambda m: [_cc(m, "Up_conv2", CC_TINY)], {}),
    "cc_logits": ("semi", 0, lambda m: [_cc(m, "Deconv_1x1", dict(
        CC_TINY, consist={"weight": 0.2}))], {}),
    "mixup": ("ft", 0, lambda m: [MixUpTrainHook(weight=MIXUP_WEIGHT)], {}),
    "multicore": ("semi", 0, lambda m: [IIDSegmentationTrainerHook(weight=0.01)],
                  {"multiplier": 2}),
    "multicore_mt": ("semi", 0, lambda m: [IIDSegmentationTrainerHook(weight=0.01),
                                           MeanTeacherTrainerHook(weight=1.0, alpha=0.9)],
                     {"multiplier": 2}),
    **{f"dmt_{k}": ("semi", 1, _dmt(k), {}) for k in METHODS},
    "pretrain": ("pretrain", 0, lambda m: [_nce_encoder(m)], {}),
    "pretrain_cc": ("pretrain", 0, lambda m: [
        _nce_encoder(m), _cc(m, "Up_conv2", {k: CC_TINY[k] for k in ("cc", "rr")}, 1)], {}),
}
#: every configuration a rank worker runs (``consistency``: the hook alone,
#: tests/test_torch_parallel_unroll_jax.py's)
CONFIGS = {**{k: (*v, {}) for k, v in HOOK_CONFIGS.items()}, **REST_CONFIGS,
           "consistency": ("semi", 0, lambda m: [ConsistencyTrainerHook(weight=1.0)], {})}
#: the colour jitter of the pretrain configurations (ACDC's)
PRETRAIN_JITTER = 0.5


def build_hook_state(job: dict, name: str):
    """(bundle, hooks, state) of configuration ``name``: the f32 U-Net of the
    job's ``max_channel`` with the job's weights (``models[name]``, else
    ``model``, else weights drawn from its seed), the configuration's hooks with the job's heads for it (or drawn),
    RAdam over both (under ``pretrain`` over the trainable layers)."""
    mode, _, make_hooks, opts = CONFIGS[name]
    model = UNet(max_channel=job["max_channel"], momentum=0.1, dtype=torch.float32,
                 num_classes=4 * opts.get("multiplier", 1))
    weights = job.get("models", {}).get(name, job.get("model"))
    if weights is not None:
        model.load_state_dict(weights)
    else:
        model.init_weights(torch.Generator().manual_seed(job["seed"]))
    hooks = make_hooks(model)
    gen = torch.Generator().manual_seed(job["seed"] + 1)
    for h in hooks:
        if isinstance(h, torch.nn.Module):
            h.init_weights(gen)
            heads = job.get("heads", {}).get(name, {})
            if h.name in heads:
                h.projector.load_state_dict(heads[h.name])
    bundle = ModelBundle(model, (job["size"], job["size"], 1))
    params = list(model.parameters())
    if mode == "pretrain":
        trainable = pretrain_trainable(feature_until_from_hooks(*hooks))
        params = [p for k, p in model.named_parameters() if trainable(k)]
    opt, _ = create_optimizer(params + hook_parameters(hooks), OPTIM, SCHED, max_epoch=75,
                              steps_per_epoch=200)
    return bundle, hooks, init_train_state(bundle, hooks, opt)


def pretrain_batch(batch: dict) -> dict:
    """The contrastive batch of a job's batch: its unlabeled images and
    group ids."""
    return {k.split("_", 1)[1]: v for k, v in batch.items()
            if k.startswith("unlabeled_") and k != "unlabeled_superpixel"}


def global_draws(job: dict, name: str, hooks, i: int):
    """The draws of step ``i`` at the global batch: the job's (replayed from
    JAX) when it has them, else the step's and the host's generators seeded
    from the job's seed and ``i``, as every rank draws them."""
    if "draws" in job:
        return job["draws"][name][i]
    b = job["batch"]
    mode = CONFIGS[name][0]
    gen, host = torch.Generator().manual_seed(job["seed"] + 10 + i), np.random.default_rng(i)
    labeled = tuple(b["labeled_image"].shape)
    if mode == "ft":
        return sample_ft_draws(gen, hooks, host_rng=host, shape=labeled)
    shape = tuple(b["unlabeled_image"].shape)
    if mode == "pretrain":
        grids = sorted({h.grid for h in hooks if h.grid is not None})
        return sample_pretrain_draws(gen, shape[0], color_jitter=PRETRAIN_JITTER,
                                     point_grids=grids)
    return sample_step_draws(gen, shape[0], hooks, host_rng=host, shape=shape,
                             labeled_shape=labeled)


def build_config_step(bundle, hooks, name: str, group=None, unroll: int = 1):
    """Configuration ``name``'s step over ``group``: the pretrain step, or
    ``build_train_step`` in its mode (multicore with its criterion, the
    prototype probabilities summed to the 4 classes); ``unroll`` > 1:
    ``build_unrolled_train_step`` of that many steps a call."""
    mode, _, _, opts = CONFIGS[name]
    if mode == "pretrain":
        return build_pretrain_step(bundle, hooks, until=feature_until_from_hooks(*hooks),
                                   data_group=group)
    kw = {}
    if "multiplier" in opts:
        criterion = MultiCoreKL(prototype_groups(4, opts["multiplier"]))
        kw = dict(sup_criterion=criterion, prob_transform=criterion.reduced_simplex,
                  target_num_classes=4)
    if unroll > 1:
        return build_unrolled_train_step(bundle, hooks, unroll=unroll, mode=mode,
                                         data_group=group, **kw)
    return build_train_step(bundle, hooks, mode=mode, data_group=group, **kw)


def _recording(hook, seen: dict):
    """Keep the draws ``hook`` reads and the images of any student forward
    it runs (ICT's mixed batch) in ``seen``, at the first step."""
    loss = hook.loss

    def recording(ctx, state):
        if seen:
            return loss(ctx, state)
        seen["draw"] = ctx.hook_draws.get(hook.name)
        bundle = ctx.bundle

        def apply_train(x, **kw):
            seen["student_input"] = x.detach().clone()
            return bundle.apply_train(x, **kw)

        ctx.bundle = types.SimpleNamespace(model=bundle.model, apply_train=apply_train)
        try:
            return loss(ctx, state)
        finally:
            ctx.bundle = bundle

    hook.loss = recording


def _tensors(tree, prefix=""):
    """The tensors of a nest of dicts, keyed by path; ints as 0-d tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().clone()}
    return {prefix[:-1]: torch.tensor(tree)}


def reorder_rows(tree, order: torch.Tensor):
    """Every tensor of ``tree`` whose first axis is the batch's rows (of
    ``len(order)``) taken in ``order``: the same global batch and per-row
    draws, summed in another order (hook draws of other axes, as MixUp's
    permutation, are not reordered: a configuration with them has no
    reordered run)."""
    def take(x):
        return x[order] if x.dim() and x.shape[0] == len(order) else x

    return _map(take, tree)


def run_hook_steps(job: dict, name: str, group=None) -> dict:
    """``job.get('steps', 2)`` steps of configuration ``name`` on the job's
    global batch and draws (this rank's rows of both): the metrics of each
    step, the gradients of the first (before its update), and after the
    last the parameters, BN statistics, hook states (the teachers) and what
    UAMT, ICT and MixUp saw at the first step. ``job['unroll']`` = K > 1:
    K steps a call (``build_unrolled_train_step``) on the batch stacked K
    times, each step's metrics unstacked; no gradients kept."""
    mode, epoch, _, _ = CONFIGS[name]
    bundle, hooks, state = build_hook_state(job, name)
    for module in (state.model, *hooks):
        if isinstance(module, torch.nn.Module):
            replicate(module, group)
    seen: dict = {}
    for h in hooks:
        if isinstance(h, (UAMeanTeacherTrainerHook, ICTMeanTeacherTrainerHook, MixUpTrainHook)):
            _recording(h, seen)
    batch = job["batch"]
    if mode == "ft":
        batch = {k: batch[k] for k in ("labeled_image", "labeled_target")}
    elif mode == "pretrain":
        batch = pretrain_batch(batch)
    order = job.get("order")
    if order is not None:
        batch = reorder_rows(batch, order)
    unroll = job.get("unroll", 1)
    step = build_config_step(bundle, hooks, name, group, unroll)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    named = {id(p): k for k, p in state.model.named_parameters()}
    named.update({id(p): f"{h.name}/{k}" for h in hooks if isinstance(h, torch.nn.Module)
                  for k, p in h.named_parameters()})
    names = [named[id(p)] for p in params]
    out = {"metrics": []}
    draws = []
    for i in range(job.get("steps", 2)):
        d = global_draws(job, name, hooks, i)
        if order is not None:
            d = reorder_rows(d, order)
        draws.append(shard_batch(d, group) if mode == "pretrain"
                     else shard_step_draws(d, hooks, group))
    batch = shard_batch(batch, group)
    for i in range(0, len(draws), unroll):
        if unroll == 1:
            m = step(state, batch, draws[i], epoch)
            out["metrics"].append({k: v.detach().clone() for k, v in m.items()})
        else:
            m = step(state, stack_batches([batch] * unroll), draws[i:i + unroll], epoch)
            out["metrics"] += [{k: v[j].detach().clone() for k, v in m.items()}
                               for j in range(unroll)]
        if i == 0 and unroll == 1:
            out["grads"] = {k: p.grad.clone() for k, p in zip(names, params)}
    out["params"] = {k: p.detach().clone() for k, p in zip(names, params)}
    out["buffers"] = {k: b.clone() for k, b in state.model.named_buffers()}
    out["hook_states"] = _tensors(state.hook_states)
    out["seen"] = seen
    return out


def run_cached_unroll(job: dict, group=None) -> dict:
    """One call of ``job['unroll']`` device-cached ``consistency`` steps on
    the job's caches (``job['cache']``, numpy arrays and ids) at
    ``job['per_rank']`` slices a rank and batch, replaying the job's draws
    of the global batches (``job['cached_draws']``): the metrics of each
    step, the parameters and BN statistics after."""
    bundle, hooks, state = build_hook_state(job, "consistency")
    replicate(state.model, group)
    caches = [DeviceDataCache.from_arrays(**c, device="cpu") for c in job["cache"]]
    step = build_cached_train_step(bundle, hooks, labeled_cache=caches[0],
                                   unlabeled_cache=caches[1], labeled_batch=job["per_rank"],
                                   unlabeled_batch=job["per_rank"], data_group=group,
                                   unroll=job["unroll"])
    m = step.run(state, job["cached_draws"])
    return {"metrics": [{k: v[j].detach().clone() for k, v in m.items()}
                        for j in range(job["unroll"])],
            "params": {k: p.detach().clone() for k, p in state.model.named_parameters()},
            "buffers": {k: b.clone() for k, b in state.model.named_buffers()}}


def hooks_worker(group, job_path: str, out_dir: str) -> None:
    """Every configuration of the job on this rank, in turn; with the job's
    ``hv`` also the Hessian-vector products of :func:`collective_hvp` and
    :func:`dmt_hessian_term`; with its ``cached_draws`` the device-cached
    call of :func:`run_cached_unroll`."""
    job = torch.load(job_path, weights_only=False)     # the job's draws are named tuples
    out = {name: run_hook_steps(job, name, group) for name in job["configs"]}
    if "cached_draws" in job:
        out["cached"] = run_cached_unroll(job, group)
    if "hv" in job:
        out["hv"] = {case: collective_hvp(job["hv"], case, group) for case in HVP_CASES}
        out["hv"]["dmt"] = dmt_hessian_term(job, group)
    if "pretrain_run" in job:
        out["pretrain_run"] = pretrain_run_steps(job["pretrain_run"], group)
    torch.save(out, Path(out_dir) / f"rank{group.rank}.pt")


def pretrain_run_steps(argv: list, group=None, steps: int = 2) -> dict:
    """``steps`` steps of ``main.build_pretrain_run`` from the overrides
    ``argv`` at a small size (crop 32, max_channel 32, f32), over ``group``:
    the metrics, the batch size and the parameters after them."""
    from contrastyou_tpu_torch.main import build_pretrain_run, parse_config

    run = build_pretrain_run(parse_config(["-o", *argv]), device="cpu", dtype=torch.float32,
                             raw_size=40, crop=32, max_channel=32, data_group=group)
    metrics = run.run(steps)
    return {"metrics": [{k: v.detach().clone() for k, v in m.items()} for m in metrics],
            "batch_slices": run.batch_slices,
            "params": {k: p.detach().clone() for k, p in run.state.model.named_parameters()}}


# --- second order through the collectives ------------------------------------------

#: the losses whose Hessian-vector product :func:`collective_hvp` takes: a
#: BatchNorm over the active group's global sums, and a loss of the rows
#: gathered from every rank
HVP_CASES = ("batchnorm", "gathered")


def hvp_inputs(seed: int = 0, n: int = 8, size: int = 4, c_in: int = 3, c: int = 5) -> dict:
    """f64 inputs of :func:`collective_hvp`: the global rows ``x`` [n, size,
    size, c_in], a 1x1 conv ``w``, the BatchNorm's scale and bias, a target
    ``t`` and the direction ``v`` of each parameter."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, dtype=torch.float64) * scale

    params = [r(c_in, c), 1.0 + r(c, scale=0.1), r(c, scale=0.1)]
    return {"x": r(n, size, size, c_in), "t": r(n, size, size, c), "params": params,
            "v": [r(*p.shape) for p in params]}


def _hvp_loss(case: str, x, t, w, scale, bias, group):
    """``batchnorm``: the mean of tanh(BN(x w)) * t over this rank's rows,
    the BatchNorm's sums over the group; ``gathered``: the logsumexp
    contrast of the pooled features tanh(x w) of every rank's rows, a value
    of the global batch."""
    p = x @ w
    if case == "batchnorm":
        # the port's BatchNorm math on these leaves (no running update)
        bn = types.SimpleNamespace(weight=scale, bias=bias, eps=1e-5)
        with data_parallel(group):
            a, b = BatchNorm.affine(bn, p, p.sum((1, 2)), (p * p).sum((1, 2)), train=True,
                                    update=False)
        return (torch.tanh(a * p + b) * t).mean()
    f = torch.tanh(p).mean((1, 2)) * scale + bias
    if group is not None:
        f = gather_rows(f, group)
    return torch.logsumexp(f @ f.T, 1).mean()


def collective_hvp(inputs: dict, case: str, group=None) -> list:
    """H v of the global loss of ``case`` (:func:`_hvp_loss`) in its three
    parameters, on this rank's rows of the global ``x`` and ``t``: the
    gradient of each rank's share with ``create_graph``, summed over the
    ranks through the differentiable all-reduce, then the gradient of its
    product with ``v`` (each rank's share, summed), as DMT ``second_order``
    takes it. Without a group, one process on the whole batch."""
    params = [p.clone().requires_grad_() for p in inputs["params"]]
    x, t = shard_batch((inputs["x"], inputs["t"]), group)
    loss = _hvp_loss(case, x, t, *params, group)
    g = sum_over_ranks(torch.autograd.grad(loss / num_ranks(group), params, create_graph=True),
                       group)
    gv = sum((gi * vi).sum() for gi, vi in zip(g, inputs["v"]))
    hv = torch.autograd.grad(gv / num_ranks(group), params)
    return [h.detach() for h in sum_over_ranks(hv, group)]


def dmt_hessian_term(job: dict, group=None) -> dict:
    """The gradient of DMT ``second_order``'s meta loss at its virtual
    teacher in the student's parameters, and its Hessian-vector part: the
    whole gradient less the direct one, ``(1 - alpha)`` times the
    gradient in the virtual teacher (the teacher's virtual step
    differentiated back through the inner gradient). The first step's
    draws of ``dmt_second_order`` on the job's batch, this rank's rows."""
    name = "dmt_second_order"
    bundle, hooks, state = build_hook_state(job, name)
    replicate(state.model, group)
    hook = hooks[0]
    draws = shard_step_draws(global_draws(job, name, hooks, 0), hooks, group)
    b = shard_batch(job["batch"], group)
    ctx = StepContext(labeled_image=b["labeled_image"], labeled_target=b["labeled_target"],
                      unlabeled_image=b["unlabeled_image"],
                      unlabeled_image_tf=transform_image(b["unlabeled_image"], draws.geo,
                                                         draws.gammas),
                      geo_params=draws.geo, bundle=bundle, data_group=group,
                      labeled_logits=torch.zeros(*b["labeled_target"].shape, 4))
    params = list(state.model.parameters())
    with data_parallel(group):
        t1 = hook.virtual_teacher(ctx, state.hook_states[hook.name])
        meta = hook._meta_loss(ctx, t1, state.hook_states[hook.name]["teacher_batch_stats"],
                               train=True)
        grads = torch.autograd.grad(meta / num_ranks(group), params + list(t1.values()))
        whole, direct = (sum_over_ranks(part, group)
                         for part in (grads[:len(params)], grads[len(params):]))
    a = DMT_SO_HOOK["alpha"]
    names = [k for k, _ in state.model.named_parameters()]
    return {"whole": dict(zip(names, (w.detach() for w in whole))),
            "hessian": {k: (w - (1.0 - a) * d).detach()
                        for k, w, d in zip(names, whole, direct)}}


def slice_digests(trainer) -> dict:
    """Digests of the student's parameters and of the hook's state (the
    teacher's or the EMA's parameters and statistics)."""
    state = trainer._state.hook_states[trainer._active_hooks[0].name]
    return {"params": digest(trainer._model.parameters()),
            "hook": digest(v for k, v in sorted(_tensors(state).items())
                           if k != "ema_step"),
            "ema_step": int(state["ema_step"])}


def slice_loop_worker(group, spec: dict, out_dir: str) -> None:
    """``mt`` and ``ft`` for two epochs each on this rank, into a save_dir
    of its own."""
    out, r = Path(out_dir), group.rank
    result = {}
    for kind in ("mt", "ft"):
        trainer = semi_trainer(spec, str(out / f"{kind}_r{r}"), per_rank=spec["per_rank"],
                               device_cache=True, max_epoch=2, group=group, kind=kind)
        trainer.start_training()
        result[kind] = slice_digests(trainer)
    torch.save(result, out / f"slice_rank{r}.pt")



# --- chunked evaluation and K steps a call on ranks ----------------------------------

def count_collectives() -> dict:
    """Count this process's ``torch.distributed`` all-reduces and
    all-gathers (the port's collectives call them through the module) in
    the returned dict, by kind."""
    counts = {"all_reduce": 0, "all_gather": 0}
    for kind in counts:
        fn = getattr(dist, kind)

        def counted(*args, _fn=fn, _kind=kind, **kwargs):
            counts[_kind] += 1
            return _fn(*args, **kwargs)

        setattr(dist, kind, counted)
    return counts


def eval_trainer(job: dict, save_dir: str, group=None):
    """The ``semi`` trainer of :func:`semi_trainer` on the job's layout with
    the job's weights, evaluating ``job['chunk']`` batches a call."""
    trainer = semi_trainer(job["spec"], save_dir, per_rank=2, device_cache=False, max_epoch=1,
                           group=group)
    trainer._model.load_state_dict(job["model"])
    trainer.EVAL_CHUNK = job["chunk"]
    return trainer


def eval_worker(group, job_path: str, out_dir: str) -> None:
    """Each of the job's passes (name -> eval batches) through
    ``Trainer.eval_epoch`` on this rank: the statistics and the collectives
    it ran."""
    job = torch.load(job_path, weights_only=False)
    trainer = eval_trainer(job, str(Path(out_dir) / f"eval_r{group.rank}"), group)
    counts = count_collectives()
    out = {}
    for name, batches in job["passes"].items():
        counts.update(dict.fromkeys(counts, 0))
        stats, _ = trainer.eval_epoch(batches, 0, name)
        out[name] = {"stats": stats, "collectives": dict(counts)}
    torch.save(out, Path(out_dir) / f"eval_rank{group.rank}.pt")


#: the trainers that take K steps a call on W > 1 ranks, as the overrides of
#: ``main.build_semi_run`` (its device-cached step); ``semi_host`` is
#: ``semi`` fed host batches (``build_unrolled_train_step``)
UNROLL_KINDS = {"semi": ["Trainer.name=semi"], "semi_host": ["Trainer.name=semi"],
                "ft": ["Trainer.name=ft", "+EvalEMAParameters.alpha=0.99"],
                "mt": ["Trainer.name=mt"], "mixup": ["Trainer.name=mixup"],
                "multicore": ["Trainer.name=multicore", "+IIDSegParameters.weight=0.01"],
                "dmt": ["Trainer.name=dmt"]}
#: the small size of the K-steps runs
UNROLL_SMALL = dict(device="cpu", dtype=torch.float32, raw_size=40, crop=32, n_slices=8,
                    max_channel=32)


def host_batches(steps: int, rows: int, size: int, seed: int) -> list:
    """``steps`` host-fed ``semi`` batches of ``rows`` slices (numpy arrays
    of fresh, canonical strides) from a seeded generator."""
    rng = np.random.default_rng(seed)
    return [{"labeled_image": rng.random((rows, size, size, 1), np.float32),
             "labeled_target": rng.integers(0, 4, (rows, size, size)),
             "unlabeled_image": rng.random((rows, size, size, 1), np.float32)}
            for _ in range(steps)]


def run_unroll(kind: str, unroll: int, group=None, *, per_rank: int = 2, steps: int = 4,
               host: list = None) -> dict:
    """``steps`` train steps of ``kind`` at ``per_rank`` slices a rank and
    batch (the global batch with one process), ``unroll`` a call, over
    ``group``: each step's total loss and every state tensor after them
    (the model's, the optimizer's, the hooks'). ``host``: the host batches
    of each step (this rank's rows), for ``semi_host``."""
    from contrastyou_tpu_torch.engine.steps import build_unrolled_train_step, stack_batches
    from contrastyou_tpu_torch.main import build_semi_run, parse_config
    cfg = parse_config(["-o", *UNROLL_KINDS[kind], f"Trainer.unroll_steps={unroll}",
                        f"LabeledLoader.batch_size={per_rank}",
                        f"UnlabeledLoader.batch_size={per_rank}"])
    run = build_semi_run(cfg, data_group=group, **UNROLL_SMALL)
    if host is None:
        calls = [run.step(run.state, run.generator, 0, run.host_rng)
                 for _ in range(steps // unroll)]
    else:
        bundle = ModelBundle(run.state.model, (UNROLL_SMALL["crop"],) * 2 + (1,))
        step = (build_train_step(bundle, run.hooks, data_group=group) if unroll == 1 else
                build_unrolled_train_step(bundle, run.hooks, unroll=unroll, data_group=group))
        W = num_ranks(group)
        batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
        draws = []
        for b in batches:
            shape = (b["unlabeled_image"].shape[0] * W, *b["unlabeled_image"].shape[1:])
            draws.append(shard_step_draws(sample_step_draws(
                run.generator, shape[0], run.hooks, host_rng=run.host_rng, shape=shape,
                labeled_shape=shape), run.hooks, group))
        calls = [step(run.state, batches[i], draws[i]) if unroll == 1 else
                 step(run.state, stack_batches(batches[i:i + unroll]), draws[i:i + unroll])
                 for i in range(0, steps, unroll)]
    state = {f"model/{k}": v.clone() for k, v in run.state.model.state_dict().items()}
    for i, st in enumerate(run.state.optimizer.state.values()):
        state.update({f"opt{i}/{k}": v.clone() for k, v in st.items()})
    state.update({f"hooks/{k}": v for k, v in _tensors(run.state.hook_states).items()})
    graph = getattr(run.step, "graph", None)
    return {"losses": torch.cat([m["total_loss"].reshape(-1) for m in calls]), "state": state,
            "step": run.state.step, "replays": 0 if graph is None else graph.replays}


def unroll_worker(group, spec: dict, out_dir: str) -> None:
    """Each of ``spec['kinds']`` at K = 1 and K = ``spec['unroll']`` on this
    rank; then, with ``spec['main']``, ``main.run_experiment`` on the
    layout at each K, into save dirs of its own (rank 0's files are read)."""
    import contrastyou_tpu_torch as package
    from contrastyou_tpu_torch import main as port_main
    package.DATA_PATH = spec.get("data", package.DATA_PATH)
    out = {}
    for kind in spec["kinds"]:
        host = (host_batches(spec["steps"], 2, UNROLL_SMALL["crop"], 100 + group.rank)
                if kind == "semi_host" else None)
        out[kind] = {K: run_unroll(kind, K, group, steps=spec["steps"], host=host)
                     for K in (1, spec["unroll"])}
    for K in (1, spec["unroll"]) if spec.get("main") else ():
        cfg = port_main.parse_config(["-o", *spec["main"], f"Trainer.unroll_steps={K}",
                                      f"Trainer.save_dir={out_dir}/main_k{K}_r{group.rank}"])
        port_main.run_experiment(cfg, device=torch.device("cpu"), dtype=torch.float32,
                                 data_group=group)
    torch.save(out, Path(out_dir) / f"unroll_rank{group.rank}.pt")
