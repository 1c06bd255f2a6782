"""Helpers of the data-parallel CPU tests of the PyTorch port
(tests/test_torch_parallel*.py): W gloo ranks on 127.0.0.1 through
``torch.multiprocessing.spawn``, and the rank workers. The spawned processes
import this module, so it imports neither jax nor the JAX package; jobs and
results go through ``torch.save`` files."""
from __future__ import annotations

import hashlib
import socket
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from contrastyou_tpu_torch.data.creator import (create_infinite_loader, create_val_loader,
                                                split_dataset)
from contrastyou_tpu_torch.data.datasets import data_zoo
from contrastyou_tpu_torch.augment.host import make_crop_transforms
from contrastyou_tpu_torch.data.device_cache import DeviceDataCache
from contrastyou_tpu_torch.engine.bundle import ModelBundle
from contrastyou_tpu_torch.engine.hooks import hook_parameters
from contrastyou_tpu_torch.engine.optim import create_optimizer
from contrastyou_tpu_torch.engine.steps import (StepDraws, build_cached_train_step,
                                                build_train_step, init_train_state)
from contrastyou_tpu_torch.hooks.consistency import ConsistencyTrainerHook
from contrastyou_tpu_torch.hooks.infonce import INFONCEHook
from contrastyou_tpu_torch.models.unet import UNet
from contrastyou_tpu_torch.ops.affine import GeoParams
from contrastyou_tpu_torch.parallel import init_distributed, replicate, shard_batch
from contrastyou_tpu_torch.trainers import SemiTrainer

#: the optimizer of the step tests (tests/test_torch_step.py's): RAdam, lr 1e-3
#: at the first step
OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5}
SCHED = {"multiplier": 300, "warmup_max": 10}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(worker, world: int, *args) -> None:
    """Run ``worker(group, *args)`` on ``world`` gloo ranks of CPU processes."""
    mp.spawn(_entry, args=(world, free_port(), worker, args), nprocs=world, join=True)


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
                 max_epoch: int, group=None) -> SemiTrainer:
    """A SemiTrainer on the synthetic layout of ``spec`` at the test's small
    size: the U-Net of ``max_channel`` (f32) with consistency and the
    encoder InfoNCE hook, loaders of ``per_rank`` slices a rank; host-fed,
    rank r reads its stride of the indices."""
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
    hooks = [ConsistencyTrainerHook(weight=1.0),
             INFONCEHook(name="nce", feature_name="Conv5", weight=0.5, contrast_on="partition",
                         in_dim=model.get_channel_dim("Conv5")).init_weights(gen)]
    trainer = SemiTrainer(model=model, labeled_loader=lab, unlabeled_loader=unlab,
                          val_loader=val, test_loader=test, save_dir=save_dir,
                          max_epoch=max_epoch, num_batches=spec["num_batches"], seed=0,
                          device_cache=device_cache, data_group=group,
                          config={"Optim": OPTIM, "Scheduler": SCHED})
    trainer.register_hooks(*hooks)
    trainer.init()
    return trainer


def params_digest(module: torch.nn.Module) -> str:
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


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


def one_process_run(spec: dict, save_dir: str) -> SemiTrainer:
    """The device-cached run of :func:`loop_worker` in one process at the
    global batch, for two epochs unbroken."""
    torch.set_num_threads(1)
    trainer = semi_trainer(spec, save_dir, per_rank=spec["per_rank"] * spec["world"],
                           device_cache=True, max_epoch=2)
    trainer.start_training()
    return trainer
