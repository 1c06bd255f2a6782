"""Entry point of the PyTorch port: a ``semi`` or ``ft`` experiment, or
contrastive pretraining, on one device.

    python -m contrastyou_tpu_torch.main -o Trainer.name=semi Trainer.max_epoch=2 \\
        Trainer.num_batches=10 Trainer.save_dir=<run>
    python -m contrastyou_tpu_torch.main -p config/base.yaml config/hooks/udaiic.yaml \\
        -o Trainer.name=semi
    python -m contrastyou_tpu_torch.main -p config/base.yaml config/pretrain.yaml \\
        config/hooks/infonce.yaml -o Trainer.save_dir=<pretrain>
    python -m contrastyou_tpu_torch.main -o Trainer.name=ft \\
        Arch.checkpoint=<RUN_PATH>/<pretrain>/last Trainer.save_dir=<ft>
    python -m contrastyou_tpu_torch.main -o Trainer.name=mt Trainer.save_dir=<mt>
    python -m contrastyou_tpu_torch.main -o Trainer.name=mixup Trainer.save_dir=<mixup>
    python -m contrastyou_tpu_torch.main -o Trainer.name=dmt \
        DifferentiableMeanTeacherParameters.method_name=second_order Trainer.save_dir=<dmt>
    python -m contrastyou_tpu_torch.main -o Trainer.name=multicore Trainer.save_dir=<mc>
    python -m contrastyou_tpu_torch.main -o Trainer.name=adv Trainer.save_dir=<adv>
    python -m contrastyou_tpu_torch.main -o Trainer.name=semi Arch.name=resunet \
        Optim.name=adamw +Scheduler.name=poly Trainer.accumulate_iter=2 Trainer.save_dir=<res>
    python -m contrastyou_tpu_torch.main -p config/base.yaml config/hooks/ccblocks2.yaml \
        -o Trainer.name=semi Trainer.save_dir=<ccblocks>
    python -m contrastyou_tpu_torch.main -o Trainer.name=pretrain ~InfonceParams \
        +SPInfonceParams.feature_names=Conv5 +SPInfonceParams.weights=1 \
        +SPInfonceParams.contrast_ons=partition Trainer.save_dir=<spinfonce>
    python -m contrastyou_tpu_torch.main -o Trainer.name=pretrain_decoder ~InfonceParams \
        +InfonceSuperPixelParams.feature_names=Up_conv2 \
        +InfonceSuperPixelParams.weights=1.0 +InfonceSuperPixelParams.spatial_size=16 \
        Data.name=acdc_superpixel Trainer.save_dir=<superpixel>

takes the argv of the root ``main.py``. Without ``-p`` the base is the
in-code equal of the YAML files for ``Trainer.name``: :data:`MAIN_PATH_CONFIG`
(``semi``), config/base.yaml alone (``ft``), :data:`MT_CONFIG` (``mt``:
config/hooks/mt.yaml's mean teacher), :data:`MIXUP_CONFIG` (``mixup``:
config/hooks/mixup.yaml), :data:`DMT_CONFIG`, :data:`MULTICORE_CONFIG` and
:data:`ADV_CONFIG` (``dmt``, ``multicore``, ``adv``: config/hooks' file of
that name), :data:`PRETRAIN_DECODER_CONFIG`
or :data:`PRETRAIN_ENCODER_CONFIG`, so no YAML installation is needed (:data:`UDAIIC_CONFIG` is the in-code
``semi`` + ``udaiic`` base; from the ``semi`` base the same run is
``-o Trainer.name=semi ~ConsistencyParameters`` plus the four
``+DiscreteMIConsistencyParams.*`` keys of config/hooks/udaiic.yaml; UAMT
and ICT are ``-o Trainer.name=mt ~MeanTeacherParameters`` plus the
``+UAMeanTeacherParameters.*`` or ``+ICTMeanTeacherParameters.*`` keys of
config/hooks/uamt.yaml or ict.yaml; entropy minimization, pseudo-labels,
prototype orthogonality and the DAE are ``-o Trainer.name=semi`` plus
``+EntropyMinParameters.weight=...``, ``+PsuedoLabelParams.weight=...``,
``+OrthogonalParameters.weight=...`` or ``+DAEParameters.weight=...``; the
cross-correlation block the ``+CrossCorrelationParameters.*`` keys of
config/hooks/ccblocks2.yaml or ccblocks_imsat.yaml, under ``semi`` or the
pretraining trainers). The
hooks come from the config's hook sections (``hooks/creator.py``; a section
without a port raises); ``mt`` evaluates and infers on the teacher,
``mixup`` trains on the labeled batch alone with the MixUp hook, and an
``EvalEMAParameters`` section adds an EMA of the student that ``semi`` and
``ft`` evaluate on. ``dmt`` evaluates and infers on the differentiable mean
teacher; ``multicore`` builds a model of ``MulticoreParameters.multiplier``
prototype channels a class (:func:`multicore_classes`) and sums them back
to the classes; ``adv`` trains a discriminator beside the segmenter and,
as JAX's trainer, runs no hooks and no inference.

Every trainer runs the root ``main.py``'s experiment (:func:`run_experiment`):
the dataset ``Data.name`` from ``$CONTRASTYOU_DATA_PATH`` (its on-disk
layout, e.g. the one ``data/synthetic.py`` writes), split into labeled,
unlabeled, validation and test scans; ``Trainer.max_epoch`` epochs of
``Trainer.num_batches`` steps written to ``storage.csv`` and TensorBoard
events (``tensorboard/``) with ``config.yaml``, the ``last`` checkpoint,
``.success`` and ``launches.json`` (the hand-written kernels' launch counts
of the process, train, evaluation and inference; its CUDA graphs' warm-ups,
captures, replays and capture seconds, ``graphs``; the trainer name; the
run's seconds and its ``timing`` records, as the trainer logs them) in
``Trainer.save_dir`` (under ``$CONTRASTYOU_RUN_PATH`` when relative). ``semi``
and ``ft`` (the labeled batch alone, no hook) follow each epoch with
validation and test over whole scans, keep ``best`` and end with inference
on it (``inference_result.json``; ``+Inference.tta=true`` averages the four
axis flips); ``-o Trainer.device_cache=true`` stages their train split on
the device. ``pretrain`` / ``pretrain_decoder`` train on contrastive
batches of half the train scans, host-fed, with neither validation nor
inference. A run resumes from ``trainer_checkpoint`` or else from
``<save_dir>/last``. Warm starts: ``Arch.pretrained_path`` (an npz archive
of flax-keyed paths, merged into the fresh model before ``init``) and
``Arch.checkpoint`` (a checkpoint directory whose model parameters, not its
BN statistics, replace the model's after ``init``); a missing one raises
before anything is built. The net is ``models.get_arch(Arch.name)`` with
every ``Arch`` key JAX's root ``main.py`` passes (``Arch.name=resunet``,
``+Arch.norm=groupnorm``; a key the net has no field for raises, so
``Arch.name=unet2`` does, as in JAX). Keys the port does not implement
(:data:`UNPORTED_KEYS`, none left) raise when set;
``Trainer.unroll_steps=K`` runs K steps a call (one CUDA graph a call on the
card; ``engine/graph.py``) under every trainer but ``adv`` and pretraining,
which refuse it as JAX's run one step a call; ``+Trainer.profile=true`` traces epoch index 1 into
``<save_dir>/profile`` (``engine/trainer.py``). Every trainer takes the class count
of ``Data.name``; pretraining also its partition count and contrastive
sampler. Every ``Data.name`` reads from disk, the resize datasets
(prostate, prostate_md, spleen) included. The self-paced
(``SPInfonceParams``, config/hooks/spinfonce.yaml) and superpixel
(``InfonceSuperPixelParams``, config/hooks/infonce_dense_superpixel.yaml,
on ``Data.name=acdc_superpixel``, whose ``superpixel`` maps
``postprocess/superpixel.py`` writes) InfoNCE hooks run under both
pretraining trainers and ``semi`` (host-fed: the device cache carries no
superpixel map). :func:`build_semi_run` and :func:`build_pretrain_run`
build the ``semi`` and pretraining steps on synthetic scans in memory, for
``profile_step`` and ``chip_smoke.py`` (``-o Data.name=prostate``: 8
partitions, 2 classes, random 48-slice batches, 96 images per forward).

The run is on the CUDA card; ``-o Trainer.device=cpu`` asks for the CPU.
Without a card and without that request it raises.
"""
from __future__ import annotations

import contextlib
import json
import logging
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch

import contrastyou_tpu_torch as package
from .configure.config import ConfigParser, merge, parse_value
from .data.creator import get_data
from .data.datasets import DatasetSpec, dataset_spec
from .data.device_cache import DeviceDataCache
from .data.sampler import partition_index
from .engine.bundle import ModelBundle
from .engine.checkpoint import extract_model_params, is_checkpoint, load_model_params
from .engine.hooks import hook_parameters
from .engine.optim import create_optimizer
from .engine.state import TrainState
from .engine.steps import build_cached_train_step, init_train_state, point_grids
from .engine.trainer import graph_stats, kernel_launches
from .hooks.creator import create_hook_from_config
from .loggers import setup_logging
from .models import get_arch
from .losses.multicore import MultiCoreKL
from .parallel.mesh import DataGroup, replicate, shard_batch
from .trainers import trainer_zoo
from .trainers.multicore import prototype_groups
from .trainers.pretrain import (build_pretrain_step, check_pretrain_hooks, contrastive_sampler,
                                feature_until_from_hooks, frozen_encoder,
                                get_contrastive_loader, jitter_strength,
                                pretrain_trainable, sample_pretrain_draws)
from .tracing import span
from .utils.torch_convert import load_pretrained

__all__ = ["MAIN_PATH_CONFIG", "UDAIIC_CONFIG", "MT_CONFIG", "MIXUP_CONFIG", "DMT_CONFIG",
           "MULTICORE_CONFIG", "ADV_CONFIG", "PRETRAIN_DECODER_CONFIG", "multicore_classes",
           "PRETRAIN_ENCODER_CONFIG", "UNPORTED_KEYS", "refuse_unported_keys",
           "check_warm_start", "resolve_device", "synthetic_split", "synthetic_scans",
           "SemiRun", "build_semi_run", "PretrainRun", "build_pretrain_run", "parse_config",
           "find_checkpoint", "run_experiment", "main"]

#: config/base.yaml
_BASE = {
    "RandomSeed": 10,
    "trainer_checkpoint": None,
    "Arch": {"name": "unet", "checkpoint": None, "max_channel": 512, "momentum": 0.01},
    "Optim": {"name": "RAdam", "lr": 1e-7, "weight_decay": 1e-5},
    "Scheduler": {"multiplier": 300, "warmup_max": 10},
    "Data": {"name": "acdc", "labeled_scan_num": 1, "order_num": 0},
    "LabeledLoader": {"shuffle": True, "batch_size": 5, "num_workers": 5},
    "UnlabeledLoader": {"shuffle": True, "batch_size": 5, "num_workers": 5},
    "Trainer": {"save_dir": "tmp", "num_batches": 200, "max_epoch": 75,
                "two_stage": True, "disable_bn": False, "name": None,
                "enable_scale": True, "accumulate_iter": 1},
}
#: config/pretrain.yaml
_PRETRAIN = {
    "Trainer": {"num_batches": 200, "max_epoch": 75},
    "Optim": {"name": "RAdam", "lr": 1e-7, "weight_decay": 0.0},
    "Scheduler": {"multiplier": 400, "warmup_max": 10},
    "ContrastiveLoaderParams": {"scan_sample_num": 6, "partition_sample_num": 1,
                                "num_workers": 8},
}

#: config/base.yaml merged with config/hooks/consistency.yaml
MAIN_PATH_CONFIG = merge(_BASE, {"ConsistencyParameters": {"weight": 10}})
#: config/base.yaml merged with config/hooks/udaiic.yaml (``Trainer.name`` stays
#: null, i.e. ``semi``): IIC on Conv5 and, with one pixel of displacement, on
#: Up_conv2, plus consistency
UDAIIC_CONFIG = merge(_BASE, {"DiscreteMIConsistencyParams": {
    "feature_names": ["Conv5", "Up_conv2"], "mi_weights": [0.1, 0.05],
    "dense_paddings": [1], "consistency_weight": 1}})
#: config/base.yaml merged with config/hooks/mt.yaml (``Trainer.name`` stays
#: null; ``-o Trainer.name=mt`` picks this base): the mean teacher, no
#: consistency hook
MT_CONFIG = merge(_BASE, {"MeanTeacherParameters": {
    "weight": 10, "alpha": 0.99, "weight_decay": 0.000001, "update_bn": False,
    "num_teachers": 1, "hard_clip": False}})
#: config/base.yaml merged with config/hooks/mixup.yaml (``Trainer.name``
#: mixup): labeled steps with the MixUp hook
MIXUP_CONFIG = merge(_BASE, {"Trainer": {"name": "mixup"},
                             "MixUpParams": {"weight": 0.1, "enable_bn": True}})
#: config/base.yaml merged with config/hooks/dmt.yaml: the differentiable mean
#: teacher (``method1``)
DMT_CONFIG = merge(_BASE, {"Trainer": {"name": "dmt"},
                           "DifferentiableMeanTeacherParameters": {
                               "weight": 10, "alpha": 0.99, "weight_decay": 0.000001,
                               "meta_weight": 0.001, "meta_criterion": "ce",
                               "method_name": "method1"}})
#: config/base.yaml merged with config/hooks/multicore.yaml (``Trainer.name``
#: stays null; ``-o Trainer.name=multicore`` picks this base): 8 prototypes a
#: class, no hook
MULTICORE_CONFIG = merge(_BASE, {"MulticoreParameters": {"multiplier": 8, "name": "naive",
                                                         "mi_weight": 0.001}})
#: config/base.yaml merged with config/hooks/adv.yaml: the adversarial trainer
ADV_CONFIG = merge(_BASE, {"Trainer": {"name": "adv", "reg_weight": 0.01}})
#: config/base.yaml + config/pretrain.yaml + config/hooks/infonce.yaml
PRETRAIN_DECODER_CONFIG = merge(merge(_BASE, _PRETRAIN), {
    "InfonceParams": {"feature_names": ["Conv5", "Up_conv2"], "weights": [1.0, 1.0],
                      "contrast_ons": ["partition", "self"], "spatial_size": [1, 16]},
    "Trainer": {"name": "pretrain_decoder"}})
#: config/base.yaml + config/pretrain.yaml + config/hooks/infonce_encoder.yaml
PRETRAIN_ENCODER_CONFIG = merge(merge(_BASE, _PRETRAIN), {
    "InfonceParams": {"feature_names": "Conv5", "weights": 1.0,
                      "contrast_ons": "partition", "spatial_size": 1},
    "Trainer": {"name": "pretrain"}})

_DEFAULTS = {None: MAIN_PATH_CONFIG, "semi": MAIN_PATH_CONFIG, "ft": _BASE, "mt": MT_CONFIG,
             "mixup": MIXUP_CONFIG, "dmt": DMT_CONFIG, "multicore": MULTICORE_CONFIG,
             "adv": ADV_CONFIG, "pretrain": PRETRAIN_ENCODER_CONFIG,
             "pretrain_decoder": PRETRAIN_DECODER_CONFIG}
PRETRAIN_TRAINERS = ("pretrain", "pretrain_decoder")

#: the class count of ACDC (the synthetic split's default) and the reference
#: crop of the slices
NUM_CLASSES = 4
CROP = 224


def resolve_device(requested: Optional[str] = None) -> torch.device:
    """The CUDA card unless ``requested`` names another device; raises when
    the card is asked for (explicitly or by default) and there is none."""
    device = torch.device(requested or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a machine with a card, or ask "
                           "for the CPU with -o Trainer.device=cpu")
    return device


def synthetic_split(n_slices: int, size: int, *, num_classes: int = NUM_CLASSES,
                    seed: int = 0):
    """[n, size, size] f32 images in [0, 1] and int targets: nested ellipses
    (one per class) over a noisy background, drifting from slice to slice —
    the same structure as the JAX package's synthetic ACDC scans."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.empty((n_slices, size, size), np.float32)
    targets = np.zeros((n_slices, size, size), np.int64)
    for s in range(n_slices):
        cy, cx = rng.uniform(0.35, 0.65, 2) * size
        r = rng.uniform(0.18, 0.28) * size
        dist = np.hypot(yy - cy, xx - cx)
        for c in range(1, num_classes):
            targets[s][dist < r * (num_classes - c) / (num_classes - 1)] = c
        img = targets[s] / max(num_classes - 1, 1) * 0.6
        img = img + rng.normal(0, 0.05, img.shape) + 0.2 * np.sin(xx / size * 3.1)
        images[s] = np.clip(img, 0.0, 1.0)
    return images, targets


def synthetic_scans(n_scans: int, slices_per_scan: int, size: int, *,
                    spec: DatasetSpec = dataset_spec("acdc"), seed: int = 0) -> dict:
    """:func:`synthetic_split` slices (``spec.num_classes`` label values,
    remapped to the trained classes by ``spec.remap``) grouped into scans
    named by ``spec.scan_name`` (ACDC ``patient<p>_<cycle>``, two cycles per
    patient; prostate ``Case<p>``), with per-slice scan, partition
    (``spec.partition_num`` by the dataset's rule), patient and cycle ids."""
    images, targets = synthetic_split(n_scans * slices_per_scan, size,
                                      num_classes=spec.num_classes, seed=seed)
    targets = spec.remap(targets)
    scan = np.repeat(np.arange(n_scans), slices_per_scan)
    cur = np.tile(np.arange(slices_per_scan), n_scans)
    patient, cycle = scan // spec.cycles + 1, scan % spec.cycles
    return {"images": images, "targets": targets, "scan_id": scan,
            "partition": np.array([partition_index(int(c), slices_per_scan, spec.partition_num)
                                   for c in cur]),
            "patient": patient, "cycle": cycle,
            "scan_names": [spec.scan_name.format(patient=p, cycle=c) for p, c in
                           zip(patient[::slices_per_scan], cycle[::slices_per_scan])]}


#: config keys the port parses but does not implement, with the value that
#: means "not used": another value raises rather than train something else
#: (none left: ``Trainer.unroll_steps`` was the last)
UNPORTED_KEYS: dict = {}

#: why the pretraining runs and trainers take one step a call
PRETRAIN_UNROLL_REFUSAL = ("JAX's pretraining trainers build their own step and loop and run "
                           "one step a call whatever unroll_steps is "
                           "(contrastyou_tpu/trainers/pretrain.py)")


def refuse_unported_keys(config: Mapping) -> None:
    """Raise ``NotImplementedError`` naming the first key of
    :data:`UNPORTED_KEYS` whose value is not its default."""
    for path, default in UNPORTED_KEYS.items():
        node = config
        for k in path:
            node = node.get(k) if isinstance(node, Mapping) else None
        if node is not None and node != default:
            raise NotImplementedError(f"{'.'.join(path)}={node!r} is not ported yet "
                                      f"(only {default!r})")


def check_warm_start(config: Mapping) -> None:
    """Raise ``FileNotFoundError`` naming the path when ``Arch.checkpoint``
    is not a checkpoint directory or ``Arch.pretrained_path`` not a file."""
    arch = config.get("Arch", {})
    checkpoint, pretrained = arch.get("checkpoint"), arch.get("pretrained_path")
    if checkpoint and not is_checkpoint(checkpoint):
        raise FileNotFoundError(f"Arch.checkpoint={checkpoint}: no checkpoint there")
    if pretrained and not Path(pretrained).is_file():
        raise FileNotFoundError(f"Arch.pretrained_path={pretrained}: no such file")


def _warm_start(config: Mapping, model: torch.nn.Module) -> None:
    """The config's warm starts applied to ``model`` alone (the run builders
    make their optimizer after it)."""
    arch = config["Arch"]
    if arch.get("pretrained_path"):
        load_pretrained(model, arch["pretrained_path"])
    if arch.get("checkpoint"):
        load_model_params(model, extract_model_params(arch["checkpoint"], model))


#: ``input_dim`` of every opt/<name>.yaml
INPUT_DIM = 1
#: the ``Arch`` keys the entry point does not pass to the net (JAX root
#: main.py: ``name`` picks it, the others are warm starts and multicore's)
ARCH_KEYS_NOT_PASSED = ("name", "checkpoint", "pretrained_path", "true_num_classes")


def _model(config: Mapping, device, dtype, max_channel, generator,
           num_classes: int = NUM_CLASSES) -> torch.nn.Module:
    """``get_arch(Arch.name)`` with what JAX's root main.py passes:
    ``input_dim``, the class count, ``dtype`` and every other ``Arch`` key
    (``max_channel`` replaced when given). A key the net has no field for
    raises ``TypeError``: UNet2 is built by ``get_arch`` alone, as in JAX."""
    arch = {k: v for k, v in config["Arch"].items() if k not in ARCH_KEYS_NOT_PASSED}
    name = str(config["Arch"].get("name", "unet"))
    if max_channel:
        arch["max_channel"] = int(max_channel)
    try:
        model = get_arch(name, input_dim=INPUT_DIM, num_classes=num_classes, dtype=dtype,
                         **arch)
    except TypeError as e:
        raise TypeError(f"Arch.name={name}: {e}, which the entry point passes (input_dim, "
                        f"num_classes, dtype and every Arch key but "
                        f"{', '.join(ARCH_KEYS_NOT_PASSED)}), as JAX's root main.py does; "
                        f"build it with models.get_arch") from e
    return model.to(device).init_weights(generator)


def _hooks(config: Mapping, model: torch.nn.Module, device, dtype, generator, *,
           is_pretrain: bool, trainer=None):
    """The config's hooks on ``device``, their heads drawn from ``generator``
    in hook order (``trainer``: see ``create_hook_from_config``)."""
    hooks = create_hook_from_config(
        config, channel_dim=model.get_channel_dim, is_pretrain=is_pretrain,
        proj_bf16=dtype == torch.bfloat16 and torch.device(device).type == "cuda",
        trainer=trainer)
    for h in hooks:
        if isinstance(h, torch.nn.Module):
            h.to(device).init_weights(generator)
    return hooks


@dataclass
class SemiRun:
    state: TrainState
    #: step(state, generator, epoch, host_rng) -> metrics: one call of
    #: ``Trainer.unroll_steps`` steps (metrics stacked [K, ...] when K > 1)
    step: Callable
    generator: torch.Generator
    batch_slices: int               # slices per step (labeled + unlabeled)
    labeled_cache: DeviceDataCache
    unlabeled_cache: DeviceDataCache
    hooks: List
    host_rng: np.random.Generator   # the hooks' host-side draws

    def run(self, n: int):
        return [self.step(self.state, self.generator, 0, self.host_rng) for _ in range(n)]


def build_semi_run(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                   raw_size: int = 256, crop: int = CROP, n_slices: int = 40,
                   max_channel: Optional[int] = None,
                   data_group: Optional[DataGroup] = None) -> SemiRun:
    """Model, hooks (their heads optimized beside the model), optimizer,
    device-resident synthetic split and the cached ``semi`` step from a
    reference-style config; the class count is ``Data.name``'s (its label
    remap applied to the targets). Weights and data are made from
    ``RandomSeed``. The hooks and the step's mode are the ``Trainer.name``
    trainer's (``Trainer.active_hooks``, ``train_mode``): ``ft`` builds the
    cached ``ft`` step on the labeled batch alone, with only the EMA eval
    model of the hooks; ``multicore`` its prototype model and criterion
    (:func:`multicore_classes`). With a ``data_group`` of W
    ranks the loaders' batch sizes are per rank: the step is the
    one-process step at W times them (``parallel/``), the weights broadcast
    from rank 0."""
    refuse_unported_keys(config)
    check_warm_start(config)
    seed = int(config.get("RandomSeed", 10))
    trainer = config["Trainer"]
    spec = dataset_spec(str(config["Data"]["name"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    name = trainer.get("name") or "semi"
    multicore = multicore_classes(config, spec.train_classes) if name == "multicore" else {}
    model = _model(config, device, dtype, max_channel, gen,
                   spec.train_classes * multicore.get("multiplier", 1))
    _warm_start(config, model)
    bundle = ModelBundle(model, (crop, crop, 1))
    hooks = _hooks(config, model, device, dtype, gen, is_pretrain=False)
    trainer_cls = trainer_zoo[name]
    hooks = trainer_cls.active_hooks(hooks)
    ft = trainer_cls.train_mode == "ft"
    optimizer, _ = create_optimizer(
        list(model.parameters()) + hook_parameters(hooks), config["Optim"],
        config.get("Scheduler"), max_epoch=int(trainer["max_epoch"]),
        steps_per_epoch=int(trainer["num_batches"]),
        accumulate_iter=int(trainer.get("accumulate_iter", 1)))
    state = init_train_state(bundle, hooks, optimizer)
    for module in (model, *hooks):
        if isinstance(module, torch.nn.Module):
            replicate(module, data_group)
    images, targets = synthetic_split(n_slices, raw_size, num_classes=spec.num_classes,
                                      seed=seed)
    targets = spec.remap(targets)
    half = n_slices // 2
    lab = DeviceDataCache.from_arrays(images[:half], targets[:half], crop=crop,
                                      device=device)
    unl = DeviceDataCache.from_arrays(images[half:], targets[half:], crop=crop,
                                      device=device)
    nl = int(config["LabeledLoader"]["batch_size"])
    nu = int(config["UnlabeledLoader"]["batch_size"])
    criterion = {}
    if multicore:
        mc = MultiCoreKL(prototype_groups(multicore["true_num_classes"], multicore["multiplier"]))
        criterion = dict(sup_criterion=mc, prob_transform=mc.reduced_simplex,
                         target_num_classes=multicore["true_num_classes"])
    step = build_cached_train_step(
        bundle, hooks, labeled_cache=lab, unlabeled_cache=None if ft else unl,
        labeled_batch=nl, unlabeled_batch=nu, data_group=data_group,
        unroll=int(trainer.get("unroll_steps", 1)),
        disable_bn=bool(trainer.get("disable_bn", False)),
        two_stage=bool(trainer.get("two_stage", True)), **criterion)
    return SemiRun(state, step, gen, nl if ft else nl + nu, lab, unl, hooks,
                   np.random.default_rng(seed))


@dataclass
class PretrainRun:
    state: TrainState
    step: Callable                  # step(state, generator) -> metrics
    generator: torch.Generator
    batch_slices: int               # slices of one contrastive batch (one view)
    cache: DeviceDataCache
    hooks: List
    until: str                      # the forward is cut here; later layers are frozen

    def run(self, n: int):
        return [self.step(self.state, self.generator) for _ in range(n)]


def build_pretrain_run(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                       raw_size: int = 256, crop: int = CROP, n_scans: int = 12,
                       slices_per_scan: Optional[int] = None,
                       max_channel: Optional[int] = None,
                       data_group: Optional[DataGroup] = None) -> PretrainRun:
    """``pretrain`` / ``pretrain_decoder``: model, InfoNCE and
    cross-correlation hooks with their heads, RAdam over the layers up to
    the deepest tap (without the encoder when
    ``CrossCorrelationParameters.train_encoder`` is false) plus the heads,
    synthetic scans of ``Data.name``'s layout resident on the device, its
    contrastive batch sampler and the pretrain step. Weights and data are
    made from ``RandomSeed``. ``slices_per_scan`` defaults to 10 for
    datasets of 3 partitions and to 8 per partition above (64 for prostate),
    enough for the ``cur // (cut + 1)`` rule to fill every partition. With a
    ``data_group`` of W ranks every rank samples the one-process batch and
    its draws and keeps its 1/W of the rows (``build_pretrain_step(
    data_group=)``), the weights broadcast from rank 0; ``batch_slices``
    stays the global batch's. ``Trainer.unroll_steps`` above 1 raises
    (:data:`PRETRAIN_UNROLL_REFUSAL`)."""
    refuse_unported_keys(config)
    check_warm_start(config)
    seed = int(config.get("RandomSeed", 10))
    trainer = config["Trainer"]
    if int(trainer.get("unroll_steps", 1)) != 1:
        raise NotImplementedError(f"Trainer.unroll_steps={trainer['unroll_steps']!r} under "
                                  f"pretraining: {PRETRAIN_UNROLL_REFUSAL}")
    data_name = str(config["Data"]["name"])
    spec = dataset_spec(data_name)
    if slices_per_scan is None:
        slices_per_scan = 10 if spec.partition_num <= 3 else 8 * spec.partition_num
    gen = torch.Generator(device=device).manual_seed(seed)
    model = _model(config, device, dtype, max_channel, gen, spec.train_classes)
    _warm_start(config, model)
    bundle = ModelBundle(model, (crop, crop, 1))
    hooks = _hooks(config, model, device, dtype, gen, is_pretrain=True)
    check_pretrain_hooks(hooks)
    until = feature_until_from_hooks(*hooks)
    trainable = pretrain_trainable(until, frozen_encoder(config))
    params = [p for name, p in model.named_parameters() if trainable(name)]
    optimizer, _ = create_optimizer(
        params + hook_parameters(hooks), config["Optim"], config.get("Scheduler"),
        max_epoch=int(trainer["max_epoch"]), steps_per_epoch=int(trainer["num_batches"]),
        accumulate_iter=int(trainer.get("accumulate_iter", 1)))
    state = init_train_state(bundle, hooks, optimizer)
    for module in (model, *hooks):
        if isinstance(module, torch.nn.Module):
            replicate(module, data_group)

    scans = synthetic_scans(n_scans, slices_per_scan, raw_size, spec=spec, seed=seed)
    cache = DeviceDataCache.from_arrays(
        scans["images"], scans["targets"], crop=crop, device=device,
        scan_id=scans["scan_id"], partition=scans["partition"],
        patient=scans["patient"], cycle=scans["cycle"], scan_names=scans["scan_names"])
    clp = config.get("ContrastiveLoaderParams", {})
    sampler, pad_to = contrastive_sampler(
        data_name, [scans["scan_names"][s] for s in scans["scan_id"]], scans["partition"],
        partition_num=spec.partition_num,
        scan_sample_num=int(clp.get("scan_sample_num", 6)),
        partition_sample_num=int(clp.get("partition_sample_num", 1)), seed=seed)
    batches = iter(sampler)
    step = build_pretrain_step(bundle, hooks, until=until, data_group=data_group)
    grids = point_grids(hooks)
    strength = jitter_strength(data_name)

    def cached_step(state: TrainState, generator: torch.Generator, epoch: int = 0):
        with span("cy/data/sampler"):
            # a short batch is padded by repeating its last slice (data/loader.py collate)
            idx = next(batches)[:pad_to]
            idx = idx + idx[-1:] * (pad_to - len(idx))
        # a pageable copy: the host waits here for the card's earlier work
        with span("cy/data/index_copy"):
            idx = torch.tensor(idx, device=cache.device)
        with span("cy/data/draw"):
            batch = cache.sample_at(idx, *cache.draw_offsets(generator, pad_to))
            draws = sample_pretrain_draws(generator, pad_to, color_jitter=strength,
                                          point_grids=grids)
        return step(state, *shard_batch((batch, draws), data_group), epoch)

    return PretrainRun(state, cached_step, gen, pad_to, cache, hooks, until)


def parse_config(argv, base: Optional[Mapping] = None) -> dict:
    """Reference-style argv -> config; without ``-p`` the in-code ``base``,
    by default the one of the ``Trainer.name`` the overrides give."""
    named = [parse_value(tok.split("=", 1)[1]) for tok in argv
             if tok.lstrip("+").startswith("Trainer.name=")]
    if base is None:
        base = _DEFAULTS.get(named[-1] if named else None, MAIN_PATH_CONFIG)
    config = ConfigParser(base).parse(argv)
    name = config["Trainer"].get("name")
    if name not in _DEFAULTS:
        raise SystemExit(f"Trainer.name={name!r}: ported are "
                         f"{sorted(str(k) for k in _DEFAULTS if k)}")
    return config


def multicore_classes(config: Mapping, num_classes: int) -> dict:
    """The multicore trainer's ``true_num_classes`` and ``multiplier`` from
    ``MulticoreParameters`` (JAX root ``main.py``): the model predicts
    ``num_classes * multiplier`` prototype channels; a criterion other than
    ``naive`` raises, as upstream."""
    mc = config.get("MulticoreParameters", {})
    name = mc.get("name", "naive")
    if name != "naive":
        raise RuntimeError(f"MulticoreParameters.name={name!r} (only 'naive' is supported, "
                           f"as upstream)")
    return {"true_num_classes": num_classes, "multiplier": int(mc.get("multiplier", 2))}


def find_checkpoint(save_dir) -> Optional[str]:
    """``<save_dir>/last`` when it holds a checkpoint."""
    last = Path(save_dir) / "last"
    return str(last) if is_checkpoint(last) else None


class _TimingRecords(logging.Handler):
    """The ``timing`` dicts of the records the package logs (the trainers'
    host times by phase, ``engine/trainer.py``)."""

    def __init__(self):
        super().__init__()
        self.records: List[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        timing = getattr(record, "timing", None)
        if timing is not None:
            self.records.append(timing)


@contextlib.contextmanager
def _timing_records():
    """The package's ``timing`` records while the block runs, INFO enabled
    for them whatever the logging setup."""
    log = logging.getLogger(package.__name__)
    handler, level = _TimingRecords(), log.level
    log.addHandler(handler)
    if not log.isEnabledFor(logging.INFO):
        log.setLevel(logging.INFO)
    try:
        yield handler.records
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def run_experiment(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                   data_group: Optional[DataGroup] = None):
    """The experiment of ``config`` (see the module docstring) -> its
    trainer, after training and, but for pretraining, inference; on the
    ``data_group``'s W ranks when given (:func:`build_trainer`)."""
    t0 = time.perf_counter()
    with _timing_records() as timing:
        trainer, name, best = _run(config, device, dtype, data_group)
    if trainer.is_master:
        (Path(trainer.save_dir) / "launches.json").write_text(json.dumps(
            {"launches": kernel_launches(), "graphs": graph_stats(), "trainer": name,
             "seconds": time.perf_counter() - t0, "timing": timing}, indent=2))
    logging.getLogger(__name__).info("training finished, best score: %s", best)
    return trainer


def build_trainer(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                  data_group: Optional[DataGroup] = None):
    """The trainer :func:`run_experiment` runs: ``Trainer.name``'s on the
    config's data, its hooks registered, initialised, warm-started and
    resumed from ``trainer_checkpoint`` or ``<save_dir>/last``. With a
    ``data_group`` of W ranks the loaders' batch sizes are per rank and each
    rank reads its stride of the indices (``engine/trainer.py``); a trainer
    whose ``data_parallel`` is False refuses the group."""
    refuse_unported_keys(config)
    check_warm_start(config)
    seed = int(config.get("RandomSeed", 10))
    data = config["Data"]
    name = config["Trainer"].get("name") or "semi"
    logging.getLogger(__name__).info("run %s: Trainer.name=%s on %s",
                                     config["Trainer"].get("save_dir"), name, device)
    is_pretrain = name in PRETRAIN_TRAINERS
    stride = {} if data_group is None else dict(process_index=data_group.rank,
                                                process_count=data_group.size)
    labeled, unlabeled, val, test = get_data(
        data, {**config.get("LabeledLoader", {}), **stride},
        {**config.get("UnlabeledLoader", {}), **stride}, root_dir=package.DATA_PATH,
        pretrain=is_pretrain, order_num=int(data.get("order_num", 0)))
    num_classes = dataset_spec(str(data["name"])).train_classes
    multicore = multicore_classes(config, num_classes) if name == "multicore" else {}
    gen = torch.Generator(device=device).manual_seed(seed)
    model = _model(config, device, dtype, None, gen,
                   num_classes * multicore.get("multiplier", 1))
    kwargs = dict(model=model, labeled_loader=labeled, unlabeled_loader=unlabeled,
                  val_loader=val, test_loader=test, config=config, seed=seed,
                  data_group=data_group, **multicore,
                  **{k: v for k, v in config["Trainer"].items() if k not in ("name", "device")})
    if is_pretrain:
        clp = {k: v for k, v in config.get("ContrastiveLoaderParams", {}).items()
               if k != "num_workers"}
        kwargs.update(contrast_loader=get_contrastive_loader(
            labeled.dataset, data_name=str(data["name"]), seed=seed, **clp),
            val_loader=None, test_loader=None)
    trainer = trainer_zoo[name](**kwargs)
    trainer.register_hooks(*_hooks(config, model, device, dtype, gen, is_pretrain=is_pretrain,
                                   trainer=trainer))
    arch = config["Arch"]
    if arch.get("pretrained_path"):
        trainer.load_pretrained(arch["pretrained_path"])
    trainer.init()
    if arch.get("checkpoint"):
        trainer.load_model_params(extract_model_params(arch["checkpoint"], model))
    resume = config.get("trainer_checkpoint") or find_checkpoint(trainer.save_dir)
    if resume:
        trainer.resume_from_path(resume)
    return trainer


def _run(config: Mapping, device, dtype: torch.dtype, data_group: Optional[DataGroup] = None):
    trainer = build_trainer(config, device=device, dtype=dtype, data_group=data_group)
    name = config["Trainer"].get("name") or "semi"
    best = trainer.start_training()
    if trainer.runs_inference:
        best_ckpt = Path(trainer.save_dir) / "best"
        trainer.inference(checkpoint=str(best_ckpt) if best_ckpt.exists() else None)
    return trainer, name, best


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    setup_logging()
    config = parse_config(argv)
    run_experiment(config, device=resolve_device(config["Trainer"].get("device")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
