"""Entry point of the PyTorch port: ``semi`` training or contrastive
pretraining on one device.

    python -m contrastyou_tpu_torch.main -p config/base.yaml config/hooks/consistency.yaml \\
        -o Trainer.name=semi Trainer.num_batches=20
    python -m contrastyou_tpu_torch.main -p config/base.yaml config/hooks/udaiic.yaml \\
        -o Trainer.name=semi
    python -m contrastyou_tpu_torch.main -p config/base.yaml config/pretrain.yaml \\
        config/hooks/infonce.yaml

takes the argv of the root ``main.py``. Without ``-p`` the base is the
in-code equal of the YAML files for ``Trainer.name``: :data:`MAIN_PATH_CONFIG`
(``semi``), :data:`PRETRAIN_DECODER_CONFIG` or :data:`PRETRAIN_ENCODER_CONFIG`,
so no YAML installation is needed (:data:`UDAIIC_CONFIG` is the in-code
``semi`` + ``udaiic`` base; from the ``semi`` base the same run is
``-o Trainer.name=semi ~ConsistencyParameters`` plus the four
``+DiscreteMIConsistencyParams.*`` keys of config/hooks/udaiic.yaml). It runs
``Trainer.num_batches`` steps (one epoch) on a synthetic split made with numpy
from ``RandomSeed`` — dataset files, the epoch loop, evaluation and
checkpoints are not ported yet, and their keys (:data:`UNPORTED_KEYS`)
raise when set. The hooks come from the config's hook
sections (``hooks/creator.py``; a section without a port raises). Both
trainers take the class count of ``Data.name``; pretraining also its
partition count and contrastive sampler (``-o Data.name=prostate``: 8
partitions, 2 classes, random 48-slice batches, 96 images per forward).

The run is on the CUDA card; ``-o Trainer.device=cpu`` asks for the CPU.
Without a card and without that request it raises.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch

from .configure.config import ConfigParser, merge, parse_value
from .data.datasets import DatasetSpec, dataset_spec
from .data.device_cache import DeviceDataCache
from .data.sampler import partition_index
from .engine.bundle import ModelBundle
from .engine.hooks import hook_parameters
from .engine.optim import create_optimizer
from .engine.state import TrainState
from .engine.steps import build_cached_train_step, init_train_state
from .hooks.creator import create_hook_from_config
from .hooks.infonce import INFONCEHook
from .models.unet import UNet
from .trainers.pretrain import (build_pretrain_step, contrastive_batches,
                                feature_until_from_hooks, frozen_after,
                                jitter_strength, sample_pretrain_draws)

__all__ = ["MAIN_PATH_CONFIG", "UDAIIC_CONFIG", "PRETRAIN_DECODER_CONFIG",
           "PRETRAIN_ENCODER_CONFIG", "UNPORTED_KEYS", "refuse_unported_keys",
           "resolve_device", "synthetic_split", "synthetic_scans", "SemiRun",
           "build_semi_run", "PretrainRun", "build_pretrain_run", "parse_config", "main"]

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

_DEFAULTS = {None: MAIN_PATH_CONFIG, "semi": MAIN_PATH_CONFIG,
             "pretrain": PRETRAIN_ENCODER_CONFIG,
             "pretrain_decoder": PRETRAIN_DECODER_CONFIG}

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


#: config keys the port parses but does not implement yet, with the value
#: that means "not used": another value raises rather than train something
#: else (JAX: ``optax.MultiSteps``, ``get_arch`` and the checkpoint keys of
#: the root main.py)
UNPORTED_KEYS = {("Trainer", "accumulate_iter"): 1, ("Arch", "name"): "unet",
                 ("Arch", "checkpoint"): None, ("Arch", "pretrained_path"): None,
                 ("trainer_checkpoint",): None}


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


def _model(config: Mapping, device, dtype, max_channel, generator,
           num_classes: int = NUM_CLASSES) -> UNet:
    arch = config["Arch"]
    model = UNet(input_dim=1, num_classes=num_classes,
                 max_channel=int(max_channel or arch["max_channel"]),
                 momentum=float(arch["momentum"]), dtype=dtype).to(device)
    return model.init_weights(generator)


def _hooks(config: Mapping, model: UNet, device, dtype, generator, *, is_pretrain: bool):
    """The config's hooks on ``device``, their heads drawn from ``generator``
    in hook order."""
    hooks = create_hook_from_config(
        config, channel_dim=model.get_channel_dim, is_pretrain=is_pretrain,
        proj_bf16=dtype == torch.bfloat16 and torch.device(device).type == "cuda")
    for h in hooks:
        if isinstance(h, torch.nn.Module):
            h.to(device).projector.init_weights(generator)
    return hooks


@dataclass
class SemiRun:
    state: TrainState
    step: Callable                  # step(state, generator) -> metrics
    generator: torch.Generator
    batch_slices: int               # slices per step (labeled + unlabeled)
    labeled_cache: DeviceDataCache
    unlabeled_cache: DeviceDataCache
    hooks: List

    def run(self, n: int):
        return [self.step(self.state, self.generator) for _ in range(n)]


def build_semi_run(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                   raw_size: int = 256, crop: int = CROP, n_slices: int = 40,
                   max_channel: Optional[int] = None) -> SemiRun:
    """Model, hooks (their heads optimized beside the model), optimizer,
    device-resident synthetic split and the cached ``semi`` step from a
    reference-style config; the class count is ``Data.name``'s (its label
    remap applied to the targets). Weights and data are made from
    ``RandomSeed``."""
    refuse_unported_keys(config)
    seed = int(config.get("RandomSeed", 10))
    trainer = config["Trainer"]
    spec = dataset_spec(str(config["Data"]["name"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    model = _model(config, device, dtype, max_channel, gen, spec.train_classes)
    bundle = ModelBundle(model, (crop, crop, 1))
    hooks = _hooks(config, model, device, dtype, gen, is_pretrain=False)
    optimizer, _ = create_optimizer(
        list(model.parameters()) + hook_parameters(hooks), config["Optim"],
        config.get("Scheduler"), max_epoch=int(trainer["max_epoch"]),
        steps_per_epoch=int(trainer["num_batches"]))
    state = init_train_state(bundle, hooks, optimizer)
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
    if not trainer.get("two_stage", True):
        raise ValueError("Trainer.two_stage=False is not ported (two-stage BN only)")
    step = build_cached_train_step(
        bundle, hooks, labeled_cache=lab, unlabeled_cache=unl,
        labeled_batch=nl, unlabeled_batch=nu,
        disable_bn=bool(trainer.get("disable_bn", False)))
    return SemiRun(state, step, gen, nl + nu, lab, unl, hooks)


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
                       max_channel: Optional[int] = None) -> PretrainRun:
    """``pretrain`` / ``pretrain_decoder``: model, InfoNCE hooks with their
    projection heads, RAdam over the layers up to the deepest tap plus the
    heads, synthetic scans of ``Data.name``'s layout resident on the device,
    its contrastive batch sampler and the pretrain step. Weights and data are
    made from ``RandomSeed``. ``slices_per_scan`` defaults to 10 for
    datasets of 3 partitions and to 8 per partition above (64 for prostate),
    enough for the ``cur // (cut + 1)`` rule to fill every partition."""
    refuse_unported_keys(config)
    seed = int(config.get("RandomSeed", 10))
    trainer = config["Trainer"]
    data_name = str(config["Data"]["name"])
    spec = dataset_spec(data_name)
    if slices_per_scan is None:
        slices_per_scan = 10 if spec.partition_num <= 3 else 8 * spec.partition_num
    gen = torch.Generator(device=device).manual_seed(seed)
    model = _model(config, device, dtype, max_channel, gen, spec.train_classes)
    bundle = ModelBundle(model, (crop, crop, 1))
    hooks = _hooks(config, model, device, dtype, gen, is_pretrain=True)
    others = [h.name for h in hooks if not isinstance(h, INFONCEHook)]
    if others or not hooks:
        raise NotImplementedError(f"the port pretrains with InfoNCE hooks only; got "
                                  f"{others or 'no hook'}")
    until = feature_until_from_hooks(*hooks)
    trainable = frozen_after(until)
    params = [p for name, p in model.named_parameters() if trainable(name)]
    optimizer, _ = create_optimizer(
        params + hook_parameters(hooks), config["Optim"], config.get("Scheduler"),
        max_epoch=int(trainer["max_epoch"]), steps_per_epoch=int(trainer["num_batches"]))
    state = init_train_state(bundle, hooks, optimizer)

    scans = synthetic_scans(n_scans, slices_per_scan, raw_size, spec=spec, seed=seed)
    cache = DeviceDataCache.from_arrays(
        scans["images"], scans["targets"], crop=crop, device=device,
        scan_id=scans["scan_id"], partition=scans["partition"],
        patient=scans["patient"], cycle=scans["cycle"], scan_names=scans["scan_names"])
    clp = config.get("ContrastiveLoaderParams", {})
    batches, pad_to = contrastive_batches(
        data_name, [scans["scan_names"][s] for s in scans["scan_id"]], scans["partition"],
        partition_num=spec.partition_num,
        scan_sample_num=int(clp.get("scan_sample_num", 6)),
        partition_sample_num=int(clp.get("partition_sample_num", 1)), seed=seed)
    step = build_pretrain_step(bundle, hooks, until=until)
    grids = sorted({h.grid for h in hooks if h.grid is not None})
    strength = jitter_strength(data_name)

    def cached_step(state: TrainState, generator: torch.Generator, epoch: int = 0):
        # a short batch is padded by repeating its last slice (data/loader.py collate)
        idx = next(batches)[:pad_to]
        idx = idx + idx[-1:] * (pad_to - len(idx))
        batch = cache.sample_at(torch.tensor(idx, device=cache.device),
                                *cache.draw_offsets(generator, pad_to))
        draws = sample_pretrain_draws(generator, pad_to, color_jitter=strength,
                                      point_grids=grids)
        return step(state, batch, draws, epoch)

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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config = parse_config(argv)
    device = resolve_device(config["Trainer"].get("device"))
    name = config["Trainer"].get("name")
    pretrain = name in ("pretrain", "pretrain_decoder")
    run = (build_pretrain_run if pretrain else build_semi_run)(config, device=device)
    n = int(config["Trainer"]["num_batches"])
    t0 = time.perf_counter()
    for i in range(n):
        m = run.step(run.state, run.generator)
        if i % 10 == 0 or i == n - 1:
            if pretrain:
                print(f"step {i}: " + " ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
            else:
                print(f"step {i}: sup {float(m['sup_loss']):.4f} "
                      f"reg {float(m['reg_loss']):.6f} total {float(m['total_loss']):.4f}")
    dt = time.perf_counter() - t0
    print(f"{n} {name or 'semi'} steps on {device} in {dt:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
