"""Entry point of the PyTorch port: ``semi`` training on one device.

    python -m contrastyou_tpu_torch.main -p config/base.yaml config/hooks/consistency.yaml \\
        -o Trainer.name=semi Trainer.num_batches=20

takes the argv of the root ``main.py``. Without ``-p`` the base is
:data:`MAIN_PATH_CONFIG`, the in-code equal of ``config/base.yaml`` +
``config/hooks/consistency.yaml``, so no YAML installation is needed. It runs
``Trainer.num_batches`` steps (one epoch) of the device-cached ``semi`` step
on a synthetic ACDC-like split made with numpy from ``RandomSeed`` — dataset
files, the epoch loop, evaluation and checkpoints are not ported yet.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .configure.config import ConfigParser
from .data.device_cache import DeviceDataCache
from .engine.bundle import ModelBundle
from .engine.optim import create_optimizer
from .engine.state import TrainState
from .engine.steps import build_cached_train_step, init_train_state
from .hooks.consistency import ConsistencyTrainerHook
from .models.unet import UNet

__all__ = ["MAIN_PATH_CONFIG", "synthetic_split", "SemiRun", "build_semi_run", "main"]

#: config/base.yaml merged with config/hooks/consistency.yaml
MAIN_PATH_CONFIG = {
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
    "ConsistencyParameters": {"weight": 10},
}

#: ACDC's class count and the reference crop of its slices
NUM_CLASSES = 4
CROP = 224


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


@dataclass
class SemiRun:
    state: TrainState
    step: Callable                  # step(state, generator) -> metrics
    generator: torch.Generator
    batch_slices: int               # slices per step (labeled + unlabeled)
    labeled_cache: DeviceDataCache
    unlabeled_cache: DeviceDataCache

    def run(self, n: int):
        return [self.step(self.state, self.generator) for _ in range(n)]


def build_semi_run(config: Mapping, *, device, dtype: torch.dtype = torch.bfloat16,
                   raw_size: int = 256, crop: int = CROP, n_slices: int = 40,
                   max_channel: Optional[int] = None) -> SemiRun:
    """Model, hooks, optimizer, device-resident synthetic split and the
    cached ``semi`` step from a reference-style config. Weights and data are
    made from ``RandomSeed``."""
    seed = int(config.get("RandomSeed", 10))
    arch = config["Arch"]
    trainer = config["Trainer"]
    gen = torch.Generator(device=device).manual_seed(seed)
    model = UNet(input_dim=1, num_classes=NUM_CLASSES,
                 max_channel=int(max_channel or arch["max_channel"]),
                 momentum=float(arch["momentum"]), dtype=dtype).to(device)
    model.init_weights(gen)
    bundle = ModelBundle(model, (crop, crop, 1))
    hooks = []
    if "ConsistencyParameters" in config:
        hooks.append(ConsistencyTrainerHook(
            weight=float(config["ConsistencyParameters"]["weight"])))
    optimizer, _ = create_optimizer(
        model.parameters(), config["Optim"], config.get("Scheduler"),
        max_epoch=int(trainer["max_epoch"]),
        steps_per_epoch=int(trainer["num_batches"]))
    state = init_train_state(bundle, hooks, optimizer)
    images, targets = synthetic_split(n_slices, raw_size, seed=seed)
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
    return SemiRun(state, step, gen, nl + nu, lab, unl)


def main(argv=None) -> int:
    config = ConfigParser(MAIN_PATH_CONFIG).parse(sys.argv[1:] if argv is None else argv)
    name = config["Trainer"].get("name")
    if name not in (None, "semi"):
        raise SystemExit(f"Trainer.name={name!r}: only 'semi' is ported")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    run = build_semi_run(config, device=device)
    n = int(config["Trainer"]["num_batches"])
    t0 = time.perf_counter()
    for i in range(n):
        m = run.step(run.state, run.generator)
        if i % 10 == 0 or i == n - 1:
            print(f"step {i}: sup {float(m['sup_loss']):.4f} "
                  f"reg {float(m['reg_loss']):.6f} total {float(m['total_loss']):.4f}")
    dt = time.perf_counter() - t0
    print(f"{n} steps on {device} in {dt:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
