"""Synthetic ACDC-layout writer (counterpart of
contrastyou_tpu/data/synthetic.py ``synthesize_acdc_like``): writes
``root/ACDC_contrast/{train,val}/{img,gt}/patient%03d_00_%02d.png`` with the
port's PNG writer. Volumes are nested ellipses (one per class) drifting
across slices over a noisy background, from the same numpy draws as the JAX
writer's, so one seed gives the same pixels in either package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .png import write_png

__all__ = ["synthesize_acdc_like", "make_synthetic_root"]


def _make_volume(rng: np.random.Generator, slices: int, size: int, num_classes: int):
    imgs = np.zeros((slices, size, size), np.uint8)
    gts = np.zeros((slices, size, size), np.uint8)
    cy, cx = rng.uniform(0.35, 0.65, 2) * size
    base_r = rng.uniform(0.18, 0.28) * size
    yy, xx = np.mgrid[0:size, 0:size]
    for s in range(slices):
        drift = (s - slices / 2) / max(slices, 1)
        r = base_r * (1.0 - 0.4 * abs(drift))
        dy, dx = yy - (cy + drift * 6), xx - (cx - drift * 4)
        dist = np.sqrt(dy ** 2 + dx ** 2)
        gt = np.zeros((size, size), np.uint8)
        for c in range(1, num_classes):
            gt[dist < r * (num_classes - c) / (num_classes - 1)] = c
        img = (gt.astype(np.float32) / max(num_classes - 1, 1)) * 0.6
        img += rng.normal(0, 0.05, img.shape)
        img += 0.2 * np.sin(xx / size * 3.1 + rng.uniform(0, 3))
        imgs[s] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        gts[s] = gt
    return imgs, gts


def synthesize_acdc_like(root_dir, *, folder_name: str = "ACDC_contrast",
                         scan_prefix: str = "patient", num_train_scans: int = 10,
                         num_val_scans: int = 4, slices_per_scan: int = 10,
                         size: int = 64, num_classes: int = 4, seed: int = 0,
                         two_part_names: bool = True, first_scan: int = 1) -> Path:
    """Write ``root_dir/folder_name/{train,val}/{img,gt}/*.png``, scans
    numbered from ``first_scan`` (a later call with another length can add
    scans of their own numbers); stems ``patient%03d_00_%02d``."""
    root = Path(root_dir) / folder_name
    rng = np.random.default_rng(seed)
    scan_idx = first_scan - 1
    for mode, n_scans in (("train", num_train_scans), ("val", num_val_scans)):
        img_dir, gt_dir = root / mode / "img", root / mode / "gt"
        img_dir.mkdir(parents=True, exist_ok=True)
        gt_dir.mkdir(parents=True, exist_ok=True)
        for _ in range(n_scans):
            scan_idx += 1
            stem_base = (f"{scan_prefix}{scan_idx:03d}_00" if two_part_names
                         else f"{scan_prefix}{scan_idx:03d}")
            imgs, gts = _make_volume(rng, slices_per_scan, size, num_classes)
            for s in range(slices_per_scan):
                write_png(img_dir / f"{stem_base}_{s:02d}.png", imgs[s])
                write_png(gt_dir / f"{stem_base}_{s:02d}.png", gts[s])
    return root


def make_synthetic_root(tmp_dir, **kwargs) -> str:
    """Write a synthetic layout under ``tmp_dir`` and return it (the data
    root the dataset classes take)."""
    synthesize_acdc_like(tmp_dir, **kwargs)
    return str(tmp_dir)
