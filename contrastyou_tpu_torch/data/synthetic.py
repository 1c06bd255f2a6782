"""Synthetic dataset writers (counterpart of
contrastyou_tpu/data/synthetic.py), with the port's PNG writer.
``synthesize_acdc_like`` writes
``root/ACDC_contrast/{train,val}/{img,gt}/patient%03d_00_%02d.png``;
``synthesize_dataset`` writes the archive layout of any ``Data.name``
(:data:`_LAYOUTS`: the archive's folders and stems, per-scan native H x W
and slice counts, its class count, the ``*_info.npy`` scan -> slice count
file and the ``<name>_ordering.json`` split). Volumes are nested ellipses
(one per class) drifting across slices over a noisy background, from the
same numpy draws as the JAX writers', so one seed gives the same pixels,
metadata and ordering in either package.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from .datasets import data_zoo
from .png import write_png

__all__ = ["synthesize_acdc_like", "make_synthetic_root", "synthesize_dataset"]


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


#: per-dataset archive layouts: stem and scan name of scan ``i``, the range
#: of native slice sizes (square, H = W) and per-scan slice counts, the
#: metadata file, the mode folders and sub-folders, and the class count
_LAYOUTS = {
    "acdc": dict(stem=lambda i, s: f"patient{i:03d}_00_{s:02d}",
                 scan_key=lambda i: f"patient{i:03d}_00",
                 sizes=(154, 256), slices=(6, 18), info="acdc_info.npy",
                 modes=("train", "val"), subs=("img", "gt"), classes=4),
    "prostate": dict(stem=lambda i, s: f"Case{i:02d}_{s:02d}",
                     scan_key=lambda i: f"Case{i:02d}",
                     sizes=(256, 384), slices=(15, 54), info="prostate_info.npy",
                     modes=("train", "val"), subs=("img", "gt"), classes=2),
    "prostate_md": dict(stem=lambda i, s: f"prostate_{i:02d}_{s:02d}",
                        scan_key=lambda i: f"prostate_{i:02d}",
                        sizes=(256, 384), slices=(11, 24), info="prostate_info.npy",
                        modes=("train", "val"), subs=("t2", "gt"), classes=2),
    "mmwhsct": dict(stem=lambda i, s: f"ct_train_{1000 + i}_{s:02d}",
                    scan_key=lambda i: str(1000 + i),
                    sizes=(240, 320), slices=(80, 130), info="meta_ct.npy",
                    modes=("ct_train", "ct_val"), subs=("img", "gt"), classes=5),
    "mmwhsmr": dict(stem=lambda i, s: f"mr_train_{1000 + i}_{s:02d}",
                    scan_key=lambda i: str(1000 + i),
                    sizes=(200, 288), slices=(70, 120), info="meta_mr.npy",
                    modes=("mr_train", "mr_val"), subs=("img", "gt"), classes=5),
    "spleen": dict(stem=lambda i, s: f"spleen_{i:02d}_{s:02d}",
                   scan_key=lambda i: f"spleen_{i:02d}",
                   sizes=(512, 512), slices=(31, 100), info="spleen_info.npy",
                   modes=("train", "val"), subs=("img", "gt"), classes=2),
    "hippocampus": dict(stem=lambda i, s: f"hippocampus_{i:03d}_{s:02d}",
                        scan_key=lambda i: f"hippocampus_{i:03d}",
                        sizes=(31, 68), slices=(24, 48), info="hippocampus_info.npy",
                        modes=("train", "val"), subs=("img", "gt"), classes=3),
}


def synthesize_dataset(root_dir, name: str, *, num_train_scans: int = 4,
                       num_val_scans: int = 2, seed: int = 0, write_info: bool = True,
                       write_ordering: bool = True,
                       max_slices: Optional[int] = 12) -> Path:
    """Write a synthetic archive of dataset ``name`` under
    ``root_dir/<folder_name>``: its mode folders and sub-folders, per-scan
    native size and slice count drawn from the layout's ranges
    (``max_slices`` caps the count; None keeps the archive's), its class
    count, the ``*_info.npy`` metadata (scan -> slice count) and the
    ``<name>_ordering.json`` list of train scans (``acdc`` for the ACDC
    family)."""
    lay = _LAYOUTS[name if not name.startswith("acdc") else "acdc"]
    root = Path(root_dir) / data_zoo[name].folder_name
    rng = np.random.default_rng(seed)
    info: dict = {}
    scan_idx, train_scans = 0, []
    for mode, n_scans in ((lay["modes"][0], num_train_scans), (lay["modes"][1], num_val_scans)):
        dirs = [root / mode / sub for sub in lay["subs"]]
        for d in dirs:
            d.mkdir(parents=True, exist_ok=True)
        for _ in range(n_scans):
            scan_idx += 1
            n_slices = int(rng.integers(lay["slices"][0], lay["slices"][1] + 1))
            if max_slices is not None:
                n_slices = min(n_slices, max_slices)
            size = int(rng.integers(lay["sizes"][0], lay["sizes"][1] + 1))
            imgs, gts = _make_volume(rng, n_slices, size, lay["classes"])
            for s in range(n_slices):
                stem = lay["stem"](scan_idx, s)
                write_png(dirs[0] / f"{stem}.png", imgs[s])
                write_png(dirs[1] / f"{stem}.png", gts[s])
            key = lay["scan_key"](scan_idx)
            info[key] = n_slices
            if mode == lay["modes"][0]:
                train_scans.append(key)
    if write_info:
        np.save(root / lay["info"], np.asarray(info, dtype=object))
    if write_ordering:
        lookup = "acdc" if name.startswith("acdc_") else name
        (root / f"{lookup}_ordering.json").write_text(json.dumps(train_scans))
    return root
