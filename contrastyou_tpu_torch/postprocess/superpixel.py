"""Superpixel maps for the superpixel InfoNCE hook (counterpart of
contrastyou_tpu/postprocess/superpixel.py): :func:`slic`, a numpy SLIC
(k-means in intensity and position, each centre searching a window of 4S x
4S around it), and :func:`generate_superpixels`, which writes
``<mode>/superpixel/*.png`` beside an archive's ``img`` folder with the
port's PNG codec, the layout the ``acdc_superpixel`` dataset reads.

The arithmetic is JAX's, operation for operation, so the maps are equal;
the centre update gathers each label's pixels through one stable argsort
of the labels instead of a full-image mask per label: the same pixels in the
same (row-major) order, so the same means.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..data.png import read_png, write_png

__all__ = ["slic", "generate_superpixels"]


def slic(image: np.ndarray, n_segments: int = 40, compactness: float = 0.05,
         n_iter: int = 10, sigma: float = 0.0) -> np.ndarray:
    """f32 [H, W] in [0, 1] -> int32 [H, W] superpixel labels: centres on a
    grid of step ``S = sqrt(H W / n_segments)``, ``n_iter`` rounds of
    assignment (distance ``(I - I_c)^2 + (compactness / S)^2 (dy^2 + dx^2)``
    within 2S of the centre) and centre update; ``sigma`` > 0 smooths the
    image first."""
    H, W = image.shape
    if sigma > 0:
        from scipy.ndimage import gaussian_filter
        image = gaussian_filter(image, sigma)
    S = max(int(np.sqrt(H * W / n_segments)), 1)
    cy, cx = np.meshgrid(np.arange(S // 2, H, S), np.arange(S // 2, W, S), indexing="ij")
    centers = np.stack([cy.ravel().astype(np.float64), cx.ravel().astype(np.float64)], axis=1)
    k = len(centers)
    cvals = image[centers[:, 0].astype(int), centers[:, 1].astype(int)]

    yy, xx = np.mgrid[0:H, 0:W]
    flat_y, flat_x, flat_img = yy.ravel(), xx.ravel(), image.ravel()
    labels = np.zeros((H, W), np.int32)
    dist = np.full((H, W), np.inf)
    ratio = compactness / S
    for _ in range(n_iter):
        dist[:] = np.inf
        for i in range(k):
            y0, x0 = centers[i]
            ys0, ys1 = max(int(y0) - 2 * S, 0), min(int(y0) + 2 * S, H)
            xs0, xs1 = max(int(x0) - 2 * S, 0), min(int(x0) + 2 * S, W)
            patch = image[ys0:ys1, xs0:xs1]
            dy = yy[ys0:ys1, xs0:xs1] - y0
            dx = xx[ys0:ys1, xs0:xs1] - x0
            d = (patch - cvals[i]) ** 2 + (ratio ** 2) * (dy ** 2 + dx ** 2)
            better = d < dist[ys0:ys1, xs0:xs1]
            dist[ys0:ys1, xs0:xs1] = np.where(better, d, dist[ys0:ys1, xs0:xs1])
            labels[ys0:ys1, xs0:xs1] = np.where(better, i, labels[ys0:ys1, xs0:xs1])
        flat = labels.ravel()
        order = np.argsort(flat, kind="stable")
        ends = np.cumsum(np.bincount(flat, minlength=k))
        for i in range(k):
            start = ends[i - 1] if i else 0
            if ends[i] > start:
                members = order[start:ends[i]]
                centers[i, 0] = flat_y[members].mean()
                centers[i, 1] = flat_x[members].mean()
                cvals[i] = flat_img[members].mean()
    return labels


def _write_superpixels(path: Path, out: Path, n_segments: int, compactness: float) -> None:
    image = read_png(path).astype(np.float32) / 255.0
    labels = slic(image, n_segments=n_segments, compactness=compactness)
    write_png(out, labels.astype(np.uint8))


def generate_superpixels(dataset_root, *, mode: str = "train", n_segments: int = 40,
                         compactness: float = 0.05) -> int:
    """Write ``dataset_root/mode/superpixel/<stem>.png`` (uint8 labels) for
    every PNG of ``dataset_root/mode/img``; -> the number written. The
    slices are spread over one spawned process per CPU this process may run
    on (at most one per slice); with one slice or one CPU they run here."""
    root = Path(dataset_root) / mode
    out_dir = root / "superpixel"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(path, out_dir / path.name, n_segments, compactness)
            for path in sorted((root / "img").iterdir()) if path.suffix == ".png"]
    workers = min(len(os.sched_getaffinity(0)), len(jobs))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_write_superpixels, *zip(*jobs)))
    else:
        for job in jobs:
            _write_superpixels(*job)
    return len(jobs)
