"""Run artifacts of hook visualizations (counterpart of
contrastyou_tpu/hooks/savers.py, the same files, names and zips, the PNGs
written with the port's PNG writer): :class:`FeatureMapSaver` (image and two
feature or probability maps as PNG panels per epoch), :class:`DistributionTracker`
(per-epoch histograms of two cluster assignments, npz), :class:`MatrixSaver`
(raw npz dumps), and :func:`joint_2D_figure`, a joint matrix logged to
TensorBoard.

``joint_2D_figure`` differs from JAX's in its rendering: the card's machine
has no matplotlib, so the matrix is logged as an image summary, min-max
normalized to uint8 grayscale (one pixel per entry), where JAX logs a
matplotlib ``viridis`` heat map with a colour bar.
"""
from __future__ import annotations

import shutil
import zipfile
from pathlib import Path

import numpy as np

from ..data.png import write_png

__all__ = ["norm_uint8", "FeatureMapSaver", "DistributionTracker", "MatrixSaver",
           "joint_2D_figure"]


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def norm_uint8(x) -> np.ndarray:
    """``x`` min-max normalized (``(x - min) / (max - min + 1e-8)``) and
    scaled to uint8 by truncation, as JAX's savers write their PNGs."""
    x = _host(x)
    lo, hi = float(x.min()), float(x.max())
    return ((x - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)


def _zip(root: Path) -> str:
    out = root.with_suffix(".zip")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        for p in root.rglob("*"):
            zf.write(p, p.relative_to(root.parent))
    shutil.rmtree(root)
    return str(out)


class FeatureMapSaver:
    """Image + two feature / probability maps as PNG panels per epoch."""

    def __init__(self, save_dir, folder_name: str = "vis"):
        self.root = Path(save_dir) / folder_name
        self.root.mkdir(parents=True, exist_ok=True)

    def save_map(self, *, image, feature_map1, feature_map2, cur_epoch: int,
                 cur_batch_num: int = 0, save_name: str = "feature",
                 feature_type: str = "map") -> None:
        """``image`` [B, H, W, 1] or [B, H, W]; the maps [B, H, W(, C)],
        a map with channels shown as their mean."""
        folder = self.root / f"epoch_{cur_epoch:03d}"
        folder.mkdir(exist_ok=True)
        image = _host(image)
        write_png(folder / f"{save_name}_{cur_batch_num}_image.png",
                  norm_uint8(image[0, ..., 0] if image.ndim == 4 else image[0]))
        for tag, fmap in (("a", _host(feature_map1)), ("b", _host(feature_map2))):
            fm = fmap[0]
            write_png(folder / f"{save_name}_{cur_batch_num}_{tag}.png",
                      norm_uint8(fm.mean(-1) if fm.ndim == 3 else fm))

    def zip(self) -> str:
        return _zip(self.root)


class DistributionTracker:
    """Per-epoch cluster-assignment histograms of two distributions."""

    def __init__(self, save_dir, folder_name: str = "dist"):
        self.root = Path(save_dir) / folder_name
        self.root.mkdir(parents=True, exist_ok=True)

    def save_map(self, *, dist1, dist2, cur_epoch: int) -> None:
        d1, d2 = _host(dist1), _host(dist2)
        d1, d2 = d1.reshape(-1, d1.shape[-1]), d2.reshape(-1, d2.shape[-1])
        np.savez_compressed(self.root / f"epoch_{cur_epoch:03d}.npz",
                            hist1=np.bincount(d1.argmax(-1), minlength=d1.shape[-1]),
                            hist2=np.bincount(d2.argmax(-1), minlength=d2.shape[-1]))

    def zip(self) -> str:
        return _zip(self.root)


class MatrixSaver:
    """Raw npz dumps of matrices (feature or probability tensors)."""

    def __init__(self, save_dir, folder_name: str = "matrix"):
        self.root = Path(save_dir) / folder_name
        self.root.mkdir(parents=True, exist_ok=True)

    def save_matrix(self, *, matrix, cur_epoch: int, cur_batch_num: int, save_name: str) -> None:
        np.savez_compressed(self.root / f"{save_name}_e{cur_epoch:03d}_b{cur_batch_num}.npz",
                            matrix=_host(matrix))


def joint_2D_figure(joint, *, tb_writer, cur_epoch: int, tag: str) -> None:
    """Log a [k, k] joint matrix to ``tb_writer`` at step ``cur_epoch`` as a
    grayscale image (see the module docstring for how this rendering
    differs from JAX's)."""
    tb_writer.add_image(tag, norm_uint8(joint), cur_epoch, dataformats="HW")
