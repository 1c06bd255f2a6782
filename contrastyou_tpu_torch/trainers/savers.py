"""Prediction pictures of inference (counterpart of
contrastyou_tpu/trainers/savers.py ``InferenceSaver``, the same files and
pixels, written with the port's PNG writer): per slice
``<save_dir>/<folder_name>/{img,gt,pred,overlay}/<stem>.png``, the image as
8-bit grayscale, ground truth and prediction in the palette of
:mod:`..utils.colors`, and the prediction over the image."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.png import write_png
from ..utils.colors import label2colored_image, overlay_segmentation

__all__ = ["InferenceSaver"]


def _host(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is read back from its device)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class InferenceSaver:
    def __init__(self, save_dir, folder_name: str = "predictions"):
        self.root = Path(save_dir) / folder_name
        for sub in ("img", "gt", "pred", "overlay"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)

    def save_batch(self, *, image, target, pred, filenames, mask=None) -> None:
        """``image`` [B, H, W, 1] in [0, 1], ``target`` / ``pred`` [B, H, W]
        labels; slots whose ``mask`` is False (a padded batch) are skipped."""
        image, target, pred = _host(image), _host(target), _host(pred)
        mask = None if mask is None else _host(mask)
        for i, stem in enumerate(filenames):
            if mask is not None and not bool(mask[i]):
                continue
            img = (np.clip(image[i, ..., 0], 0, 1) * 255).astype(np.uint8)
            write_png(self.root / "img" / f"{stem}.png", img)
            write_png(self.root / "gt" / f"{stem}.png", label2colored_image(target[i]))
            write_png(self.root / "pred" / f"{stem}.png", label2colored_image(pred[i]))
            write_png(self.root / "overlay" / f"{stem}.png",
                      overlay_segmentation(image[i, ..., 0], pred[i]))
