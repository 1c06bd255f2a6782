"""Label colours for segmentation pictures (counterpart of
contrastyou_tpu/utils/colors.py: the same palette and blend)."""
from __future__ import annotations

import numpy as np

__all__ = ["label2colored_image", "overlay_segmentation"]

#: RGB of up to 22 classes (class 0, the background, black)
_PALETTE = np.array([
    (0, 0, 0), (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
    (255, 255, 255),
], dtype=np.uint8)


def label2colored_image(label: np.ndarray) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] uint8 RGB (labels past the palette
    take its last colour)."""
    label = np.asarray(label)
    return _PALETTE[np.clip(label, 0, len(_PALETTE) - 1)]


def overlay_segmentation(image: np.ndarray, label: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """A grayscale [H, W] image in [0, 1] blended with the colours of the
    labels > 0, ``alpha`` of the colour: [H, W, 3] uint8."""
    rgb = np.repeat((np.clip(image, 0, 1) * 255).astype(np.uint8)[..., None], 3, axis=-1)
    colored = label2colored_image(label)
    mask = (np.asarray(label) > 0)[..., None]
    out = rgb.astype(np.float32)
    out = np.where(mask, (1 - alpha) * out + alpha * colored, out)
    return out.astype(np.uint8)
