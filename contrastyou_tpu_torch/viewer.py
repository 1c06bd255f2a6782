"""Multi-slice volume viewer (counterpart of contrastyou_tpu/viewer.py, the
``contrastyou-viewer`` script): scroll through the slices of one or more
aligned volumes, optionally with segmentation contours.

    python -m contrastyou_tpu_torch.viewer <folder of slice PNGs> [...]

The volumes are read with the port's PNG reader (``data/png.py``); the
window needs matplotlib, imported only by :meth:`SliceViewer.show`, which
raises ``ImportError`` naming it where it is missing.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .data.png import read_png

__all__ = ["SliceViewer", "load_volume_from_pngs", "main"]


def _to_grey(image: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of an RGB uint8 image: ITU-R 601-2 luma,
    ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``."""
    rgb = image.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


class SliceViewer:
    def __init__(self, *volumes: np.ndarray, masks=None, cmap: str = "gray"):
        if not volumes:
            raise ValueError("at least one volume")
        self.volumes = [np.asarray(v) for v in volumes]
        self.masks = [np.asarray(m) for m in masks] if masks else None
        self.index = self.volumes[0].shape[0] // 2
        self._cmap = cmap
        self.fig = None

    def show(self):
        try:
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise ImportError("SliceViewer.show needs matplotlib, which is not installed") from e
        fig, axes = plt.subplots(1, len(self.volumes), squeeze=False)
        self.axes, self.fig = axes[0], fig
        self._draw()
        fig.canvas.mpl_connect("scroll_event", self._on_scroll)
        fig.canvas.mpl_connect("key_press_event", self._on_key)
        plt.show()

    def _draw(self):
        if self.fig is None:
            return
        for i, (ax, vol) in enumerate(zip(self.axes, self.volumes)):
            ax.clear()
            ax.imshow(vol[self.index], cmap=self._cmap)
            if self.masks is not None and i < len(self.masks):
                ax.contour(self.masks[i][self.index], linewidths=0.7)
            ax.set_title(f"slice {self.index}/{vol.shape[0] - 1}")
            ax.axis("off")
        self.fig.canvas.draw_idle()

    def _on_scroll(self, event):
        self._step(1 if event.button == "up" else -1)

    def _on_key(self, event):
        if event.key in ("up", "right"):
            self._step(1)
        elif event.key in ("down", "left"):
            self._step(-1)

    def _step(self, delta: int):
        """Move ``delta`` slices, clipped to the first volume's range."""
        self.index = int(np.clip(self.index + delta, 0, self.volumes[0].shape[0] - 1))
        self._draw()


def load_volume_from_pngs(folder) -> np.ndarray:
    """The folder's ``*.png`` slices in name order, as grey uint8 [N, H, W]
    (RGB slices converted as PIL's ``convert("L")``)."""
    slices = [read_png(path, rgb=True) for path in sorted(Path(folder).glob("*.png"))]
    return np.stack([_to_grey(s) if s.ndim == 3 else s for s in slices])


def main(argv=None):
    parser = argparse.ArgumentParser(description="multi-slice volume viewer")
    parser.add_argument("folders", nargs="+", help="folders of per-slice PNGs (aligned volumes)")
    args = parser.parse_args(argv)
    SliceViewer(*[load_volume_from_pngs(f) for f in args.folders]).show()


if __name__ == "__main__":
    main()
