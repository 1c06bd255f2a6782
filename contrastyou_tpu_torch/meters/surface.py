"""Average-surface-distance meter (counterpart of the ``asd`` mode of
contrastyou_tpu/meters/surface.py): per scan and reported class, the mean
of the two directed surface distances of the 3D prediction and target, from
scipy distance transforms on the host; the summary averages over the scans
where both surfaces exist."""
from __future__ import annotations

import math
import typing as t
from collections import defaultdict

import numpy as np
from scipy.ndimage import binary_erosion, distance_transform_edt

from .metric import Metric, to_host

__all__ = ["SurfaceMeter", "surface_distances", "average_surface_distance"]


def _surface_points(mask: np.ndarray) -> np.ndarray:
    if mask.sum() == 0:
        return np.zeros_like(mask, dtype=bool)
    return mask & ~binary_erosion(mask, iterations=1, border_value=0)


def surface_distances(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Distances from pred's surface voxels to target's surface (infinite
    when either has none)."""
    ps, ts = _surface_points(pred.astype(bool)), _surface_points(target.astype(bool))
    if ps.sum() == 0 or ts.sum() == 0:
        return np.array([np.inf])
    return distance_transform_edt(~ts)[ps]


def average_surface_distance(pred, target) -> float:
    return float((surface_distances(pred, target).mean()
                  + surface_distances(target, pred).mean()) / 2.0)


class SurfaceMeter(Metric[t.Dict[str, float]]):
    """Slices gathered per scan; ``ASD<c>`` per reported class and
    ``ASD_mean``."""

    def __init__(self, C: int, report_axis: t.Optional[t.Iterable[int]] = None):
        self._C = C
        self._report_axis = list(report_axis) if report_axis is not None else list(range(1, C))
        self.reset()

    def reset(self) -> None:
        self._pred_slices: t.Dict[str, list] = defaultdict(list)
        self._target_slices: t.Dict[str, list] = defaultdict(list)

    def add(self, pred, target, *, group_name: t.Sequence[t.Optional[str]]) -> None:
        pred, target = to_host(pred), to_host(target)
        for i, g in enumerate(list(group_name)):
            if g is not None:
                self._pred_slices[g].append(pred[i])
                self._target_slices[g].append(target[i])

    def summary(self) -> t.Dict[str, float]:
        per_class: t.Dict[int, list] = defaultdict(list)
        for g in sorted(self._pred_slices):
            pred_vol = np.stack(self._pred_slices[g])
            target_vol = np.stack(self._target_slices[g])
            for c in self._report_axis:
                val = average_surface_distance(pred_vol == c, target_vol == c)
                if math.isfinite(val):
                    per_class[c].append(val)
        report = {f"ASD{c}": (float(np.mean(per_class[c])) if per_class[c] else math.nan)
                  for c in self._report_axis}
        vals = [v for v in report.values() if not math.isnan(v)]
        report["ASD_mean"] = float(np.mean(vals)) if vals else math.nan
        return report
