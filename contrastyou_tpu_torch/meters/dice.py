"""Per-slice dice counts and the group-wise (per 3D scan) dice meter
(counterpart of contrastyou_tpu/meters/dice.py): slice counts are summed
per scan, the summary reports the scans' mean volumetric dice per reported
class as ``DSC<i>`` and their mean as ``DSC_mean``. Counts may stay on the
device until :meth:`UniversalDice.join`."""
from __future__ import annotations

import math
import typing as t
from collections import defaultdict
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .metric import Metric, to_host

__all__ = ["slice_intersection_union", "UniversalDice"]


def slice_intersection_union(pred: torch.Tensor, target: torch.Tensor, *,
                             num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample per-class (intersection, union) [B, C] of integer class
    maps [B, ...]; union = |pred| + |target| (the reference convention)."""
    dims = tuple(range(1, pred.dim()))
    oh_p = F.one_hot(pred.long(), num_classes)
    oh_t = F.one_hot(target.long(), num_classes)
    return (oh_p * oh_t).sum(dims), (oh_p + oh_t).sum(dims)


class UniversalDice(Metric[t.Dict[str, float]]):
    def __init__(self, C: int, report_axis: t.Optional[t.Iterable[int]] = None):
        if report_axis is not None and max(report_axis) >= C:
            raise ValueError(f"report_axis {list(report_axis)} incompatible with C={C}")
        self._C = C
        self._report_axis = list(report_axis) if report_axis is not None else list(range(C))
        self.reset()

    def reset(self) -> None:
        self._pending: list = []
        self._inter: t.Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(self._C, np.int64))
        self._union: t.Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(self._C, np.int64))
        self._n = 0

    def add(self, pred, target, *, group_name=None, mask=None) -> None:
        """Integer class maps [B, ...] (argmax taken), grouped by
        ``group_name`` (one name, one per sample, or None: each sample its
        own group); ``mask`` [B] drops padded samples."""
        pred, target = torch.as_tensor(pred), torch.as_tensor(target)
        if pred.shape != target.shape:
            raise ValueError(f"shape mismatch {tuple(pred.shape)} vs {tuple(target.shape)}")
        b = pred.shape[0]
        if group_name is None:
            names = [f"{self._n}_{i:03d}" for i in range(b)]
        elif isinstance(group_name, str):
            names = [group_name] * b
        else:
            names = list(group_name)
            if len(names) != b:
                raise ValueError(f"group_name has {len(names)} entries for batch of {b}")
        inter, union = slice_intersection_union(pred, target, num_classes=self._C)
        if mask is not None:
            keep = to_host(mask).astype(bool)
            names = [n if k else None for n, k in zip(names, keep)]
        self._pending.append((inter, union, names))
        self._n += 1

    def add_counts(self, inter, union, *, group_name=None, group_ids=None,
                   id_table: t.Optional[t.Sequence[str]] = None) -> None:
        """Per-sample [B, C] counts from a step; a sample whose name is None
        (a padded slot) is skipped. Either host ``group_name`` strings, or
        device ``group_ids`` into the host ``id_table`` (read at
        :meth:`join`)."""
        if group_ids is not None:
            names = (group_ids, list(id_table))
        else:
            names = list(group_name)
            if len(names) != inter.shape[0]:
                raise ValueError(f"{len(names)} names for {inter.shape[0]} samples")
        self._pending.append((inter, union, names))
        self._n += 1

    def join(self) -> None:
        for inter, union, names in self._pending:
            if isinstance(names, tuple):
                ids, table = names
                names = [table[i] if 0 <= i < len(table) else None
                         for i in to_host(ids).reshape(-1).tolist()]
            inter_h, union_h = to_host(inter), to_host(union)
            for i, name in enumerate(names):
                if name is not None:
                    self._inter[name] += inter_h[i]
                    self._union[name] += union_h[i]
        self._pending.clear()

    @property
    def group_names(self) -> t.List[str]:
        self.join()
        return sorted(self._inter)

    def compute_dice_by_group(self) -> t.Optional[np.ndarray]:
        self.join()
        if not self._inter:
            return None
        names = self.group_names
        inter = np.stack([self._inter[g] for g in names]).astype(np.float64)
        union = np.stack([self._union[g] for g in names]).astype(np.float64)
        return (2 * inter + 1e-16) / (union + 1e-16)

    def summary(self) -> t.Dict[str, float]:
        dices = self.compute_dice_by_group()
        if dices is None:
            report = {f"DSC{i}": math.nan for i in self._report_axis}
            report["DSC_mean"] = math.nan
            return report
        means = dices.mean(axis=0)
        report = {f"DSC{i}": float(means[i]) for i in self._report_axis}
        report["DSC_mean"] = float(np.mean(list(report.values())))
        return report
