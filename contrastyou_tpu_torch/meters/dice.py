"""Per-slice dice counts (counterpart of contrastyou_tpu/meters/dice.py
``slice_intersection_union``); the group-wise meter is not ported yet."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["slice_intersection_union"]


def slice_intersection_union(pred: torch.Tensor, target: torch.Tensor, *,
                             num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample per-class (intersection, union) [B, C] of integer class
    maps [B, ...]; union = |pred| + |target| (the reference convention)."""
    dims = tuple(range(1, pred.dim()))
    oh_p = F.one_hot(pred.long(), num_classes)
    oh_t = F.one_hot(target.long(), num_classes)
    return (oh_p * oh_t).sum(dims), (oh_p + oh_t).sum(dims)
