"""Tensor predicates and one-hot helpers on torch tensors (counterpart of
contrastyou_tpu/utils/tensor.py): the class axis is the last one by
default, the port's NHWC layout."""
from __future__ import annotations

import torch

__all__ = ["simplex", "one_hot", "class2one_hot", "probs2class", "logits2class",
           "probs2one_hot"]


def simplex(t: torch.Tensor, axis: int = -1, atol: float = 1e-4) -> bool:
    """Whether ``t`` sums to one along ``axis``."""
    s = t.sum(axis)
    return bool(torch.allclose(s, torch.ones_like(s), atol=atol, rtol=1e-5))


def one_hot(t: torch.Tensor, axis: int = -1, atol: float = 1e-4) -> bool:
    """Whether ``t`` is a one-hot encoding along ``axis``."""
    return simplex(t, axis, atol) and bool(((t == 0) | (t == 1)).all())


def class2one_hot(seg: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer map [..., H, W] -> f32 one-hot [..., H, W, C]."""
    return torch.eye(num_classes, dtype=torch.float32, device=seg.device)[seg.long()]


def probs2class(probs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return probs.argmax(axis)


def logits2class(logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return logits.argmax(axis)


def probs2one_hot(probs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return class2one_hot(probs2class(probs, axis), probs.shape[axis])
