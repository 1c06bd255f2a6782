"""Soft Dice losses on channels-last tensors (counterpart of
contrastyou_tpu/losses/dice.py): the meta criterion ``dice`` of the
differentiable mean teacher."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["binary_dice_loss", "dice_loss", "BinaryDiceLoss", "DiceLoss"]


def binary_dice_loss(predict: torch.Tensor, target: torch.Tensor, *, smooth: float = 1.0,
                     p: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    """``1 - (sum pt + smooth) / (sum p^p + t^p + smooth)`` per sample of the
    [B, ...] soft masks of one class, then averaged (``mean``), summed
    (``sum``) or kept."""
    pred = predict.reshape(predict.shape[0], -1)
    targ = target.reshape(target.shape[0], -1)
    num = (pred * targ).sum(1) + smooth
    den = (pred ** p + targ ** p).sum(1) + smooth
    loss = 1.0 - num / den
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def dice_loss(predict: torch.Tensor, target: torch.Tensor, *,
              weight: Optional[Sequence[float]] = None, ignore_index: Optional[int] = None,
              smooth: float = 1.0, p: float = 2.0) -> torch.Tensor:
    """[B, ..., C] simplex against a one-hot target: the classes' binary
    losses (``ignore_index`` left out, each times ``weight[c]`` when given),
    summed and divided by C."""
    C = predict.shape[-1]
    total = 0.0
    for c in range(C):
        if c == ignore_index:
            continue
        part = binary_dice_loss(predict[..., c], target[..., c], smooth=smooth, p=p)
        if weight is not None:
            part = part * weight[c]
        total = total + part
    return total / C


class BinaryDiceLoss:
    def __init__(self, smooth: float = 1.0, p: float = 2.0, reduction: str = "mean"):
        self._kw = dict(smooth=smooth, p=p, reduction=reduction)

    def __call__(self, predict, target):
        return binary_dice_loss(predict, target, **self._kw)


class DiceLoss:
    def __init__(self, weight=None, ignore_index=None, **kwargs):
        self._kw = dict(weight=weight, ignore_index=ignore_index, **kwargs)

    def __call__(self, predict, target):
        return dice_loss(predict, target, **self._kw)
