"""Entropy and KL divergence (counterpart of contrastyou_tpu/losses/kl.py
``entropy_loss`` and ``kl_div``; ``kl_div`` is the supervised criterion).
Channels-last probabilities."""
from __future__ import annotations

import torch

__all__ = ["entropy_loss", "kl_div"]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"reduction must be mean|sum|none, got {reduction}")


def entropy_loss(probs: torch.Tensor, *, dim: int = -1, eps: float = 1e-16,
                 reduction: str = "mean") -> torch.Tensor:
    """H(p) = -sum p log(p + eps) along ``dim``, then reduced."""
    return _reduce(-(probs * torch.log(probs + eps)).sum(dim), reduction)


def kl_div(prob: torch.Tensor, target: torch.Tensor, *, eps: float = 1e-16,
           reduction: str = "mean") -> torch.Tensor:
    """KL(target || prob) = -sum target * log(prob/target) over the last
    axis, then averaged over the rest (``mean``), summed (``sum``) or kept
    (``none``). With a one-hot target this is the cross-entropy."""
    return _reduce((-target * torch.log((prob + eps) / (target + eps))).sum(-1), reduction)
