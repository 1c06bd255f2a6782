"""KL divergence, the supervised criterion (counterpart of
contrastyou_tpu/losses/kl.py ``kl_div``). Channels-last probabilities."""
from __future__ import annotations

import torch

__all__ = ["kl_div"]


def kl_div(prob: torch.Tensor, target: torch.Tensor, *, eps: float = 1e-16,
           reduction: str = "mean") -> torch.Tensor:
    """KL(target || prob) = -sum target * log(prob/target) over the last
    axis, then averaged over the rest (``mean``) or kept (``none``). With a
    one-hot target this is the cross-entropy."""
    kl = (-target * torch.log((prob + eps) / (target + eps))).sum(-1)
    if reduction == "mean":
        return kl.mean()
    if reduction == "none":
        return kl
    raise ValueError(f"reduction must be mean|none, got {reduction}")
