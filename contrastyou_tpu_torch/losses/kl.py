"""KL divergence, the supervised criterion (counterpart of
contrastyou_tpu/losses/kl.py ``kl_div``). Channels-last probabilities."""
from __future__ import annotations

import torch

__all__ = ["kl_div"]


def kl_div(prob: torch.Tensor, target: torch.Tensor, *, eps: float = 1e-16) -> torch.Tensor:
    """KL(target || prob) = -sum target * log(prob/target) over the last
    axis, averaged over the rest. With a one-hot target this is the
    cross-entropy."""
    return (-target * torch.log((prob + eps) / (target + eps))).sum(-1).mean()
