"""The redundancy criterion between Barlow Twins and IIC (counterpart of
contrastyou_tpu/losses/redundancy.py): the target joint interpolates between
identity / K (``alpha`` 1, Barlow-Twins-like) and the joint itself (``alpha``
0, entropy minimization); a pseudo cross-entropy to the target plus a
marginal-entropy term weighted by ``lamda``."""
from __future__ import annotations

import torch

from .discrete_mi import compute_joint_2d_with_padding_zeros

__all__ = ["redundancy_criterion", "RedundancyCriterion"]


def redundancy_criterion(x_out: torch.Tensor, x_tf_out: torch.Tensor, *, alpha: float,
                         lamda: float = 1.0, eps: float = 1e-5, symmetric: bool = True,
                         return_joint: bool = False, group=None):
    """``x_out`` / ``x_tf_out``: [B, H, W, K] simplexes -> the loss, or
    (loss, joint [K, K]) with ``return_joint``; the joint over the ranks of
    a data-parallel ``group`` (losses/discrete_mi.py)."""
    k = x_out.shape[-1]
    p_i_j = compute_joint_2d_with_padding_zeros(x_out, x_tf_out, symmetric=symmetric,
                                                group=group).reshape(k, k)
    eye = torch.eye(k, dtype=p_i_j.dtype, device=p_i_j.device)
    target = (eye / k) * alpha + p_i_j * (1.0 - alpha)
    p_i = p_i_j.sum(1, keepdim=True)
    p_j = p_i_j.sum(0, keepdim=True)
    constrained = (-p_i_j * (-lamda * torch.log(p_j + eps)
                             - lamda * torch.log(p_i + eps))).sum()
    loss = -(target * torch.log(p_i_j + eps)).sum() + constrained
    return (loss, p_i_j) if return_joint else loss


class RedundancyCriterion:
    def __init__(self, *, alpha: float, lamda: float = 1.0, eps: float = 1e-5,
                 symmetric: bool = True):
        self._kw = dict(alpha=alpha, lamda=lamda, eps=eps, symmetric=symmetric)

    def __call__(self, x_out: torch.Tensor, x_tf_out: torch.Tensor) -> torch.Tensor:
        return redundancy_criterion(x_out, x_tf_out, **self._kw)
