"""PICA partition-uncertainty losses (counterpart of
contrastyou_tpu/losses/pica.py)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .discrete_mi import compute_joint_2d

__all__ = ["pui_loss", "pui_seg_loss"]


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)


def pui_loss(x: torch.Tensor, y: torch.Tensor, lamda: float = 2.0) -> torch.Tensor:
    """Partition Uncertainty Index over [N, K] assignment simplexes: the
    cross-entropy of the K x K cosine matrix of the cluster columns against
    the identity, plus ``lamda`` times the negative entropy of the mean
    assignment (from log K)."""
    pui = _l2norm(x.T, 1) @ _l2norm(y, 0)
    loss_ce = F.cross_entropy(pui, torch.arange(pui.shape[0], device=pui.device))
    p = x.mean(0)
    loss_ne = math.log(p.shape[0]) + (p * torch.log(p)).sum()
    return loss_ce + lamda * loss_ne


def pui_seg_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamda: float = 2.0,
                 padding: int = 3) -> torch.Tensor:
    """Segmentation PUI over [B, H, W, K] simplexes: the displacement joint's
    mean, its diagonal log-likelihood, plus the balance term."""
    joint = compute_joint_2d(x_out, x_tf_out, symmetric=True, padding=padding)
    p_i_j = joint.mean((0, 1))
    k = p_i_j.shape[0]
    eye = torch.eye(k, dtype=p_i_j.dtype, device=p_i_j.device)
    loss_ce = (-eye * torch.log(p_i_j + 1e-16)).mean()
    p = x_out.reshape(-1, k).mean(0)
    loss_ne = math.log(k) + (p * torch.log(p + 1e-16)).sum()
    return loss_ce + lamda * loss_ne
