"""Discrete mutual-information losses: IIC for cluster distributions and for
segmentation maps, and IMSAT (counterpart of contrastyou_tpu/losses/
discrete_mi.py, channels-last tensors).

- ``compute_joint``: the K x K joint of two [N, K] simplexes;
- ``compute_joint_2d``: the displaced spatial joint [T, T, K, K], one
  contraction per displacement of a zero-padded view;
- ``compute_joint_2d_with_padding_zeros``: the zero-displacement joint as one
  flattened product, scaled by 1/N;
- ``iid_loss`` / ``iid_segmentation_loss`` / ``iid_loss_from_raw_joints`` (the
  tail of the dense hook, from the raw joints of ``ops/iic.py``) /
  ``imsat_loss``.

Each keeps the reference's constants: 1e-10 inside ``iid_loss``'s logs, 1e-5
in the segmentation forms, 1e-8 in the entropies, and a stop-gradient on the
joint's minimum in the min-shift normalization.

``group``: a data-parallel group of W > 1 ranks, each holding an equal share
of the batch rows. The batch sums (the joints before any normalization, the
IMSAT marginal) are all-reduced over it, so every rank computes the global
batch's value; the step back-propagates 1/W of it on each rank, and the
all-reduce's backward sums those shares' cotangents. The mean conditional
entropy stays a per-rank mean, whose shares average to the global one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum, num_ranks

__all__ = ["compute_joint", "compute_joint_2d", "compute_joint_2d_with_padding_zeros",
           "iid_loss", "iid_segmentation_loss", "iid_loss_from_raw_joints", "imsat_terms",
           "imsat_loss"]


def compute_joint(x_out: torch.Tensor, x_tf_out: torch.Tensor,
                  symmetric: bool = True, group=None) -> torch.Tensor:
    """[N, K] x [N, K] -> [K, K] normalized joint."""
    p_i_j = all_reduce_sum(x_out.T @ x_tf_out, group)
    if symmetric:
        p_i_j = (p_i_j + p_i_j.T) / 2.0
    return p_i_j / p_i_j.sum()


def _min_shift_normalize(joint: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """[..., T, T, K, K] raw joints -> a distribution: shift by the (detached)
    minimum, normalize each displacement, symmetrize, normalize the whole."""
    joint = joint - joint.min().detach() + 1e-8
    joint = joint / joint.sum((-2, -1), keepdim=True)
    if symmetric:
        joint = (joint + joint.transpose(-2, -1)) / 2.0
    return joint / joint.sum()


def compute_joint_2d(x_out: torch.Tensor, x_tf_out: torch.Tensor, *,
                     symmetric: bool = True, padding: int = 0, group=None) -> torch.Tensor:
    """Spatial joint with a displacement window: [B, H, W, K] inputs ->
    [T, T, K, K], T = 2*padding+1, ``x_out`` zero outside the image."""
    p = int(padding)
    H, W = x_tf_out.shape[1:3]
    xo = F.pad(x_out, (0, 0, p, p, p, p))
    t = 2 * p + 1
    joint = torch.stack([torch.stack([
        torch.einsum("bhwi,bhwj->ij", xo[:, ty:ty + H, tx:tx + W], x_tf_out)
        for tx in range(t)]) for ty in range(t)])
    return _min_shift_normalize(all_reduce_sum(joint, group), symmetric)


def compute_joint_2d_with_padding_zeros(x_out: torch.Tensor, x_tf_out: torch.Tensor, *,
                                        symmetric: bool = True, group=None) -> torch.Tensor:
    """Zero-displacement spatial joint as one flattened product: [B, H, W, K]
    inputs -> [1, 1, K, K], divided by N through the sqrt(N) factors and not
    normalized further (as the reference)."""
    k = x_out.shape[-1]
    a, b = x_out.reshape(-1, k), x_tf_out.reshape(-1, k)
    n = a.shape[0] * num_ranks(group)
    p_i_j = all_reduce_sum((a.T / math.sqrt(n)) @ (b / math.sqrt(n)), group)
    if symmetric:
        p_i_j = (p_i_j + p_i_j.T) / 2.0
    return p_i_j.reshape(1, 1, k, k)


def iid_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, lamb: float = 1.0, group=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IIC clustering loss over [N, K] simplexes -> (loss, loss without
    lamb, joint)."""
    k = x_out.shape[-1]
    p_i_j = compute_joint(x_out, x_tf_out, group=group)
    p_i = p_i_j.sum(1).reshape(k, 1)
    p_j = p_i_j.sum(0).reshape(1, k)

    def mi(lam):
        return (-p_i_j * (torch.log(p_i_j + 1e-10) - lam * torch.log(p_j + 1e-10)
                          - lam * torch.log(p_i + 1e-10))).sum()

    return mi(lamb), mi(1.0), p_i_j


def _joint_loss(p_i_j: torch.Tensor, lamda: float, eps: float, T: int) -> torch.Tensor:
    """Negative MI of a [T, T, K, K] joint, averaged over the displacements."""
    p_i_mat = p_i_j.sum(2, keepdim=True)
    p_j_mat = p_i_j.sum(3, keepdim=True)
    loss = -p_i_j * (torch.log(p_i_j + eps) - lamda * torch.log(p_i_mat + eps)
                     - lamda * torch.log(p_j_mat + eps))
    return loss.sum() / (T * T)


def iid_segmentation_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, *,
                          lamda: float = 1.0, padding: int = 0, eps: float = 1e-5,
                          symmetric: bool = False, mask: Optional[torch.Tensor] = None,
                          group=None) -> torch.Tensor:
    """Spatial IIC over [B, H, W, K] simplexes."""
    if mask is not None:
        x_out, x_tf_out = x_out * mask, x_tf_out * mask
    if padding > 0:
        p_i_j = compute_joint_2d(x_out, x_tf_out, symmetric=symmetric, padding=padding,
                                 group=group)
    else:
        p_i_j = compute_joint_2d_with_padding_zeros(x_out, x_tf_out, symmetric=symmetric,
                                                    group=group)
    return _joint_loss(p_i_j, lamda, eps, 2 * padding + 1)


def iid_loss_from_raw_joints(raw: torch.Tensor, *, padding: int, count: int,
                             lamda: float = 1.0, eps: float = 1e-5,
                             symmetric: bool = False, group=None) -> torch.Tensor:
    """Per-subhead IIC losses [S] from raw displacement joints [S, T, T, K,
    K]; ``count`` = pixel pairs per displacement (B*H*W, this rank's under a
    ``group``), used at padding 0, where the joint is divided by it instead
    of min-shift normalized."""
    T = 2 * padding + 1
    raw, count = all_reduce_sum(raw, group), count * num_ranks(group)
    if padding > 0:
        joints = [_min_shift_normalize(j, symmetric) for j in raw]
    else:
        p_i_j = raw[:, 0, 0] / count
        if symmetric:
            p_i_j = (p_i_j + p_i_j.transpose(1, 2)) / 2.0
        joints = list(p_i_j[:, None, None])
    return torch.stack([_joint_loss(j, lamda, eps, T) for j in joints])


def _row_entropy(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return -(p * torch.log(p + eps)).sum(-1)


def imsat_terms(prediction: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(marginal entropy, mean conditional entropy) of [..., K] simplexes."""
    pred = prediction.reshape(-1, prediction.shape[-1])
    marginal = all_reduce_sum(pred.sum(0), group) / (pred.shape[0] * num_ranks(group))
    return _row_entropy(marginal), _row_entropy(pred).mean()


def imsat_loss(prediction: torch.Tensor, lamda: float = 1.0, group=None) -> torch.Tensor:
    """-MI = mean conditional entropy - lamda * marginal entropy."""
    marginal, conditional = imsat_terms(prediction, group)
    return conditional - lamda * marginal
