"""Supervised-contrastive (InfoNCE) loss (counterpart of
contrastyou_tpu/losses/contrastive.py).

``sup_con_loss`` builds the [2N, 2N] positive / negative masks of two views
from integer labels (identity masks for SimCLR) and computes either the eager
form (one similarity matrix, global-max stabiliser, plain torch, as in JAX) or
the fused form (kernels D1/D2 of ``ops/supcon.py``). The gate has JAX's
shape (``losses/contrastive.py:83-89``: the fused form for accelerator
tensors with at most a set number of anchors and neither ``return_aux`` nor
``exclude_other_pos``), but its number, :data:`FUSED_MAX_ANCHORS`, comes
from the card, not from the TPU. The self-paced variant is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.supcon import MAX_ANCHORS, pair_code, sup_con_from_code

__all__ = ["pair_masks_from_target", "FUSED_MAX_ANCHORS", "fused_route",
           "sup_con_loss"]

#: anchor counts (2N) up to this take the fused kernels on the card: their
#: capacity, since chip_smoke.py's sweep (phase 4b: value and gradient, d =
#: 256, partition and self masks, 2N = 36 to 4096) found the fused form no
#: slower than the eager one, in wall time and in device time, at every
#: measured size (NVIDIA H100, PERF.md). JAX's 256 was a TPU measurement.
FUSED_MAX_ANCHORS = MAX_ANCHORS


def pair_masks_from_target(target: Optional[torch.Tensor], batch_size: int, *,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_mask, neg_mask) [N, N] f32 from integer labels; identity masks
    when ``target`` is None (SimCLR)."""
    if target is None:
        pos = torch.eye(batch_size, dtype=torch.float32, device=device)
        return pos, 1.0 - pos
    eq = target[:, None] == target[None, :]
    return eq.float(), (~eq).float()


def _expand_masks(pos_mask: torch.Tensor, neg_mask: torch.Tensor, n: int):
    off_diag = 1.0 - torch.eye(2 * n, dtype=pos_mask.dtype, device=pos_mask.device)
    return pos_mask.repeat(2, 2) * off_diag, neg_mask.repeat(2, 2) * off_diag


def fused_route(anchors: int, device, *, return_aux: bool = False,
                exclude_other_pos: bool = False) -> bool:
    """Whether :func:`sup_con_loss` takes the fused kernels by default."""
    return (anchors <= FUSED_MAX_ANCHORS and not return_aux
            and not exclude_other_pos and torch.device(device).type == "cuda")


def sup_con_loss(proj_feat1: torch.Tensor, proj_feat2: torch.Tensor, *,
                 target: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 temperature: float = 0.07, exclude_other_pos: bool = False,
                 return_aux: bool = False, fused: Optional[bool] = None):
    """proj_feat{1,2}: [N, d], L2-normalized. Returns the scalar loss (and an
    aux dict when ``return_aux``). ``fused`` None follows
    :func:`fused_route`; True takes the fused function on any device (its
    plain versions on the CPU)."""
    n = proj_feat1.shape[0]
    if mask is not None:
        pos_mask, neg_mask = (mask == 1).float(), (mask == 0).float()
    else:
        pos_mask, neg_mask = pair_masks_from_target(target, n, device=proj_feat1.device)
    z = torch.cat([proj_feat1, proj_feat2], 0)

    if fused is None:
        fused = fused_route(2 * n, proj_feat1.device, return_aux=return_aux,
                            exclude_other_pos=exclude_other_pos)
    if fused:
        # the [2N, 2N] pair code straight from the [N, N] masks: one byte a
        # pair, no [2N, 2N] float mask
        code = pair_code(pos_mask, neg_mask).repeat(2, 2)
        code.fill_diagonal_(0)
        return sup_con_from_code(z, code, temperature)

    pos_mask, neg_mask = _expand_masks(pos_mask, neg_mask, n)
    sim_logits = (z @ z.T) / temperature
    sim_logits = sim_logits - sim_logits.max().detach()
    sim_exp = torch.exp(sim_logits)
    pos_count = pos_mask.sum(1)
    neg_count = neg_mask.sum(1)
    pos_sum = (sim_exp * pos_mask).sum(1, keepdim=True)
    neg_sum = (sim_exp * neg_mask).sum(1, keepdim=True)
    if exclude_other_pos:
        neg_ratio = neg_count / (pos_count + neg_count)
        log_frac = sim_logits - torch.log(
            sim_exp + neg_sum / (neg_ratio + 1e-4)[:, None] + 1e-16)
    else:
        log_frac = sim_logits - torch.log(pos_sum + neg_sum + 1e-16)
    per_anchor = (log_frac * pos_mask).sum(1) / torch.clamp(pos_count, min=1.0)
    loss = -per_anchor.mean()
    if return_aux:
        return loss, {"sim_logits": sim_logits, "sim_exp": sim_exp,
                      "pos_mask": pos_mask, "neg_mask": neg_mask}
    return loss
