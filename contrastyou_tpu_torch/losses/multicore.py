"""Multi-prototype ("multicore") losses (counterpart of
contrastyou_tpu/losses/multicore.py): each true class owns several
prototype channels, whose probabilities are summed back to the true classes
before supervision and evaluation.

- :func:`scale_grad`: identity forward, gradient times ``scale`` (JAX's
  ``custom_vjp``);
- :class:`MultiCoreKL`: fixed prototype groups, KL on the reduced simplex;
- :func:`adaptive_oversegmented_loss` and :func:`stricter_adaptive_loss`:
  a learned translate matrix from prototypes to classes, passed in as an
  argument.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .discrete_mi import iid_loss
from .kl import entropy_loss, kl_div

__all__ = ["scale_grad", "reduced_simplex_from_groups", "multicore_kl_loss", "MultiCoreKL",
           "adaptive_reduced_simplex", "adaptive_oversegmented_loss",
           "stricter_translate_matrix", "stricter_adaptive_loss"]


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``x`` in the forward; its gradient multiplied by ``scale``."""
    return _ScaleGrad.apply(x, float(scale))


def reduced_simplex_from_groups(predict_simplex: torch.Tensor,
                                groups: Sequence[Sequence[int]]) -> torch.Tensor:
    """Sum the prototype probabilities of each group along the last axis. A
    group of consecutive channels is sliced, so no index tensor goes to the
    device (a CUDA graph of the step could not copy one)."""
    def channels(g):
        g = list(g)
        return slice(g[0], g[0] + len(g)) if g == list(range(g[0], g[0] + len(g))) else g

    return torch.stack([predict_simplex[..., channels(g)].sum(-1) for g in groups], -1)


def multicore_kl_loss(predict_simplex: torch.Tensor, onehot_target: torch.Tensor,
                      groups: Sequence[Sequence[int]]) -> torch.Tensor:
    return kl_div(reduced_simplex_from_groups(predict_simplex, groups), onehot_target)


class MultiCoreKL:
    """KL of the group-reduced simplex against the one-hot true classes."""

    #: a batch mean of a per-pixel term: on W > 1 ranks each rank's mean
    #: over its rows is its share (engine/steps.py ``check_data_parallel``)
    data_parallel = True

    def __init__(self, groups: List[List[int]]):
        self._groups = [list(g) for g in groups]

    @property
    def groups(self) -> List[List[int]]:
        return self._groups

    def reduced_simplex(self, predict_simplex: torch.Tensor) -> torch.Tensor:
        return reduced_simplex_from_groups(predict_simplex, self._groups)

    def __call__(self, predict_simplex, onehot_target):
        return multicore_kl_loss(predict_simplex, onehot_target, self._groups)


def adaptive_reduced_simplex(predict_simplex: torch.Tensor, translate_matrix: torch.Tensor,
                             grad_scale: float = 1.0) -> torch.Tensor:
    """[..., Cin] simplex @ softmax(translate [Cin, Cout], rows)."""
    trans = torch.softmax(translate_matrix, 1)
    return predict_simplex @ scale_grad(trans, grad_scale)


def adaptive_oversegmented_loss(predict_simplex: torch.Tensor, onehot_target: torch.Tensor,
                                translate_matrix: torch.Tensor, *,
                                entropy_decay: float = 1e-3) -> torch.Tensor:
    """KL on the translated simplex plus ``entropy_decay`` times the mean
    entropy of the translate matrix's rows."""
    reduced = adaptive_reduced_simplex(predict_simplex, translate_matrix)
    return (kl_div(reduced, onehot_target)
            + entropy_loss(torch.softmax(translate_matrix, 1)) * entropy_decay)


def stricter_translate_matrix(free_matrix: torch.Tensor, num_classes: int,
                              diag_scale: float = 30.0) -> torch.Tensor:
    """[identity * ``diag_scale``; the learned free rows]."""
    eye = torch.eye(num_classes, dtype=free_matrix.dtype, device=free_matrix.device) * diag_scale
    if free_matrix.shape[0] == 0:
        return eye
    return torch.cat([eye, free_matrix], 0)


def stricter_adaptive_loss(predict_simplex: torch.Tensor, onehot_target: torch.Tensor,
                           free_matrix: torch.Tensor, *, num_classes: int,
                           mi_weight: float = 0.0) -> torch.Tensor:
    """The first ``num_classes`` prototypes pinned to their class; with
    ``mi_weight``, plus that times the IIC loss of the translate matrix's
    softmax with itself."""
    trans = stricter_translate_matrix(free_matrix, num_classes)
    loss = kl_div(adaptive_reduced_simplex(predict_simplex, trans), onehot_target)
    if mi_weight and free_matrix.shape[0] > 0:
        soft = torch.softmax(trans, 1)
        loss = loss + mi_weight * iid_loss(soft, soft)[0]
    return loss
