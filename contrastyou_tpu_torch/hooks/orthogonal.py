"""Prototype orthogonality (counterpart of contrastyou_tpu/hooks/orthogonal.py):
the rows of the model's final 1x1 conv (``Deconv_1x1``, [C, Cin]) are the
class prototypes; their cosine matrix is pushed toward the identity. The
weight is read live in the step, so the gradient reaches it."""
from __future__ import annotations

import torch

from ..engine.hooks import StepContext, TrainerHook

__all__ = ["OrthogonalTrainerHook"]


class OrthogonalTrainerHook(TrainerHook):
    requires_unlabeled = False
    #: a value of the replicated weight: every rank computes the whole of it
    #: and the step back-propagates 1/W of it on each
    data_parallel = True

    def __init__(self, *, hook_name: str = "orth", weight: float = 0.0):
        super().__init__(hook_name=hook_name, weight=weight)

    def loss(self, ctx: StepContext, state):
        kernel = ctx.bundle.model._Deconv_1x1.weight                    # [C, Cin, 1, 1]
        protos = kernel.reshape(kernel.shape[0], -1)
        protos = protos / protos.norm(dim=1, keepdim=True).clamp(min=1e-12)
        gram = protos @ protos.T
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        return ((gram - eye) ** 2).mean(), state, {}
