"""Naive pseudo-labelling (counterpart of contrastyou_tpu/hooks/pseudolabel.py):
the MSE between softmax(T(f(x))) and the one-hot of its argmax, with no
gradient through the one-hot. On a tie the first class wins, as in
``jnp.argmax``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.hooks import StepContext, TrainerHook

__all__ = ["PseudoLabelTrainerHook"]


class PseudoLabelTrainerHook(TrainerHook):
    #: a per-pixel mean over this rank's rows
    data_parallel = True

    def __init__(self, name: str = "pseudolabel", weight: float = 1.0):
        super().__init__(hook_name=name, weight=weight)

    def loss(self, ctx: StepContext, state):
        prob_tf = torch.softmax(ctx.unlabeled_logits_tf, -1)
        pseudo = F.one_hot(prob_tf.detach().argmax(-1), prob_tf.shape[-1]).to(prob_tf.dtype)
        return torch.mean((prob_tf - pseudo) ** 2), state, {}
