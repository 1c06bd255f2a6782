"""Entropy minimization on the aligned unlabeled prediction (counterpart of
contrastyou_tpu/hooks/entmin.py): the mean entropy of softmax(T(f(x)))."""
from __future__ import annotations

import torch

from ..engine.hooks import StepContext, TrainerHook
from ..losses.kl import entropy_loss

__all__ = ["EntropyMinTrainerHook"]


class EntropyMinTrainerHook(TrainerHook):
    #: a per-pixel mean over this rank's rows
    data_parallel = True

    def __init__(self, name: str = "entmin", weight: float = 1.0):
        super().__init__(hook_name=name, weight=weight)

    def loss(self, ctx: StepContext, state):
        return entropy_loss(torch.softmax(ctx.unlabeled_logits_tf, -1)), state, {}
