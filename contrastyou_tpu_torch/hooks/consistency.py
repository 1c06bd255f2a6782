"""Consistency regularizer (counterpart of contrastyou_tpu/hooks/consistency.py;
ref semi_seg/hooks/consistency.py): the MSE between softmax(f(T(x))) and
softmax(T(f(x))), with T(f(x)) detached."""
from __future__ import annotations

import torch

from ..engine.hooks import StepContext, TrainerHook

__all__ = ["ConsistencyTrainerHook"]


class ConsistencyTrainerHook(TrainerHook):
    #: a per-pixel mean over this rank's rows (the step takes 1/W of it)
    data_parallel = True
    #: it reads T(f(x)), which the pretrain step builds for such hooks
    reads_logits_tf = True

    def __init__(self, name: str = "consistency", weight: float = 1.0):
        super().__init__(hook_name=name, weight=weight)

    def loss(self, ctx: StepContext, state):
        prob_tf = torch.softmax(ctx.unlabeled_logits_tf, -1).detach()   # T(f(x))
        tf_prob = torch.softmax(ctx.unlabeled_tf_logits, -1)             # f(T(x))
        return torch.mean((prob_tf - tf_prob) ** 2), state, {}
