"""Output-space MI hooks (counterpart of contrastyou_tpu/hooks/midl.py): IIC
spatial MI or IMSAT on the prediction softmaxes of the two aligned views,
softmax(f(T(x))) and softmax(T(f(x)))."""
from __future__ import annotations

import torch

from ..engine.hooks import StepContext, TrainerHook
from ..losses.discrete_mi import iid_segmentation_loss, imsat_loss

__all__ = ["IIDSegmentationTrainerHook", "IMSATTrainHook"]


def _view_probs(ctx: StepContext):
    return (torch.softmax(ctx.unlabeled_tf_logits, -1),
            torch.softmax(ctx.unlabeled_logits_tf, -1))


class IIDSegmentationTrainerHook(TrainerHook):
    def __init__(self, *, hook_name: str = "midl_hook", weight: float = 1.0,
                 mi_lambda: float = 1.0):
        super().__init__(hook_name=hook_name, weight=weight)
        self._mi_lambda = float(mi_lambda)

    def loss(self, ctx: StepContext, state):
        p_tf, p_aligned = _view_probs(ctx)
        mi = iid_segmentation_loss(p_tf, p_aligned, padding=0, lamda=self._mi_lambda)
        return mi, state, {"mi": mi}


class IMSATTrainHook(TrainerHook):
    def __init__(self, *, hook_name: str = "imsat", weight: float = 0.1):
        super().__init__(hook_name=hook_name, weight=weight)

    def loss(self, ctx: StepContext, state):
        p_tf, p_aligned = _view_probs(ctx)
        mi = 0.5 * (imsat_loss(p_tf) + imsat_loss(p_aligned))
        return mi, state, {"mi": mi}
