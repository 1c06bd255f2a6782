"""Hook protocol for semi-supervised regularizers (counterpart of
contrastyou_tpu/engine/hooks.py).

A hook contributes ``loss(ctx, state) -> (loss, new_state, metrics)``
inside the differentiated step, and ``post_step(ctx, model, state) -> state``
after the optimizer update. :class:`StepContext` carries what the step
computed: both unlabeled logits views, the explicit transform, taps.
A :class:`ModuleHook` owns parameters (a projection head): it is an
``nn.Module`` whose parameters join the optimizer beside the model's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..ops.affine import GeoParams, transform_logits

__all__ = ["StepContext", "TrainerHook", "ModuleHook", "hook_parameters",
           "combined_taps", "check_hook_names"]


@dataclass
class StepContext:
    # labeled branch
    labeled_image: Optional[torch.Tensor] = None
    labeled_target: Optional[torch.Tensor] = None          # int [B, H, W]
    labeled_logits: Optional[torch.Tensor] = None
    labeled_taps: Dict[str, torch.Tensor] = field(default_factory=dict)
    # unlabeled branch (two views)
    unlabeled_image: Optional[torch.Tensor] = None
    unlabeled_image_tf: Optional[torch.Tensor] = None
    unlabeled_logits: Optional[torch.Tensor] = None        # f(x)
    unlabeled_tf_logits: Optional[torch.Tensor] = None     # f(T(x))
    unlabeled_logits_tf: Optional[torch.Tensor] = None     # T(f(x))
    unlabeled_taps: Dict[str, torch.Tensor] = field(default_factory=dict)
    unlabeled_tf_taps: Dict[str, torch.Tensor] = field(default_factory=dict)
    # grouping labels for contrastive objectives
    label_group: Optional[torch.Tensor] = None
    partition_group: Optional[torch.Tensor] = None
    patient_group: Optional[torch.Tensor] = None
    cycle_group: Optional[torch.Tensor] = None
    # the explicit transform
    geo_params: Optional[GeoParams] = None
    # sampled feature positions of the dense hooks: (H, W) -> (ys, xs) [B, P]
    point_draws: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)
    epoch: int = 0
    bundle: Any = None

    def affine_transformer(self, feature: torch.Tensor, *, order: int = 0) -> torch.Tensor:
        """The batch transform applied to an NHWC feature map (normalized
        coordinates, so any resolution)."""
        return transform_logits(feature, self.geo_params, order=order)


class TrainerHook:
    """Base hook; subclasses override the pieces they need."""

    #: layer names this hook needs from the model forward
    taps: Tuple[str, ...] = ()

    def __init__(self, *, hook_name: str, weight: float = 1.0):
        self.name = hook_name
        self.weight = float(weight)

    def init_state(self, bundle) -> Any:
        return {}

    def loss(self, ctx: StepContext, state: Any
             ) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
        return ctx.labeled_logits.new_zeros(()), state, {}

    def post_step(self, ctx: StepContext, model: torch.nn.Module, state: Any) -> Any:
        return state


class ModuleHook(torch.nn.Module, TrainerHook):
    """A hook with parameters: its ``parameters()`` join the optimizer."""

    def __init__(self, *, hook_name: str, weight: float = 1.0):
        torch.nn.Module.__init__(self)
        TrainerHook.__init__(self, hook_name=hook_name, weight=weight)


def hook_parameters(hooks: Sequence[TrainerHook]) -> list:
    """Parameters of every :class:`ModuleHook` in ``hooks``."""
    return [p for h in hooks if isinstance(h, torch.nn.Module) for p in h.parameters()]


def combined_taps(hooks: Sequence[TrainerHook]) -> Tuple[str, ...]:
    seen: list = []
    for h in hooks:
        for t in h.taps:
            if t not in seen:
                seen.append(t)
    return tuple(seen)


def check_hook_names(hooks: Sequence[TrainerHook]) -> None:
    names = [h.name for h in hooks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate hook names: {names}")
