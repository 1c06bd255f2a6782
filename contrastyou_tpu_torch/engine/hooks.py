"""Hook protocol for semi-supervised regularizers (counterpart of
contrastyou_tpu/engine/hooks.py).

A hook contributes ``loss(ctx, state) -> (loss, new_state, metrics)``
inside the differentiated step, ``post_step(ctx, model, state) -> state``
after the optimizer update, and ``on_epoch_start(state, epoch) -> state``.
:class:`StepContext` carries what the step computed: both unlabeled logits
views, the explicit transform, taps, the unlabeled batch's superpixel map
(when the dataset has one), the dense hooks' sampled positions
(``point_draws``), and the hook's own random draws
(``draw``, made before the step; ``ctx.hook_draws[name]``) and, in a
data-parallel step, the group (``data_group``). A hook may
offer an eval model (``eval_params`` / ``eval_batch_stats``: a teacher or
an EMA of the student); ``always_active`` hooks run under trainers that
drop the others (``ft``).
A :class:`ModuleHook` owns parameters (a projection head, the DAE's conv):
it is an ``nn.Module`` whose parameters join the optimizer beside the
model's.
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
    # the unlabeled batch's superpixel id map [B, H, W] (acdc_superpixel), if any
    superpixel: Optional[torch.Tensor] = None
    # the explicit transform
    geo_params: Optional[GeoParams] = None
    # sampled feature positions of the dense hooks: (H, W) -> (ys, xs) [B, P]
    point_draws: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)
    # each drawing hook's random draws, by hook name
    hook_draws: Dict[str, Any] = field(default_factory=dict)
    epoch: int = 0
    bundle: Any = None
    # the data-parallel group of W > 1 ranks the step runs over (None: one
    # process); the batch above is this rank's rows of the global batch
    data_group: Any = None

    def affine_transformer(self, feature: torch.Tensor, *, order: int = 0) -> torch.Tensor:
        """The batch transform applied to an NHWC feature map (normalized
        coordinates, so any resolution)."""
        return transform_logits(feature, self.geo_params, order=order)


class TrainerHook:
    """Base hook; subclasses override the pieces they need."""

    #: layer names this hook needs from the model forward
    taps: Tuple[str, ...] = ()
    #: whether the hook needs the unlabeled branch
    requires_unlabeled: bool = True
    #: kept by trainers that drop the regularizer hooks (a loss-free EMA)
    always_active: bool = False
    #: whether the hook reads the unlabeled batch's superpixel map, which
    #: only the host-fed loop carries
    needs_superpixel: bool = False
    #: the feature grid a dense hook samples positions on (the step draws
    #: them, one draw per grid); None for a hook that samples none
    grid: Optional[Tuple[int, int]] = None
    #: whether the hook runs in a data-parallel step: its loss is a mean
    #: over this rank's rows, or a value of the global batch (either way the
    #: step back-propagates 1/W of it), and it reduces nothing else over the
    #: batch; a hook without it raises there
    data_parallel: bool = False
    #: the batch axis of the hook's :meth:`draw`, along which a data-parallel
    #: step cuts it to this rank's rows (``parallel.shard_batch``); None
    #: keeps the draw whole on every rank (a draw over the global batch that
    #: the hook reads whole, as ICT's permutation); a tuple gives each part
    #: of a tuple draw its own axis or None (``engine.steps.shard_draw``)
    draw_batch_dim: Any = 0
    #: whether the hook reads the aligned first view T(f(x)), which the
    #: pretrain step builds only for such hooks
    reads_logits_tf: bool = False

    def __init__(self, *, hook_name: str, weight: float = 1.0):
        self.name = hook_name
        self.weight = float(weight)

    def init_state(self, bundle) -> Any:
        return {}

    def draw(self, generator: torch.Generator, host_rng, shape: Tuple[int, ...]) -> Any:
        """This hook's random draws for one step whose unlabeled batch has
        ``shape``, from the step's ``generator`` (on its device) or the
        numpy ``host_rng``; None (the default) draws nothing and leaves both
        generators as they were."""
        return None

    def loss(self, ctx: StepContext, state: Any
             ) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
        ref = ctx.labeled_logits if ctx.labeled_logits is not None else ctx.unlabeled_logits
        return ref.new_zeros(()), state, {}

    def post_step(self, ctx: StepContext, model: torch.nn.Module, state: Any) -> Any:
        return state

    def on_epoch_start(self, state: Any, epoch: int) -> Any:
        return state

    def eval_params(self, state: Any) -> Optional[Dict[str, torch.Tensor]]:
        """Parameters to evaluate with in place of the student's (keyed as
        ``named_parameters``), or None."""
        return None

    def eval_batch_stats(self, state: Any) -> Optional[Dict[str, torch.Tensor]]:
        """BN running statistics to go with :meth:`eval_params` (keyed as
        ``named_buffers``), or None for the student's."""
        return None


class ModuleHook(torch.nn.Module, TrainerHook):
    """A hook with parameters: its ``parameters()`` join the optimizer."""

    def __init__(self, *, hook_name: str, weight: float = 1.0):
        torch.nn.Module.__init__(self)
        TrainerHook.__init__(self, hook_name=hook_name, weight=weight)
        #: the hook's head (a subclass sets it), or None
        self.projector: Optional[torch.nn.Module] = None

    def init_weights(self, generator: torch.Generator) -> "ModuleHook":
        """Random weights of the hook's ``projector``, if any, from
        ``generator``."""
        if self.projector is not None:
            self.projector.init_weights(generator)
        return self


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
