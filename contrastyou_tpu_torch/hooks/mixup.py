"""MixUp on the labeled batch (counterpart of contrastyou_tpu/hooks/mixup.py):
a second labeled view from a fresh transform (nearest-neighbour on the image
and on the one-hot target), the 2B images and targets mixed with one
``lam`` ~ Beta(1, 1) and one permutation, a forward of the mixed batch with
batch statistics that leaves the BN running statistics alone, and the KL
between its softmax and the mixed targets.

The draws are explicit (:meth:`MixUpTrainHook.draw`): the transform from
the step's generator, ``lam`` and the permutation from the host generator,
as ICT's (``hooks/mt.py``).

``enable_bn`` is parsed and has no effect, as in JAX: the mixed forward
never updates the running statistics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.hooks import StepContext, TrainerHook
from ..losses.kl import kl_div
from ..ops.affine import apply_geometric, sample_geo_params
from .utils import draw_mixup, mixup_data

__all__ = ["MixUpTrainHook"]

#: Beta(MIX_ALPHA, MIX_ALPHA) draws ``lam``
MIX_ALPHA = 1.0


class MixUpTrainHook(TrainerHook):
    requires_unlabeled = False

    def __init__(self, *, hook_name: str = "mixup", weight: float = 1.0,
                 enable_bn: bool = True):
        super().__init__(hook_name=hook_name, weight=weight)
        del enable_bn               # parsed; no effect (see the module docstring)

    def draw(self, generator: torch.Generator, host_rng, shape):
        """``(geo, lam, perm)`` for a labeled batch of ``shape``: the second
        view's GeoParams from ``generator``, ``lam`` and a permutation of
        the 2B images from ``host_rng``."""
        if host_rng is None:
            raise ValueError(f"{self.name}: the mixup draws need a host generator")
        geo = sample_geo_params(generator, int(shape[0]))
        return (geo, *draw_mixup(host_rng, 2 * int(shape[0]), MIX_ALPHA))

    def loss(self, ctx: StepContext, state):
        geo, lam, perm = ctx.hook_draws[self.name]
        image = ctx.labeled_image
        onehot = F.one_hot(ctx.labeled_target.long(), ctx.labeled_logits.shape[-1]).to(image.dtype)
        mixed_x, mixed_y = mixup_data(
            torch.cat([image, apply_geometric(image, geo, order=0)], 0),
            torch.cat([onehot, apply_geometric(onehot, geo, order=0)], 0), lam, perm)
        logits = ctx.bundle.apply_train(mixed_x, update_stats=False)[0]
        return kl_div(torch.softmax(logits, -1), mixed_y), state, {}
