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

On W > 1 ranks (``ctx.data_group``) JAX's permutation spans the 2B global
images ``[x_global; T(x)_global]``: each rank gathers the labeled images and
one-hots of both views in that order and mixes only its own rows of the
mixed global batch (``mixup_data(rows=)``), bitwise those of one process;
the mixed forward takes global BatchNorm statistics. The GeoParams are cut
by rows, ``lam`` and the permutation kept whole (``draw_batch_dim``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.hooks import StepContext, TrainerHook
from ..losses.kl import kl_div
from ..ops.affine import apply_geometric, sample_geo_params
from ..parallel.collectives import gather_rows
from .utils import mixup_data, mixup_draw_tensors

__all__ = ["MixUpTrainHook"]

#: Beta(MIX_ALPHA, MIX_ALPHA) draws ``lam``
MIX_ALPHA = 1.0


class MixUpTrainHook(TrainerHook):
    requires_unlabeled = False
    data_parallel = True
    #: ``(geo, lam, perm)``: the GeoParams per row, ``lam`` and the
    #: permutation of the global batch whole
    draw_batch_dim = (0, None, None)

    def __init__(self, *, hook_name: str = "mixup", weight: float = 1.0,
                 enable_bn: bool = True):
        super().__init__(hook_name=hook_name, weight=weight)
        del enable_bn               # parsed; no effect (see the module docstring)

    def draw(self, generator: torch.Generator, host_rng, shape):
        """``(geo, lam, perm)`` for a labeled batch of ``shape``: the second
        view's GeoParams from ``generator``, ``lam`` and a permutation of
        the 2B images from ``host_rng`` (as tensors on the generator's
        device)."""
        if host_rng is None:
            raise ValueError(f"{self.name}: the mixup draws need a host generator")
        geo = sample_geo_params(generator, int(shape[0]))
        return (geo, *mixup_draw_tensors(host_rng, 2 * int(shape[0]), MIX_ALPHA,
                                         generator.device))

    def loss(self, ctx: StepContext, state):
        geo, lam, perm = ctx.hook_draws[self.name]
        image = ctx.labeled_image
        onehot = F.one_hot(ctx.labeled_target.long(), ctx.labeled_logits.shape[-1]).to(image.dtype)
        views = [(image, apply_geometric(image, geo, order=0)),
                 (onehot, apply_geometric(onehot, geo, order=0))]
        group, rows = ctx.data_group, None
        if group is not None:
            # the global batch of both views in the one-process order and
            # this rank's rows of it
            b = image.shape[0]
            B, r = b * group.size, group.rank
            rows = [*range(r * b, (r + 1) * b), *range(B + r * b, B + (r + 1) * b)]
            views = [tuple(gather_rows(v, group) for v in pair) for pair in views]
        mixed_x, mixed_y = mixup_data(torch.cat(views[0], 0), torch.cat(views[1], 0), lam,
                                      perm, rows=rows)
        logits = ctx.bundle.apply_train(mixed_x, update_stats=False)[0]
        return kl_div(torch.softmax(logits, -1), mixed_y), state, {}
