"""InfoNCE contrastive hook (counterpart of contrastyou_tpu/hooks/infonce.py):
tap a named layer on both views, align the first view's features with the
batch transform, project and L2-normalize, and take the SupCon loss over the
positive pairs ``contrast_on`` defines. An encoder hook pools its tap to one
vector per image; a decoder (dense) hook projects to a grid and samples
``engine.steps.POINT_NUMS`` positions per image, the same positions in both
views, each its own positive pair.

The positions are explicit draws (``ctx.point_draws``, one
``engine.steps.draw_points`` per grid, shared by the hooks on it), so a test
can replay the JAX hook's. With ``emit_figures`` the eager SupCon's
similarity logits and positive mask are computed beside the loss, without
gradient, and go out as ``fig/sim_logits`` and ``fig/pos_mask`` (logged by
the trainer as figures); the loss keeps its route (D1/D2 on the card).
:class:`SelfPacedINFONCEHook` weights the pairs by
the self-paced loss, its age parameter ramped with the epoch;
:class:`SuperPixelInfoNCEHook` (dense only) labels each sampled position with
the superpixel id that holds most of its feature cell
(:func:`majority_pool_labels`), so positions of one superpixel, in any image
of the batch, are positives.

Data parallelism (``ctx.data_group`` of W > 1 ranks): every hook gathers
its anchors (the pooled rows, or the sampled points) of both views and their
labels over the ranks in rank order, which is the one-process order since
both are image-major, and computes the whole global loss on every rank
(the step back-propagates 1/W of it). The self-paced weights, their mean
and the ``correct_grad`` divisor then span the global positive pairs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..engine.hooks import ModuleHook, StepContext
from ..losses.contrastive import self_paced_sup_con_loss, sup_con_figures, sup_con_loss
from ..models.projectors import DenseProjectionHead, ProjectionHead
from ..models.unet import UNet
from ..parallel.collectives import gather_rows

__all__ = ["TEMPERATURE", "contrast_labels", "majority_pool_labels", "sample_points",
           "INFONCEHook", "SelfPacedINFONCEHook", "SuperPixelInfoNCEHook"]

ENCODER_NAMES = UNet.encoder_names
#: the SupCon temperature
TEMPERATURE = 0.07


def contrast_labels(ctx: StepContext, contrast_on: str) -> Optional[torch.Tensor]:
    """Integer labels of the positive pairs; None = identity (SimCLR)."""
    if contrast_on == "partition":
        return ctx.partition_group
    if contrast_on == "patient":
        return ctx.patient_group
    if contrast_on == "cycle":
        return ctx.cycle_group
    if contrast_on == "self":
        return None
    raise NotImplementedError(contrast_on)


def majority_pool_labels(ids: torch.Tensor, fh: int, fw: int, *,
                         num_ids: int = 256) -> torch.Tensor:
    """Integer id map [B, H, W] -> [B, fh, fw] long: each cell of the
    feature grid takes the id most frequent in its window of ``H // fh`` x
    ``W // fw`` pixels (rows and columns past ``fh`` / ``fw`` windows are
    left out), the smallest id on a tie; ids outside ``[0, num_ids)`` are
    not counted (a cell without any counts 0). One histogram per cell,
    counted by ``scatter_add`` over ``cell * num_ids + id``, not JAX's
    one-hot [B, fh, ph, fw, pw, num_ids] tensor."""
    B, H, W = ids.shape
    ph, pw = max(H // fh, 1), max(W // fw, 1)
    r = ids[:, :fh * ph, :fw * pw].long()
    dev = ids.device
    cell = ((torch.arange(B, device=dev)[:, None, None] * fh
             + torch.arange(fh * ph, device=dev)[None, :, None] // ph) * fw
            + torch.arange(fw * pw, device=dev)[None, None, :] // pw)
    valid = (r >= 0) & (r < num_ids)
    counts = torch.zeros(B * fh * fw * num_ids, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, (cell * num_ids + r.clamp(0, num_ids - 1)).reshape(-1),
                        valid.reshape(-1).int())
    # argmax returns the first of equal maxima: the smallest id, as jnp.argmax
    return counts.view(B, fh, fw, num_ids).argmax(-1)


def sample_points(features: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Features [B, H, W, D] at positions ``ys``/``xs`` [B, P] -> [B*P, D]."""
    B, P = ys.shape
    b = torch.arange(B, device=features.device)[:, None]
    return features[b, ys, xs].reshape(B * P, features.shape[-1])


class INFONCEHook(ModuleHook):
    """``in_dim``: channels of the tapped layer. ``proj_bf16``: a dense hook
    on a bf16 model runs its projection head's 1x1 convs in bf16 with the
    pool before the output conv (the JAX accelerator defaults)."""

    data_parallel = True

    def __init__(self, *, name: str, feature_name: str, in_dim: int,
                 weight: float = 1.0, spatial_size: Optional[Sequence[int]] = None,
                 contrast_on: str = "partition", proj_bf16: bool = False,
                 emit_figures: bool = False):
        super().__init__(hook_name=name, weight=weight)
        self._emit_figures = bool(emit_figures)
        self._feature_name = feature_name
        self.taps = (feature_name,)
        self._is_encoder = feature_name in ENCODER_NAMES
        self._contrast_on = contrast_on
        if self._is_encoder:
            if spatial_size is not None and tuple(spatial_size) != (1, 1):
                raise ValueError(f"encoder hook {name}: spatial_size must be (1, 1)")
            self.grid = None
            self.projector = ProjectionHead(in_dim)
        else:
            if spatial_size is None:
                raise ValueError(f"decoder hook {name} needs a spatial_size")
            self.grid = tuple(spatial_size)
            self.projector = DenseProjectionHead(in_dim, spatial_size=self.grid,
                                                 bf16=proj_bf16)

    def _projected_pair(self, ctx: StepContext):
        feat = ctx.unlabeled_taps[self._feature_name]
        feat_tf = ctx.unlabeled_tf_taps[self._feature_name]
        # a dense tap of a bf16 model is an exact f32 upcast of bf16: the
        # nearest-neighbour alignment selects values, so it rides bf16 exactly
        # at half the traffic (JAX NCE_BF16)
        mdt = getattr(getattr(ctx.bundle, "model", None), "dtype", None)
        if mdt == torch.bfloat16 and feat.dtype == torch.float32 and not self._is_encoder:
            feat, feat_tf = feat.to(mdt), feat_tf.to(mdt)
        both = torch.cat([ctx.affine_transformer(feat), feat_tf], 0)
        proj = self.projector(both)
        B = feat.shape[0]
        return proj[:B], proj[B:]

    def _points(self, ctx: StepContext):
        """This hook's grid's sampled positions (ys, xs) [B, P]."""
        if self.grid not in ctx.point_draws:
            raise KeyError(f"{self.name}: no point draws for grid {self.grid} in the step")
        return ctx.point_draws[self.grid]

    @staticmethod
    def _global(ctx: StepContext, f1, f2, labels):
        """The global batch's anchors and labels on a data-parallel rank: the
        ranks' rows in rank order, the one-process order (all of f1, then
        all of f2, in the loss), as JAX's sharded step sees them."""
        group = ctx.data_group
        if group is None:
            return f1, f2, labels
        return (gather_rows(f1, group), gather_rows(f2, group),
                None if labels is None else gather_rows(labels, group))

    def _pairs_and_labels(self, ctx: StepContext):
        f1, f2 = self._projected_pair(ctx)
        if self._is_encoder:
            return self._global(ctx, f1, f2, contrast_labels(ctx, self._contrast_on))
        ys, xs = self._points(ctx)
        # each point its own positive (SimCLR labels)
        return self._global(ctx, sample_points(f1, ys, xs), sample_points(f2, ys, xs), None)

    def loss(self, ctx: StepContext, state):
        f1, f2, labels = self._pairs_and_labels(ctx)
        loss = sup_con_loss(f1, f2, target=labels, temperature=TEMPERATURE)
        if not self._emit_figures:
            return loss, state, {}
        # JAX infonce.py:158-166 takes these from the loss's auxiliaries; the
        # fused route has none, so they are computed beside it
        sim_logits, pos_mask = sup_con_figures(f1, f2, target=labels, temperature=TEMPERATURE)
        return loss, state, {"fig/sim_logits": sim_logits, "fig/pos_mask": pos_mask}


class SelfPacedINFONCEHook(INFONCEHook):
    """InfoNCE under the self-paced loss (``mode`` ``hard`` or ``soft``
    weights), its age parameter ``gamma = begin + (end - begin) * (epoch /
    max_epoch) ** p`` in f32, as JAX computes it. Metrics ``sp_weight`` (the
    mean weight over the positive pairs) and ``age_param`` (gamma)."""

    def __init__(self, *, name: str, feature_name: str, in_dim: int, weight: float = 1.0,
                 spatial_size: Optional[Sequence[int]] = None, contrast_on: str = "partition",
                 mode: str = "soft", p: float = 0.5, begin_value: float = 1e6,
                 end_value: float = 1e6, correct_grad: bool = False, max_epoch: int = 100,
                 proj_bf16: bool = False):
        super().__init__(name=name, feature_name=feature_name, in_dim=in_dim, weight=weight,
                         spatial_size=spatial_size, contrast_on=contrast_on,
                         proj_bf16=proj_bf16)
        if mode not in ("hard", "soft"):
            raise ValueError(f"{name}: mode {mode!r}, hard or soft")
        self._mode = mode
        self._p = float(p)
        self._begin, self._end = float(begin_value), float(end_value)
        self._correct_grad = bool(correct_grad)
        self._max_epoch = int(max_epoch)

    def gamma(self, epoch: int, device=None) -> torch.Tensor:
        """The age parameter of ``epoch``, an f32 scalar."""
        ramp = (torch.full((), epoch, dtype=torch.float32, device=device)
                / self._max_epoch) ** self._p
        return self._begin + (self._end - self._begin) * ramp

    def loss(self, ctx: StepContext, state):
        f1, f2, labels = self._pairs_and_labels(ctx)
        gamma = self.gamma(ctx.epoch, f1.device)
        loss, metrics = self_paced_sup_con_loss(
            f1, f2, target=labels, gamma=gamma, temperature=TEMPERATURE,
            weight_update=self._mode, correct_grad=self._correct_grad)
        return loss, state, {"sp_weight": metrics["downgrade_ratio"], "age_param": gamma}


class SuperPixelInfoNCEHook(INFONCEHook):
    """Dense InfoNCE whose positives are the sampled positions of one
    superpixel: the batch's superpixel map (``ctx.superpixel``, the
    ``acdc_superpixel`` dataset's ``superpixel`` folder) is warped by the
    batch transform (nearest), pooled to the projected grid by
    :func:`majority_pool_labels` and read at the shared point draws."""

    needs_superpixel = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self._is_encoder:
            raise ValueError(f"{self.name}: superpixel InfoNCE needs decoder features")

    def loss(self, ctx: StepContext, state):
        if ctx.superpixel is None:
            raise ValueError(f"{self.name}: the batch has no 'superpixel' map; use the "
                             f"acdc_superpixel dataset")
        f1, f2 = self._projected_pair(ctx)
        ys, xs = self._points(ctx)
        sp_tf = ctx.affine_transformer(ctx.superpixel.float()[..., None], order=0)
        pooled = majority_pool_labels(sp_tf[..., 0].long(), f1.shape[1], f1.shape[2])
        labels = sample_points(pooled[..., None], ys, xs)[:, 0]
        f1, f2, labels = self._global(ctx, sample_points(f1, ys, xs), sample_points(f2, ys, xs),
                                      labels)
        return sup_con_loss(f1, f2, target=labels, temperature=TEMPERATURE), state, {}
