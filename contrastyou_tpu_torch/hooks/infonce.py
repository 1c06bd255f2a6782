"""InfoNCE contrastive hook (counterpart of contrastyou_tpu/hooks/infonce.py):
tap a named layer on both views, align the first view's features with the
batch transform, project and L2-normalize, and take the SupCon loss over the
positive pairs ``contrast_on`` defines. An encoder hook pools its tap to one
vector per image; a decoder (dense) hook projects to a grid and samples
:data:`POINT_NUMS` positions per image, the same positions in both views,
each its own positive pair.

The positions are explicit draws (``ctx.point_draws``, :func:`draw_points`),
so a test can replay the JAX hook's. The self-paced and superpixel variants
are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..engine.hooks import ModuleHook, StepContext
from ..losses.contrastive import sup_con_loss
from ..models.projectors import DenseProjectionHead, ProjectionHead
from ..models.unet import UNet

__all__ = ["POINT_NUMS", "TEMPERATURE", "contrast_labels", "sample_points", "draw_points",
           "INFONCEHook"]

ENCODER_NAMES = UNet.encoder_names
#: positions a dense hook samples per image, and the SupCon temperature
POINT_NUMS = 5
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


def sample_points(features: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Features [B, H, W, D] at positions ``ys``/``xs`` [B, P] -> [B*P, D]."""
    B, P = ys.shape
    b = torch.arange(B, device=features.device)[:, None]
    return features[b, ys, xs].reshape(B * P, features.shape[-1])


def draw_points(generator: torch.Generator, batch: int,
                grid: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image, :data:`POINT_NUMS` distinct rows and distinct columns of the
    ``grid`` -> (ys, xs) [batch, POINT_NUMS] long, on the generator's device."""
    dev = generator.device

    def distinct(n):
        return torch.rand(batch, n, generator=generator, device=dev).argsort(1)[:, :POINT_NUMS]

    return distinct(grid[0]), distinct(grid[1])


class INFONCEHook(ModuleHook):
    """``in_dim``: channels of the tapped layer. ``proj_bf16``: a dense hook
    on a bf16 model runs its projection head's 1x1 convs in bf16 with the
    pool before the output conv (the JAX accelerator defaults)."""

    def __init__(self, *, name: str, feature_name: str, in_dim: int,
                 weight: float = 1.0, spatial_size: Optional[Sequence[int]] = None,
                 contrast_on: str = "partition", proj_bf16: bool = False):
        super().__init__(hook_name=name, weight=weight)
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

    def loss(self, ctx: StepContext, state):
        f1, f2 = self._projected_pair(ctx)
        if self._is_encoder:
            labels = contrast_labels(ctx, self._contrast_on)
        else:
            ys, xs = ctx.point_draws[self.grid]
            f1, f2 = sample_points(f1, ys, xs), sample_points(f2, ys, xs)
            labels = None
        return sup_con_loss(f1, f2, target=labels, temperature=TEMPERATURE), state, {}
