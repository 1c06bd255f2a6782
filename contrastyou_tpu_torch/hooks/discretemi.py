"""Discrete-MI hooks on intermediate features (counterpart of
contrastyou_tpu/hooks/discretemi.py): tap a named layer on both views, align
the first view's features with the batch transform, project through a
linear cluster head of S subheads (a ``ClusterHead`` on an encoder layer, a
``DenseClusterHead`` on a decoder layer) and maximize the IIC mutual
information between the two views' cluster distributions, averaged over the
subheads. The IMSAT variant takes IMSAT on each view plus an MSE consistency
between them.

A dense hook's joints come from ``ops/iic.py`` (kernels E1/E2 on the card):
the probability maps are never formed. On a bf16 model its taps (exact f32
upcasts of bf16 activations) are cast back to bf16 before the nearest-
neighbour alignment, which selects values and so loses nothing; E1/E2 read
bf16 and compute in f32 (the JAX accelerator default, ``IIC_BF16``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..engine.hooks import ModuleHook, StepContext
from ..losses.discrete_mi import iid_loss, iid_loss_from_raw_joints, imsat_loss
from ..models.projectors import ClusterHead, DenseClusterHead
from ..models.unet import UNet
from ..ops.iic import fused_dense_iic_raw_joints

__all__ = ["DiscreteMITrainHook", "DiscreteIMSATTrainHook"]

ENCODER_NAMES = UNet.encoder_names
DECODER_NAMES = UNet.decoder_names


class DiscreteMITrainHook(ModuleHook):
    """``in_dim``: channels of the tapped layer; ``padding``: the dense
    joints' displacement window (decoder layers)."""

    def __init__(self, *, name: str, feature_name: str, in_dim: int, weight: float = 1.0,
                 num_clusters: int = 20, num_subheads: int = 5,
                 padding: Optional[int] = None):
        super().__init__(hook_name=name, weight=weight)
        if feature_name not in ENCODER_NAMES + DECODER_NAMES:
            raise ValueError(f"{name}: unknown layer {feature_name!r}")
        self._feature_name = feature_name
        self.taps = (feature_name,)
        self._is_encoder = feature_name in ENCODER_NAMES
        self._padding = int(padding or 0)
        head = ClusterHead if self._is_encoder else DenseClusterHead
        self.projector = head(in_dim, num_clusters=num_clusters, num_subheads=num_subheads)

    def _paired_probs(self, ctx: StepContext) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (probs of the aligned first view, of the second), each [S, B, ..., K]."""
        feat = ctx.unlabeled_taps[self._feature_name]
        both = torch.cat([ctx.affine_transformer(feat),
                          ctx.unlabeled_tf_taps[self._feature_name]], 0)
        probs = self.projector(both)
        B = feat.shape[0]
        return probs[:, :B], probs[:, B:]

    def _dense_joints(self, ctx: StepContext) -> torch.Tensor:
        feat = ctx.unlabeled_taps[self._feature_name]
        feat_tf = ctx.unlabeled_tf_taps[self._feature_name]
        mdt = getattr(getattr(ctx.bundle, "model", None), "dtype", None)
        if mdt == torch.bfloat16 and feat.dtype == torch.float32 and feat.is_cuda:
            feat, feat_tf = feat.to(mdt), feat_tf.to(mdt)
        head = self.projector
        w, b = head.merged_params()
        return fused_dense_iic_raw_joints(
            w, b, ctx.affine_transformer(feat), feat_tf, num_subheads=head.num_subheads,
            num_clusters=head.num_clusters, padding=self._padding, T=head.T)

    def loss(self, ctx: StepContext, state):
        if self._is_encoder:
            p1, p2 = self._paired_probs(ctx)
            mi = torch.stack([iid_loss(a, b)[0] for a, b in zip(p1, p2)]).mean()
        else:
            raw = self._dense_joints(ctx)
            B, H, W = ctx.unlabeled_taps[self._feature_name].shape[:3]
            mi = iid_loss_from_raw_joints(raw, padding=self._padding, count=B * H * W).mean()
        return mi, state, {"mi": mi}


class DiscreteIMSATTrainHook(DiscreteMITrainHook):
    """IMSAT on each view's cluster distributions, averaged over the
    subheads, plus ``cons_weight`` times the MSE between the views."""

    def __init__(self, *, name: str, feature_name: str, in_dim: int, weight: float = 1.0,
                 num_clusters: int = 20, num_subheads: int = 5, cons_weight: float = 1.0):
        super().__init__(name=name, feature_name=feature_name, in_dim=in_dim, weight=weight,
                         num_clusters=num_clusters, num_subheads=num_subheads)
        self._cons_weight = float(cons_weight)

    def loss(self, ctx: StepContext, state):
        p1, p2 = self._paired_probs(ctx)
        K = p1.shape[-1]
        mi = torch.stack([0.5 * (imsat_loss(a.reshape(-1, K)) + imsat_loss(b.reshape(-1, K)))
                          for a, b in zip(p1, p2)]).mean()
        cons = torch.mean((p1 - p2) ** 2)
        return mi + self._cons_weight * cons, state, {"mi": mi, "cons": cons}
