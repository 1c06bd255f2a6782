"""The cross-correlation block, a boundary-aware cluster regularizer
(counterpart of contrastyou_tpu/hooks/ccblock.py).

A tapped feature map on both views (the first aligned by the batch
transform) goes through a :class:`CrossCorrelationProjector` (the ``mlp``
form, hidden 64) to per-pixel cluster distributions, or, for
``feature_name`` ``Deconv_1x1``, the two softmaxes of T(f(x)) and f(T(x))
are taken with no projector. Then the "tiny hooks" named in ``hooks`` run on
each subhead's pair and are averaged over the subheads:

- ``cc``: windowed NCC between the transformed image's edge map (normalized
  per slice, to the power ``diff_power``) and the cluster entropy map
  (normalized per slice), in f32, averaged over both views; an image larger
  than the prediction is first resized with an antialiased bilinear filter,
  as ``jax.image.resize`` does when it downscales;
- ``mi``: spatial IIC (``iid_segmentation_loss``, symmetric);
- ``rr``: the redundancy criterion;
- ``imsat``: IMSAT on the first view with a dynamic marginal weight, hook
  state: ``w += (log K - mean marginal entropy) * 0.01`` after each step
  when ``use_dynamic``, with no gradient;
- ``consist``: KL(dist1, dist2) with dist2 detached.

The loss is the weighted sum; each tiny hook's value is a metric under its
name (``imsat_weight`` beside ``imsat``). With ``save: true`` and an ``rr``
tiny hook the metrics also carry ``fig/joint_rr``, the redundancy joint of
the first subhead's pair, which the trainer logs as a figure (JAX
``ccblock.py:147-153``).

On W > 1 ranks (``ctx.data_group``) ``mi``'s and ``rr``'s joints and
``imsat``'s marginal are summed over the ranks, so each rank computes the
global batch's value, and ``imsat_weight`` moves by the global marginal,
the same on every rank; ``cc`` (per-slice normalization, then a mean) and
``consist`` are batch means, whose per-rank shares average to the global
ones.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from ..engine.hooks import ModuleHook, StepContext
from ..losses.cross_correlation import windowed_ncc_loss
from ..losses.discrete_mi import iid_segmentation_loss, imsat_terms
from ..losses.kl import kl_div
from ..losses.redundancy import redundancy_criterion
from ..models.projectors import CrossCorrelationProjector

__all__ = ["edge_map", "norm01_per_slice", "resize_bilinear", "cc_edge_loss",
           "CrossCorrelationHook", "create_cross_correlation_hook"]

TINY_HOOKS = ("cc", "mi", "rr", "imsat", "consist")


def edge_map(image: torch.Tensor) -> torch.Tensor:
    """Roll-difference gradient magnitude along H and W, averaged over
    channels: NHWC -> [B, H, W, 1]."""
    dx = image - torch.roll(image, 1, 1)
    dy = image - torch.roll(image, 1, 2)
    return torch.sqrt(dx ** 2 + dy ** 2).mean(-1, keepdim=True)


def norm01_per_slice(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min + 1e-6) per slice, min and max detached."""
    lo = x.detach().amin((1, 2, 3), keepdim=True)
    hi = x.detach().amax((1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo + 1e-6)


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres, antialiased (the
    triangle filter widened by the scale) when it downscales, as
    ``jax.image.resize(..., "bilinear")``."""
    out = F.interpolate(image.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def cc_edge_loss(image: torch.Tensor, predict_simplex: torch.Tensor, *,
                 kernel_size: int, diff_power: float) -> torch.Tensor:
    """NCC between the normalized image edge map to the power
    ``diff_power`` and the normalized entropy map of ``predict_simplex``
    [B, h, w, K], in f32."""
    image = image.float()
    h, w = predict_simplex.shape[1:3]
    if tuple(image.shape[1:3]) != (h, w):
        image = resize_bilinear(image, (h, w))
    diff_image = norm01_per_slice(edge_map(image)) ** diff_power
    ent = -(predict_simplex * torch.log(predict_simplex + 1e-16)).sum(-1, keepdim=True)
    return windowed_ncc_loss(norm01_per_slice(ent), diff_image, win=(kernel_size, kernel_size))


class CrossCorrelationHook(ModuleHook):
    """``hooks``: tiny hook name -> its parameters (``weight`` and the
    rest, as config/hooks/ccblocks2.yaml). ``in_dim``: channels of the
    tapped layer (ignored on ``Deconv_1x1``)."""

    data_parallel = True

    def __init__(self, *, name: str, feature_name: str, in_dim: int, num_clusters: int = 20,
                 head_type: str = "mlp", num_subheads: int = 1,
                 hooks: Mapping[str, Mapping], save: bool = False):
        super().__init__(hook_name=name, weight=1.0)
        self._save = bool(save)
        unknown = sorted(set(hooks) - set(TINY_HOOKS))
        if unknown:
            raise ValueError(f"{name}: unknown tiny hooks {unknown}, known {TINY_HOOKS}")
        self._feature_name = feature_name
        self._on_logits = feature_name == "Deconv_1x1"
        self.taps = () if self._on_logits else (feature_name,)
        self.reads_logits_tf = self._on_logits
        self._tiny = {k: dict(v) for k, v in hooks.items()}
        self._num_clusters = int(num_clusters)
        if not self._on_logits:
            self.projector = CrossCorrelationProjector(
                in_dim, num_clusters=self._num_clusters, head_type=head_type,
                num_subheads=int(num_subheads))

    def init_state(self, bundle) -> dict:
        if "imsat" not in self._tiny:
            return {}
        device = next(bundle.model.parameters()).device
        return {"imsat_weight": torch.tensor(float(self._tiny["imsat"].get("lamda", 1.0)),
                                             dtype=torch.float32, device=device)}

    def _distributions(self, ctx: StepContext):
        """-> (dist_tf, tf_dist) [S, B, h, w, K]: the aligned first view's
        and the second view's cluster distributions."""
        if self._on_logits:
            return (torch.softmax(ctx.unlabeled_logits_tf, -1)[None],
                    torch.softmax(ctx.unlabeled_tf_logits, -1)[None])
        feat = ctx.unlabeled_taps[self._feature_name]
        both = torch.cat([ctx.affine_transformer(feat),
                          ctx.unlabeled_tf_taps[self._feature_name]], 0)
        dists = self.projector(both)
        B = feat.shape[0]
        return dists[:, :B], dists[:, B:]

    def loss(self, ctx: StepContext, state):
        dist_tf, tf_dist = self._distributions(ctx)
        pairs = list(zip(dist_tf, tf_dist))

        def per_subhead(fn):
            return torch.stack([fn(d1, d2) for d1, d2 in pairs]).mean()

        total = dist_tf.new_zeros((), dtype=torch.float32)
        metrics: dict = {}
        new_state = dict(state)
        tiny = self._tiny
        group = ctx.data_group
        if "cc" in tiny:
            p = tiny["cc"]
            kw = dict(kernel_size=int(p["kernel_size"]),
                      diff_power=float(p.get("diff_power", 0.75)))
            img = ctx.unlabeled_image_tf
            metrics["cc"] = per_subhead(lambda d1, d2: (cc_edge_loss(img, d1, **kw)
                                                        + cc_edge_loss(img, d2, **kw)) / 2.0)
            total = total + float(p["weight"]) * metrics["cc"]
        if "mi" in tiny:
            p = tiny["mi"]
            metrics["mi"] = per_subhead(lambda d1, d2: iid_segmentation_loss(
                d1, d2, lamda=float(p.get("lamda", 1.0)), padding=int(p.get("padding", 0)),
                symmetric=True, group=group))
            total = total + float(p["weight"]) * metrics["mi"]
        if "rr" in tiny:
            p = tiny["rr"]
            rr_kw = dict(alpha=float(p["alpha"]), lamda=float(p.get("lamda", 1.0)),
                         symmetric=bool(p.get("symmetric", True)), group=group)
            metrics["rr"] = per_subhead(lambda d1, d2: redundancy_criterion(d1, d2, **rr_kw))
            total = total + float(p["weight"]) * metrics["rr"]
            if self._save:
                with torch.no_grad():
                    _, metrics["fig/joint_rr"] = redundancy_criterion(
                        dist_tf[0], tf_dist[0], return_joint=True, **rr_kw)
        if "imsat" in tiny:
            p = tiny["imsat"]
            w = state["imsat_weight"]
            terms = [imsat_terms(d1, group) for d1, _ in pairs]
            metrics["imsat"] = torch.stack([cond - w * marg for marg, cond in terms]).mean()
            metrics["imsat_weight"] = w
            total = total + float(p["weight"]) * metrics["imsat"]
            if bool(p.get("use_dynamic", True)):
                K = self._num_clusters if not self._on_logits else dist_tf.shape[-1]
                marg = torch.stack([m for m, _ in terms]).mean().detach()
                new_state["imsat_weight"] = w + (math.log(K) - marg) * 0.01
        if "consist" in tiny:
            metrics["consist"] = per_subhead(lambda d1, d2: kl_div(d1, d2.detach()))
            total = total + float(tiny["consist"]["weight"]) * metrics["consist"]
        return total, new_state, metrics


def create_cross_correlation_hook(*, feature_name: str, num_clusters: int, in_dim: int,
                                  head_type: str = "mlp", num_subheads: int = 1,
                                  save: bool = False, hooks: Mapping, num_classes: int = 4,
                                  train_encoder: bool = True, **_ignored) -> CrossCorrelationHook:
    """One ``*CrossCorrelationParameters*`` section -> the hook
    ``cc_<feature_name>``. ``train_encoder`` is read by the pretraining
    trainers (``CrossCorrelationParameters``: false freezes the encoder),
    ``num_classes`` by nothing, as in JAX."""
    del num_classes, train_encoder
    return CrossCorrelationHook(name=f"cc_{feature_name}", feature_name=feature_name,
                                in_dim=in_dim, num_clusters=num_clusters, head_type=head_type,
                                num_subheads=num_subheads, hooks=hooks, save=save)
