"""Config-keyed hook factory (counterpart of contrastyou_tpu/hooks/creator.py):
hooks are selected by the presence of their config section, with the
reference's key names, in the JAX factory's order. A hook section the JAX
factory knows but the port has no hook for raises NotImplementedError naming
it, so no preset trains without the regularizer it asks for."""
from __future__ import annotations

from typing import Callable, List, Mapping

from ..models.unet import UNet
from .consistency import ConsistencyTrainerHook
from .discretemi import DiscreteIMSATTrainHook, DiscreteMITrainHook
from .infonce import INFONCEHook
from .midl import IIDSegmentationTrainerHook, IMSATTrainHook

__all__ = ["ntuple", "PORTED_SECTIONS", "UNPORTED_SECTIONS", "create_infonce_hooks",
           "create_discrete_mi_consistency_hooks", "create_hook_from_config"]

#: hook sections this factory builds, in the JAX factory's order
PORTED_SECTIONS = ("InfonceParams", "DiscreteMIConsistencyParams", "IIDSegParameters",
                   "IMSATParameters", "IMSATFeatureParameters", "ConsistencyParameters")
#: hook sections of the JAX factory without a port yet (plus every
#: ``*CrossCorrelationParameters*`` section)
UNPORTED_SECTIONS = ("SPInfonceParams", "MeanTeacherParameters", "UAMeanTeacherParameters",
                     "ICTMeanTeacherParameters", "DifferentiableMeanTeacherParameters",
                     "EntropyMinParameters", "OrthogonalParameters", "PsuedoLabelParams",
                     "MixUpParams", "DAEParameters", "InfonceSuperPixelParams",
                     "EvalEMAParameters")


def ntuple(n: int) -> Callable:
    """A scalar (or string) -> ``n`` copies; a list passes through
    (counterpart of contrastyou_tpu/utils ``ntuple``)."""
    def parse(x):
        return tuple(x) if isinstance(x, (list, tuple)) else (x,) * n
    return parse


def create_infonce_hooks(*, feature_names, weights, contrast_ons, spatial_size,
                         channel_dim: Callable[[str], int],
                         proj_bf16: bool = False) -> List[INFONCEHook]:
    """One :class:`INFONCEHook` per feature name, named
    ``infonce/<layer>/<contrast_on>``, from the ``InfonceParams`` section;
    ``channel_dim`` gives each tapped layer's width."""
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    pg = ntuple(n)
    return [INFONCEHook(name=f"infonce/{f}/{c}", feature_name=f, in_dim=channel_dim(f),
                        weight=float(w), contrast_on=c,
                        spatial_size=None if f in UNet.encoder_names else (ss, ss),
                        proj_bf16=proj_bf16)
            for f, w, c, ss in zip(pg(feature_names), pg(weights), pg(contrast_ons),
                                   pg(spatial_size))]


def create_discrete_mi_consistency_hooks(*, feature_names, mi_weights, dense_paddings=None,
                                         consistency_weight: float,
                                         channel_dim: Callable[[str], int]) -> List:
    """One :class:`DiscreteMITrainHook` per feature name, named
    ``discreteMI/<layer>``; the decoder layers take ``dense_paddings`` in
    order; then the consistency hook with ``consistency_weight``."""
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    feature_names, mi_weights = ntuple(n)(feature_names), ntuple(n)(mi_weights)
    dense = [f for f in feature_names if f in UNet.decoder_names]
    paddings = iter(ntuple(len(dense))(dense_paddings))
    hooks: List = [DiscreteMITrainHook(
        name=f"discreteMI/{f.lower()}", feature_name=f, in_dim=channel_dim(f), weight=float(w),
        padding=(next(paddings) if f in UNet.decoder_names else None) or 0)
        for f, w in zip(feature_names, mi_weights)]
    return hooks + [ConsistencyTrainerHook(name="consistency", weight=float(consistency_weight))]


def create_hook_from_config(config: Mapping, *, channel_dim: Callable[[str], int],
                            is_pretrain: bool = False, proj_bf16: bool = False) -> List:
    """The hook list of a reference-style config. ``channel_dim`` gives a
    tapped layer's width; ``proj_bf16`` runs the dense InfoNCE heads in bf16."""
    unported = [k for k in config
                if k in UNPORTED_SECTIONS or "CrossCorrelationParameters" in str(k)]
    if unported:
        raise NotImplementedError(f"hook section(s) {unported} are not ported to "
                                  f"contrastyou_tpu_torch; ported: {list(PORTED_SECTIONS)}")

    def not_pretrain(key: str):
        if is_pretrain:
            raise RuntimeError(f"`{key}` is not supported for pretrain stage")

    hooks: List = []
    if "InfonceParams" in config:
        hooks += create_infonce_hooks(channel_dim=channel_dim, proj_bf16=proj_bf16,
                                      **config["InfonceParams"])
    if "DiscreteMIConsistencyParams" in config:
        not_pretrain("DiscreteMIConsistencyParams")
        hooks += create_discrete_mi_consistency_hooks(
            channel_dim=channel_dim, **config["DiscreteMIConsistencyParams"])
    if "IIDSegParameters" in config:
        p = config["IIDSegParameters"]
        hooks.append(IIDSegmentationTrainerHook(hook_name="iidseg", weight=float(p["weight"]),
                                                mi_lambda=float(p.get("mi_lambda", 1.0))))
    if "IMSATParameters" in config:
        hooks.append(IMSATTrainHook(hook_name="imsat",
                                    weight=float(config["IMSATParameters"]["weight"])))
    if "IMSATFeatureParameters" in config:
        p = config["IMSATFeatureParameters"]
        hooks.append(DiscreteIMSATTrainHook(
            name=f"discreteIMSAT/{p['feature_name'].lower()}", feature_name=p["feature_name"],
            in_dim=channel_dim(p["feature_name"]), weight=float(p["weight"]),
            num_clusters=int(p["num_clusters"]), num_subheads=3,
            cons_weight=float(p["cons_weight"])))
    if "ConsistencyParameters" in config:
        hooks.append(ConsistencyTrainerHook(
            name="consistency", weight=float(config["ConsistencyParameters"]["weight"])))
    return hooks
