"""Config-keyed hook factory (counterpart of contrastyou_tpu/hooks/creator.py):
hooks are selected by the presence of their config section, with the
reference's key names, in the JAX factory's order and under its hook names.
Every hook section of the JAX factory has a port (:data:`UNPORTED_SECTIONS`
is empty; a section listed there would raise NotImplementedError naming
it). Given the trainer, the factory also picks its eval model: an
``EvalEMAParameters`` EMA over a mean teacher (MT, UAMT, ICT or DMT), as
JAX does."""
from __future__ import annotations

import logging
from typing import Callable, List, Mapping

from ..models.unet import UNet
from ..utils.general import ntuple
from .autoencoder import DenoisingAutoEncoderTrainerHook
from .ccblock import create_cross_correlation_hook
from .consistency import ConsistencyTrainerHook
from .discretemi import DiscreteIMSATTrainHook, DiscreteMITrainHook
from .dmt import DifferentiableMeanTeacherTrainerHook
from .entmin import EntropyMinTrainerHook
from .infonce import INFONCEHook, SelfPacedINFONCEHook, SuperPixelInfoNCEHook
from .midl import IIDSegmentationTrainerHook, IMSATTrainHook
from .mixup import MixUpTrainHook
from .mt import (EMAEvalTrainerHook, ICTMeanTeacherTrainerHook, MeanTeacherTrainerHook,
                 UAMeanTeacherTrainerHook)
from .orthogonal import OrthogonalTrainerHook
from .pseudolabel import PseudoLabelTrainerHook

__all__ = ["ntuple", "PORTED_SECTIONS", "UNPORTED_SECTIONS", "create_infonce_hooks",
           "create_sp_infonce_hooks", "create_superpixel_hooks",
           "create_discrete_mi_consistency_hooks", "create_hook_from_config"]

logger = logging.getLogger(__name__)

#: hook sections this factory builds, in the JAX factory's order (plus every
#: key containing ``CrossCorrelationParameters``, after ``IMSATFeatureParameters``)
PORTED_SECTIONS = ("InfonceParams", "SPInfonceParams", "DiscreteMIConsistencyParams",
                   "MeanTeacherParameters", "UAMeanTeacherParameters",
                   "ICTMeanTeacherParameters", "DifferentiableMeanTeacherParameters",
                   "EntropyMinParameters", "OrthogonalParameters",
                   "IIDSegParameters", "PsuedoLabelParams", "IMSATParameters",
                   "IMSATFeatureParameters", "ConsistencyParameters", "MixUpParams",
                   "DAEParameters", "InfonceSuperPixelParams", "EvalEMAParameters")
#: hook sections of the JAX factory without a port yet
UNPORTED_SECTIONS: tuple = ()
#: the fixed grid of the dense self-paced hooks (JAX ``create_sp_infonce_hooks``)
SP_DENSE_GRID = (16, 16)


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


def create_sp_infonce_hooks(*, feature_names, weights, contrast_ons, max_epoch: int,
                            channel_dim: Callable[[str], int], begin_values=1e10,
                            end_values=1e10, mode: str = "soft", p: float = 0.5,
                            correct_grad=False,
                            proj_bf16: bool = False) -> List[SelfPacedINFONCEHook]:
    """One :class:`SelfPacedINFONCEHook` per feature name, named
    ``spinfonce/<layer>/<contrast_on>``, from the ``SPInfonceParams``
    section with JAX's defaults; a decoder hook samples the fixed
    :data:`SP_DENSE_GRID`."""
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    pg = ntuple(n)
    return [SelfPacedINFONCEHook(
        name=f"spinfonce/{f}/{c}", feature_name=f, in_dim=channel_dim(f), weight=float(w),
        contrast_on=c, mode=mode, p=float(p), begin_value=float(b), end_value=float(e),
        max_epoch=int(max_epoch), correct_grad=bool(g),
        spatial_size=None if f in UNet.encoder_names else SP_DENSE_GRID, proj_bf16=proj_bf16)
        for f, w, c, b, e, g in zip(pg(feature_names), pg(weights), pg(contrast_ons),
                                    pg(begin_values), pg(end_values), pg(correct_grad))]


def create_superpixel_hooks(*, feature_names, weights, spatial_size,
                            channel_dim: Callable[[str], int],
                            proj_bf16: bool = False) -> List[SuperPixelInfoNCEHook]:
    """One :class:`SuperPixelInfoNCEHook` per (decoder) feature name, named
    ``infonce/<layer>/superpixel``, from the ``InfonceSuperPixelParams``
    section."""
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    pg = ntuple(n)
    return [SuperPixelInfoNCEHook(name=f"infonce/{f}/superpixel", feature_name=f,
                                  in_dim=channel_dim(f), weight=float(w), contrast_on="self",
                                  spatial_size=(ss, ss), proj_bf16=proj_bf16)
            for f, w, ss in zip(pg(feature_names), pg(weights), pg(spatial_size))]


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
                            is_pretrain: bool = False, proj_bf16: bool = False,
                            trainer=None) -> List:
    """The hook list of a reference-style config. ``channel_dim`` gives a
    tapped layer's width; ``proj_bf16`` runs the dense InfoNCE heads in bf16.
    With a ``trainer``, its eval model: the ``EvalEMAParameters`` hook, else
    the mean-teacher one, when the config has either. The DAE hook takes
    the model's class count (``channel_dim("Deconv_1x1")``, JAX's
    ``OPT.num_classes``)."""
    unported = [k for k in config if k in UNPORTED_SECTIONS]
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
    if "SPInfonceParams" in config:
        hooks += create_sp_infonce_hooks(channel_dim=channel_dim, proj_bf16=proj_bf16,
                                         max_epoch=int(config["Trainer"]["max_epoch"]),
                                         **config["SPInfonceParams"])
    if "DiscreteMIConsistencyParams" in config:
        not_pretrain("DiscreteMIConsistencyParams")
        hooks += create_discrete_mi_consistency_hooks(
            channel_dim=channel_dim, **config["DiscreteMIConsistencyParams"])
    mt_hook = None
    if "MeanTeacherParameters" in config:
        not_pretrain("MeanTeacherParameters")
        params = dict(config["MeanTeacherParameters"])
        num_teachers = int(params.pop("num_teachers", 1))
        if num_teachers > 1:
            raise NotImplementedError(f"num_teachers={num_teachers}: only one mean teacher "
                                      f"is supported")
        mt_hook = MeanTeacherTrainerHook(name="mt", **params)
        hooks.append(mt_hook)
    if "UAMeanTeacherParameters" in config:
        not_pretrain("UAMeanTeacherParameters")
        mt_hook = UAMeanTeacherTrainerHook(name="uamt",
                                           max_epoch=int(config["Trainer"]["max_epoch"]),
                                           **config["UAMeanTeacherParameters"])
        hooks.append(mt_hook)
    if "ICTMeanTeacherParameters" in config:
        not_pretrain("ICTMeanTeacherParameters")
        mt_hook = ICTMeanTeacherTrainerHook(name="ict", **config["ICTMeanTeacherParameters"])
        hooks.append(mt_hook)
    if "DifferentiableMeanTeacherParameters" in config:
        not_pretrain("DifferentiableMeanTeacherParameters")
        mt_hook = DifferentiableMeanTeacherTrainerHook(
            name="dmt", **config["DifferentiableMeanTeacherParameters"])
        hooks.append(mt_hook)
    if "EntropyMinParameters" in config:
        hooks.append(EntropyMinTrainerHook(
            name="entropy", weight=float(config["EntropyMinParameters"]["weight"])))
    if "OrthogonalParameters" in config:
        hooks.append(OrthogonalTrainerHook(
            hook_name="orth", weight=float(config["OrthogonalParameters"]["weight"])))
    if "IIDSegParameters" in config:
        p = config["IIDSegParameters"]
        hooks.append(IIDSegmentationTrainerHook(hook_name="iidseg", weight=float(p["weight"]),
                                                mi_lambda=float(p.get("mi_lambda", 1.0))))
    if "PsuedoLabelParams" in config:
        hooks.append(PseudoLabelTrainerHook(
            name="plab", weight=float(config["PsuedoLabelParams"]["weight"])))
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
    num_classes = channel_dim("Deconv_1x1")
    for key in [k for k in config if "CrossCorrelationParameters" in str(k)]:
        p = config[key]
        hooks.append(create_cross_correlation_hook(
            in_dim=channel_dim(p["feature_name"]), num_classes=num_classes, **p))
    if "ConsistencyParameters" in config:
        hooks.append(ConsistencyTrainerHook(
            name="consistency", weight=float(config["ConsistencyParameters"]["weight"])))
    if "MixUpParams" in config:
        p = config["MixUpParams"]
        hooks.append(MixUpTrainHook(hook_name="mixup", weight=float(p["weight"]),
                                    enable_bn=bool(p.get("enable_bn", True))))
    if "DAEParameters" in config:
        hooks.append(DenoisingAutoEncoderTrainerHook(
            hook_name="dae", weight=float(config["DAEParameters"]["weight"]),
            num_classes=num_classes))
    if "InfonceSuperPixelParams" in config:
        p = config["InfonceSuperPixelParams"]
        hooks += create_superpixel_hooks(channel_dim=channel_dim, proj_bf16=proj_bf16,
                                         feature_names=p["feature_names"],
                                         weights=p["weights"], spatial_size=p["spatial_size"])
    ema_hook = None
    if "EvalEMAParameters" in config:
        ema_hook = EMAEvalTrainerHook(**config["EvalEMAParameters"])
        hooks.append(ema_hook)
    # an explicit EvalEMAParameters wins over the mean teacher
    eval_hook = ema_hook or mt_hook
    if trainer is not None and eval_hook is not None:
        trainer.set_model4inference(eval_hook)
        logger.info("eval model: %s", eval_hook.name)
    return hooks
