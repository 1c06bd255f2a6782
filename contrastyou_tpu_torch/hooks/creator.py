"""Config-keyed hook factory (counterpart of contrastyou_tpu/hooks/creator.py),
for the hooks the port has."""
from __future__ import annotations

from typing import Callable, List

from ..models.unet import UNet
from .infonce import INFONCEHook

__all__ = ["ntuple", "create_infonce_hooks"]


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
