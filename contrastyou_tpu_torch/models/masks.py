"""Trainable-parameter selection (counterpart of contrastyou_tpu/models/masks.py),
the replacement for the reference's ``switch_grad``: a predicate over the
model's parameter names says which tensors the optimizer updates."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from ._base import check_range_params, complete_arch_start2end

__all__ = ["layer_of", "trainable_mask"]


def layer_of(param_name: str) -> str:
    """Layer of a named-layer model parameter: ``_Up_conv2.conv.0.weight`` ->
    ``Up_conv2``."""
    return param_name.split(".", 1)[0].lstrip("_")


def trainable_mask(*, elements: Sequence[str], enable: bool = False,
                   start: Optional[str] = None, end: Optional[str] = None,
                   include_start: bool = True,
                   include_end: bool = True) -> Callable[[str], bool]:
    """-> ``predicate(param_name)``: parameters of the layers in [start, end]
    (bounds inclusive per the flags) get ``enable``, every other parameter
    True. E.g. the pretrain freeze after the tapped layer:
    ``trainable_mask(elements=UNet.arch_elements, enable=False, start=until,
    include_start=False)``."""
    check_range_params(start, end, include_start, include_end, elements=elements)
    selected = set(complete_arch_start2end(
        start or elements[0], end or elements[-1], elements=elements,
        include_start=include_start, include_end=include_end))
    return lambda name: enable if layer_of(name) in selected else True
