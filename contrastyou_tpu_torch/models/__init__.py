"""Architecture zoo (counterpart of contrastyou_tpu/models/__init__.py):
:func:`get_arch` builds a net by registry name from keyword arguments."""
from __future__ import annotations

import inspect

import torch

from .resunet import ResUNet
from .unet import UNet
from .unet2 import UNet2

__all__ = ["ResUNet", "UNet", "UNet2", "get_arch", "arch_zoo"]

arch_zoo = {"unet": UNet, "unet2": UNet2, "resunet": ResUNet}


def get_arch(name: str = "unet", **kwargs) -> torch.nn.Module:
    """The net ``name`` (case-insensitive) built from ``kwargs``, as JAX's
    ``get_arch``: ``checkpoint`` is dropped, an unknown name raises
    ``KeyError`` and a keyword the net has no field for ``TypeError`` (as
    the flax dataclass does), naming every such keyword."""
    name = name.lower()
    if name not in arch_zoo:
        raise KeyError(f"arch '{name}' not in {tuple(arch_zoo)}")
    kwargs.pop("checkpoint", None)
    cls = arch_zoo[name]
    unknown = sorted(set(kwargs) - set(inspect.signature(cls.__init__).parameters))
    if unknown:
        raise TypeError(f"{cls.__name__} has no field {', '.join(unknown)}")
    return cls(**kwargs)
