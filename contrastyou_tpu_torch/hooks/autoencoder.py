"""Denoising-autoencoder hook (counterpart of contrastyou_tpu/hooks/autoencoder.py):
a learnable 1x1 conv (class logits -> 1 channel, with bias) and a sigmoid
reconstruct the transformed unlabeled image from its logits f(T(x)); the
loss is the MSE. The conv carries flax's name (``Conv_0``, so
``utils/torch_convert.py``'s head bridge maps it) and joins the optimizer."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..engine.hooks import ModuleHook, StepContext
from ..models.projectors import _dense, _init

__all__ = ["AuxLayer", "DenoisingAutoEncoderTrainerHook"]


class AuxLayer(nn.Module):
    """1x1 conv of ``in_dim`` -> 1 channel, then a sigmoid, on NHWC maps."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_dim, 1, 1)

    def init_weights(self, generator: torch.Generator) -> "AuxLayer":
        _init(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(_dense(x, self.Conv_0, None))


class DenoisingAutoEncoderTrainerHook(ModuleHook):
    #: a per-pixel mean over this rank's rows; the conv's gradient joins the
    #: step's gradient all-reduce with the optimizer's other parameters
    data_parallel = True

    def __init__(self, *, hook_name: str = "dae", weight: float = 0.0, num_classes: int = 4):
        super().__init__(hook_name=hook_name, weight=weight)
        self.projector = AuxLayer(int(num_classes))

    def loss(self, ctx: StepContext, state):
        recovered = self.projector(ctx.unlabeled_tf_logits)
        return torch.mean((recovered - ctx.unlabeled_image_tf) ** 2), state, {}
