"""ModelBundle: a model plus its input shape and the train-mode apply
(counterpart of contrastyou_tpu/engine/bundle.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

__all__ = ["ModelBundle"]


@dataclass
class ModelBundle:
    model: torch.nn.Module          # UNet-compatible: forward(x, until, taps, train, update_stats)
    input_shape: Tuple[int, ...]    # (H, W, C) of one sample

    @property
    def num_classes(self) -> int:
        return self.model.num_classes

    def apply_train(self, x: torch.Tensor, *, until=None,
                    taps: Sequence[str] = (), update_stats: bool = True):
        """Train-mode forward with batch statistics -> (out, taps); the BN
        running statistics are updated in place unless ``update_stats`` is
        False."""
        return self.model(x, until=until, taps=taps, train=True,
                          update_stats=update_stats)
