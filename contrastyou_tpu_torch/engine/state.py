"""TrainState: everything the train step reads and writes (counterpart of
contrastyou_tpu/engine/state.py). The model holds the parameters and the BN
running statistics, the optimizer its moments and update count."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

__all__ = ["TrainState"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    hook_states: Dict[str, Any] = field(default_factory=dict)
    step: int = 0
