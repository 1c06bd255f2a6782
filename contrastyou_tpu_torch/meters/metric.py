"""Metric protocol (counterpart of contrastyou_tpu/meters/metric.py):
``add`` per batch, ``summary`` at the end of an epoch."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Generic, TypeVar

import numpy as np

__all__ = ["Metric", "to_host"]

Result = TypeVar("Result")


def to_host(x) -> np.ndarray:
    """A torch tensor (on any device), numpy array or number -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric(ABC, Generic[Result]):
    @abstractmethod
    def reset(self) -> None: ...

    @abstractmethod
    def add(self, *args: Any, **kwargs: Any) -> None: ...

    @abstractmethod
    def summary(self) -> Result: ...

    def join(self) -> None:
        """Bring values still on the device to the host (default: nothing)."""
