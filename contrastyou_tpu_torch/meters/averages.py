"""Streaming average meters (counterpart of
contrastyou_tpu/meters/averages.py). Values may be device tensors: they are
read back at :meth:`summary`, so adding one never waits for the device."""
from __future__ import annotations

import math
from collections import OrderedDict

from .metric import Metric, to_host

__all__ = ["AverageValueMeter", "AverageValueDictionaryMeter"]


class AverageValueMeter(Metric[float]):
    """Weighted streaming mean of scalars."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._weight = 0.0
        self._pending: list = []

    def add(self, value, n: int = 1) -> None:
        self._pending.append((value, n))

    def _drain(self) -> None:
        for value, n in self._pending:
            self._sum += float(to_host(value)) * n
            self._weight += n
        self._pending.clear()

    def summary(self) -> float:
        self._drain()
        return math.nan if self._weight == 0 else self._sum / self._weight


class AverageValueDictionaryMeter(Metric[dict]):
    """One streaming mean per key."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._meters: "OrderedDict[str, AverageValueMeter]" = OrderedDict()

    def add(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self._meters.setdefault(k, AverageValueMeter()).add(v)

    def summary(self) -> dict:
        return {k: m.summary() for k, m in self._meters.items()}

