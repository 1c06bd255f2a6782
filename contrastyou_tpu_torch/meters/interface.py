"""MeterInterface: named meters in groups, ``focus_on(group)`` to register
and update under one (counterpart of contrastyou_tpu/meters/interface.py)."""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

from .metric import Metric

__all__ = ["MeterInterface"]


class MeterInterface:
    def __init__(self, default_focus: str = "tra"):
        self._bank: Dict[str, "OrderedDict[str, Metric]"] = defaultdict(OrderedDict)
        self._focus = default_focus

    def register_meter(self, name: str, meter: Metric) -> Metric:
        if not isinstance(meter, Metric):
            raise TypeError(f"{name}: expected Metric, got {type(meter)}")
        group = self._bank[self._focus]
        if name in group:
            raise KeyError(f"meter '{name}' already registered in group '{self._focus}'")
        group[name] = meter
        return meter

    def add(self, meter_name: str, *args, **kwargs) -> None:
        self[meter_name].add(*args, **kwargs)

    def __getitem__(self, meter_name: str) -> Metric:
        group = self._bank.get(self._focus, {})
        if meter_name not in group:
            raise KeyError(f"'{meter_name}' not in group '{self._focus}' ({', '.join(group)})")
        return group[meter_name]

    @contextmanager
    def focus_on(self, group_name: str):
        prev, self._focus = self._focus, group_name
        try:
            yield self
        finally:
            self._focus = prev

    def reset(self) -> None:
        for group in self._bank.values():
            for meter in group.values():
                meter.reset()

    def join(self) -> None:
        for group in self._bank.values():
            for meter in group.values():
                meter.join()

    def statistics(self) -> Iterator[Tuple[str, dict]]:
        """(group, {meter: summary}) of every group not starting with ``_``."""
        for g in list(self._bank):
            if not g.startswith("_"):
                yield g, {k: m.summary() for k, m in self._bank[g].items()}

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *exc):
        self.join()
