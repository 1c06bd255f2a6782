"""Epoch-indexed history of meter results, written to ``storage.csv``
(counterpart of contrastyou_tpu/meters/storage.py) with the stdlib ``csv``
module: the same header, index and values as the JAX package's pandas
``to_csv`` (columns ``<name>/<key>`` in order of first appearance, rows by
epoch, floats as ``repr``, missing values empty). ``state_dict`` /
``load_state_dict`` carry the history across a resume."""
from __future__ import annotations

import csv
import math
from collections import OrderedDict, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["HistoricalContainer", "Storage"]


class HistoricalContainer:
    """{epoch: result dict}."""

    def __init__(self):
        self._record: "OrderedDict[int, dict]" = OrderedDict()

    def add(self, value: dict, epoch: Optional[int] = None) -> None:
        if epoch is None:
            epoch = max(self._record, default=-1) + 1
        self._record[epoch] = dict(value)

    @property
    def record(self):
        return self._record

    def columns(self) -> List[str]:
        """Keys of the results in order of first appearance."""
        return list(dict.fromkeys(k for v in self._record.values() for k in v))

    def state_dict(self) -> dict:
        return {"record": dict(self._record)}

    def load_state_dict(self, state: dict) -> None:
        self._record = OrderedDict(sorted(state["record"].items()))


def _cell(value) -> str:
    if value is None:
        return ""
    value = float(value)
    return "" if math.isnan(value) else repr(value)


class Storage:
    """The history; leaving a ``with`` block writes the CSV unless ``write``
    is False (a data-parallel rank other than 0 keeps the history alone)."""

    def __init__(self, save_dir, csv_name: str = "storage.csv", *, write: bool = True):
        self._storage: Dict[str, HistoricalContainer] = defaultdict(HistoricalContainer)
        self._save_dir = str(save_dir)
        self._csv_name = csv_name
        self._write = write

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._write:
            self.to_csv()

    def put(self, name: str, value, epoch: Optional[int] = None) -> None:
        if not isinstance(value, dict):
            value = {"value": value}
        self._storage[name].add(value, epoch)

    def put_group(self, group_name: str, epoch_result: Optional[dict],
                  epoch: Optional[int] = None, sep: str = "/") -> None:
        if not epoch_result:
            return
        for k, v in epoch_result.items():
            self.put(group_name + sep + k, v, epoch)

    def add_from_meter_interface(self, *, epoch: int, **stages) -> None:
        """``stages``: e.g. ``tra={group: {meter: result}}``, ``val=...``."""
        for stage_name, groups in stages.items():
            for group_name, group_result in dict(groups).items():
                self.put_group(f"{stage_name}/{group_name}", group_result, epoch)

    def table(self):
        """-> (column names, [(epoch, {column: value})]): pandas' outer
        merge of the containers (rows sorted when more than one container)."""
        columns, rows = [], {}
        containers = list(self._storage.items())
        for name, container in containers:
            columns += [f"{name}/{c}" for c in container.columns()]
            for epoch, value in container.record.items():
                row = rows.setdefault(epoch, {})
                row.update({f"{name}/{k}": v for k, v in value.items()})
        epochs = list(rows) if len(containers) == 1 else sorted(rows)
        return columns, [(e, rows[e]) for e in epochs]

    def to_csv(self) -> None:
        path = Path(self._save_dir)
        path.mkdir(parents=True, exist_ok=True)
        columns, rows = self.table()
        with open(path / self._csv_name, "w", newline="") as f:
            if not columns and not rows:
                f.write('""\n')
                return
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + columns)
            for epoch, row in rows:
                w.writerow([epoch] + [_cell(row.get(c)) for c in columns])

    def state_dict(self) -> dict:
        return {name: c.state_dict() for name, c in self._storage.items()}

    def load_state_dict(self, state: dict) -> None:
        self._storage.clear()
        for name, sub in state.items():
            container = HistoricalContainer()
            container.load_state_dict(sub)
            self._storage[name] = container
