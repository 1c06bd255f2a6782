"""Static dataset table (counterpart of the class attributes in
contrastyou_tpu/data/datasets.py): class count, anatomical partition count,
the scan-grouping pattern of each dataset, the scan names its synthetic
scans take (contrastyou_tpu/data/synthetic.py ``_LAYOUTS``) and, for the
binary ACDC sub-tasks, the label remap of contrastyou_tpu/augment/host.py
``transform_zoo``. It reads no files."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["DatasetSpec", "DATASETS", "dataset_spec"]


class DatasetSpec(NamedTuple):
    num_classes: int
    partition_num: int
    group_re: str          # regex of a slice's scan name within its stem
    scan_name: str         # synthetic scan name from {patient} and {cycle}
    cycles: int = 1        # scans per patient (ACDC: end-diastole and end-systole)
    #: label value -> trained class (acdc_lv/rv/myo: one structure against
    #: the rest), or None to train the labels as they are
    label_map: Optional[Tuple[int, ...]] = None

    @property
    def train_classes(self) -> int:
        """Classes the model is trained on (``num_classes`` of opt/<name>.yaml)."""
        return self.num_classes if self.label_map is None else max(self.label_map) + 1

    def remap(self, targets: np.ndarray) -> np.ndarray:
        """Integer label maps in the dataset's values -> trained classes."""
        return targets if self.label_map is None else np.asarray(self.label_map)[targets]


_ACDC = DatasetSpec(4, 3, r"patient\d+_\d+", "patient{patient:03d}_{cycle:02d}", 2)
_MMWHS = DatasetSpec(5, 5, r"\d+", "{patient:04d}")

DATASETS: Dict[str, DatasetSpec] = {
    "acdc": _ACDC,
    "acdc_lv": _ACDC._replace(label_map=(0, 0, 0, 1)),
    "acdc_rv": _ACDC._replace(label_map=(0, 1, 0, 0)),
    "acdc_myo": _ACDC._replace(label_map=(0, 0, 1, 0)),
    "acdc_superpixel": _ACDC,
    "prostate": DatasetSpec(2, 8, r"Case\d+", "Case{patient:02d}"),
    "prostate_md": DatasetSpec(2, 4, r"prostate_\d+", "prostate_{patient:02d}"),
    "mmwhsct": _MMWHS, "mmwhsmr": _MMWHS,
    "spleen": DatasetSpec(2, 5, r"spleen_\d+", "spleen_{patient:02d}"),
    "hippocampus": DatasetSpec(3, 3, r"hippocampus_\d+", "hippocampus_{patient:03d}"),
}


def dataset_spec(name: str) -> DatasetSpec:
    """The static metadata of dataset ``name`` (``Data.name``)."""
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}: known are {sorted(DATASETS)}") from None
