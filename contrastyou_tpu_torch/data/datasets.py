"""Static dataset table (counterpart of the class attributes in
contrastyou_tpu/data/datasets.py): class count, anatomical partition count,
the scan-grouping pattern of each dataset, and the scan names its synthetic
scans take (contrastyou_tpu/data/synthetic.py ``_LAYOUTS``). It reads no
files."""
from __future__ import annotations

from typing import Dict, NamedTuple

__all__ = ["DatasetSpec", "DATASETS", "dataset_spec"]


class DatasetSpec(NamedTuple):
    num_classes: int
    partition_num: int
    group_re: str          # regex of a slice's scan name within its stem
    scan_name: str         # synthetic scan name from {patient} and {cycle}
    cycles: int = 1        # scans per patient (ACDC: end-diastole and end-systole)


_ACDC = DatasetSpec(4, 3, r"patient\d+_\d+", "patient{patient:03d}_{cycle:02d}", 2)
_MMWHS = DatasetSpec(5, 5, r"\d+", "{patient:04d}")

DATASETS: Dict[str, DatasetSpec] = {
    "acdc": _ACDC, "acdc_lv": _ACDC, "acdc_rv": _ACDC, "acdc_myo": _ACDC,
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
