"""Static dataset table (counterpart of the class attributes in
contrastyou_tpu/data/datasets.py): class count, anatomical partition count,
the scan-grouping pattern of each dataset, the scan names its synthetic
scans take (contrastyou_tpu/data/synthetic.py ``_LAYOUTS``) and, for the
binary ACDC sub-tasks, the label remap of contrastyou_tpu/augment/host.py
``transform_zoo``; and the archive dataset classes (``data_zoo``): each
archive's folder name, sub-folders, mode prefix and metadata file, over
:class:`~contrastyou_tpu_torch.data.base.SliceDataset`."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from .base import SliceDataset

__all__ = ["DatasetSpec", "DATASETS", "dataset_spec", "ACDCDataset", "ACDCSuperPixelDataset",
           "ProstateDataset", "ProstateMDDataset", "mmWHSCTDataset", "mmWHSMRDataset",
           "SpleenDataset", "HippocampusDataset", "data_zoo"]


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


# --- archive datasets (contrastyou_tpu/data/datasets.py:33-124) ------------

class _ArchiveDataset(SliceDataset):
    """An archive's folder under the data root: sub-folders, mode prefix and
    ``*_info.npy`` metadata."""
    folder_name: str
    sub_folders: Tuple[str, ...] = ("img", "gt")
    sub_folder_types: Tuple[str, ...] = ("image", "gt")
    info_name: Optional[str] = None
    mode_prefix = ""

    def __init__(self, *, root_dir: str, mode: str, transforms=None):
        root = Path(root_dir) / self.folder_name
        if not root.exists():
            raise FileNotFoundError(
                f"{type(self).__name__}: {root} missing; place the extracted archive there "
                f"or write a synthetic one (contrastyou_tpu_torch.data.synthetic)")
        super().__init__(root_dir=str(root), mode=self.mode_prefix + mode,
                         sub_folders=list(self.sub_folders),
                         sub_folder_types=list(self.sub_folder_types),
                         transforms=transforms, info_name=self.info_name)


class ACDCDataset(_ArchiveDataset):
    folder_name = "ACDC_contrast"
    group_re = _ACDC.group_re
    partition_num = _ACDC.partition_num
    info_name = "acdc_info.npy"


class ACDCSuperPixelDataset(ACDCDataset):
    sub_folders = ("img", "gt", "superpixel")
    sub_folder_types = ("image", "gt", "gt")


class ProstateDataset(_ArchiveDataset):
    folder_name = "PROSTATE"
    group_re = DATASETS["prostate"].group_re
    partition_num = DATASETS["prostate"].partition_num
    info_name = "prostate_info.npy"


class ProstateMDDataset(_ArchiveDataset):
    folder_name = "PROSTATE_md"
    group_re = DATASETS["prostate_md"].group_re
    partition_num = DATASETS["prostate_md"].partition_num
    sub_folders = ("t2", "gt")
    info_name = "prostate_info.npy"


class mmWHSCTDataset(_ArchiveDataset):
    folder_name = "MMWHS"
    group_re = _MMWHS.group_re
    partition_num = _MMWHS.partition_num
    info_name = "meta_ct.npy"
    mode_prefix = "ct_"


class mmWHSMRDataset(mmWHSCTDataset):
    info_name = "meta_mr.npy"
    mode_prefix = "mr_"


class SpleenDataset(_ArchiveDataset):
    folder_name = "Spleen"
    group_re = DATASETS["spleen"].group_re
    partition_num = DATASETS["spleen"].partition_num
    info_name = "spleen_info.npy"


class HippocampusDataset(_ArchiveDataset):
    folder_name = "Hippocampus"
    group_re = DATASETS["hippocampus"].group_re
    partition_num = DATASETS["hippocampus"].partition_num
    info_name = "hippocampus_info.npy"


#: ``Data.name`` -> archive dataset class
data_zoo = {
    "acdc": ACDCDataset, "acdc_lv": ACDCDataset, "acdc_rv": ACDCDataset,
    "acdc_myo": ACDCDataset, "acdc_superpixel": ACDCSuperPixelDataset,
    "prostate": ProstateDataset, "prostate_md": ProstateMDDataset,
    "mmwhsct": mmWHSCTDataset, "mmwhsmr": mmWHSMRDataset,
    "spleen": SpleenDataset, "hippocampus": HippocampusDataset,
}
