"""Folder-backed slice dataset with scan grouping (counterpart of
contrastyou_tpu/data/base.py): ``root/mode/{img,gt,...}`` of 2D PNG slices,
scan grouping by regex, ``get_scan_list`` / ``get_stem_list``, anatomical
partitions from per-scan slice counts (or the archive's ``*_info.npy``), and
sub-datasets restricted to scan names (the split primitive).

Every slice is decoded once, when the dataset is built (the port's PNG
reader, ``data/png.py``), and kept in host memory, as the JAX dataset's
``preload``. Items are ``dataset[(index, rng)]`` -> ``{"image": f32
[H,W,1] in [0, 1], "target": i32 [H,W], "filename", "scan", "partition",
"patient", "cycle"}``, extra label folders (superpixels) under their folder
name, as in the JAX package.
"""
from __future__ import annotations

import copy
import re
import typing as t
from collections import OrderedDict
from pathlib import Path

import numpy as np

from .png import read_png

__all__ = ["SliceDataset", "extract_sub_dataset_based_on_scan_names", "get_stem",
           "normalize_u8", "INV255"]

#: listed as by the JAX package; a .jpg slice then fails in the PNG reader, by name
ALLOWED_EXTENSIONS = (".png", ".jpg")
#: u8 -> [0, 1] scale; one correctly rounded f32 multiply, as the JAX package's
INV255 = np.float32(1.0 / 255.0)


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    return arr.astype(np.float32) * INV255


def get_stem(path) -> str:
    return Path(path).stem


def _list_folder(root: Path) -> t.List[str]:
    return sorted(str(p) for p in root.iterdir() if p.suffix in ALLOWED_EXTENSIONS)


class SliceDataset:
    """2D-slice dataset over ``root/mode/<sub_folder>/*.png``."""

    partition_num: int = 1
    group_re: str = r".*"

    def __init__(self, *, root_dir: str, mode: str,
                 sub_folders: t.Sequence[str] = ("img", "gt"),
                 sub_folder_types: t.Sequence[str] = ("image", "gt"),
                 transforms=None, group_re: t.Optional[str] = None,
                 partition_num: t.Optional[int] = None,
                 info_name: t.Optional[str] = None):
        self._root_dir = str(root_dir)
        self._sub_folders = list(sub_folders)
        self._is_image = [s.lower() in ("image", "img") for s in sub_folder_types]
        self._transforms = transforms
        if group_re is not None:
            self.group_re = group_re
        if partition_num is not None:
            self.partition_num = partition_num
        self._re = re.compile(self.group_re)
        memory: "OrderedDict[str, t.List[str]]" = OrderedDict()
        for sub in self._sub_folders:
            folder = Path(self._root_dir, mode, sub)
            if not folder.is_dir():
                raise FileNotFoundError(
                    f"missing dataset folder {folder}: place the archive there or write "
                    f"a synthetic one (contrastyou_tpu_torch.data.synthetic)")
            memory[sub] = _list_folder(folder)
        counts = {k: len(v) for k, v in memory.items()}
        if len(set(counts.values())) != 1:
            raise ValueError(f"unbalanced sub folders: {counts}")
        self._memory = memory
        self._scan_slice_count = self._count_slices_per_scan()
        self._scan_info: t.Optional[t.Dict[str, int]] = None
        if info_name is not None:
            info_path = Path(self._root_dir, info_name)
            if info_path.exists():
                raw = np.load(str(info_path), allow_pickle=True)
                info = raw.item() if raw.ndim == 0 else raw.tolist()
                if not isinstance(info, dict):
                    raise ValueError(f"{info_path}: expected a scan -> slice count dict")
                self._scan_info = {str(k): int(v) for k, v in info.items()}
        self._preload = {sub: [read_png(p) for p in paths] for sub, paths in memory.items()}

    # --- scan grouping --------------------------------------------------
    def get_scan_name(self, stem: str) -> str:
        name = Path(stem).stem
        m = self._re.match(name) or self._re.search(name)
        if m is None:
            raise ValueError(f"cannot extract scan name from '{stem}' with /{self.group_re}/")
        return m.group(0)

    def _count_slices_per_scan(self) -> t.Dict[str, int]:
        counts: t.Dict[str, int] = {}
        for path in self._memory[self._sub_folders[0]]:
            scan = self.get_scan_name(get_stem(path))
            counts[scan] = counts.get(scan, 0) + 1
        return counts

    def get_scan_list(self) -> t.List[str]:
        return sorted(self._scan_slice_count)

    def get_stem_list(self) -> t.List[str]:
        return [get_stem(p) for p in self._memory[self._sub_folders[0]]]

    # --- partitions -----------------------------------------------------
    def get_partition(self, stem: str) -> int:
        """Anatomical partition of a slice from its index within the scan:
        the 3-way threshold rule for ``partition_num`` == 3, else ``cur //
        (cut + 1)``; the scan length from ``*_info.npy`` when present."""
        scan = self.get_scan_name(stem)
        if self._scan_info is not None and scan in self._scan_info:
            max_len = self._scan_info[scan]
        else:
            max_len = self._scan_slice_count[scan]
        cur = int(re.findall(r"\d+", Path(stem).stem)[-1])
        cut = max(max_len // self.partition_num, 1)
        if self.partition_num > 3:
            part = cur // (cut + 1)
        else:
            part = 0 if cur <= cut - 1 else (1 if cur <= 2 * cut else 2)
        return min(part, self.partition_num - 1)

    def get_partition_list(self) -> t.List[int]:
        return [self.get_partition(s) for s in self.get_stem_list()]

    @staticmethod
    def get_patient_cycle(scan_name: str) -> t.Tuple[int, int]:
        """(patient, cycle) ids: the first and second number of the scan
        name, the cycle 0 when there is no second."""
        nums = re.findall(r"\d+", scan_name)
        return (int(nums[0]) if nums else 0), (int(nums[1]) if len(nums) > 1 else 0)

    # --- loading --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._memory[self._sub_folders[0]])

    def _raw(self, sub: str, index: int) -> np.ndarray:
        return self._preload[sub][index]

    def __getitem__(self, index):
        rng = None
        if isinstance(index, tuple):
            index, rng = index
        if rng is None:
            rng = np.random.default_rng(index)
        stem = get_stem(self._memory[self._sub_folders[0]][index])
        arrays = {sub: self._raw(sub, index) for sub in self._sub_folders}
        image = normalize_u8(arrays[self._sub_folders[0]])
        target, extras = None, {}
        for sub, is_img in zip(self._sub_folders[1:], self._is_image[1:]):
            if not is_img and target is None:
                target = arrays[sub].astype(np.int32)
            else:
                extras[sub] = arrays[sub]
        if self._transforms is not None:
            if extras:
                image, (target, extras) = self._apply_with_extras(image, target, extras, rng)
            else:
                image, target = self._transforms(image, target, rng)
        scan = self.get_scan_name(stem)
        patient, cycle = self.get_patient_cycle(scan)
        item = {"image": image[..., None], "target": target, "filename": stem,
                "scan": scan, "partition": self.get_partition(stem),
                "patient": patient, "cycle": cycle}
        item.update(extras)
        return item

    def _apply_with_extras(self, image, target, extras, rng):
        """The same geometric draw on the target and each extra label map,
        by replaying the rng state."""
        state = rng.bit_generator.state
        image_t, target_t = self._transforms(image, target, rng)
        out = {}
        for k, v in extras.items():
            r2 = np.random.default_rng()
            r2.bit_generator.state = state
            out[k] = self._transforms(image, v.astype(np.int32), r2)[1]
        return image_t, (target_t, out)

    @property
    def root_dir(self) -> str:
        return self._root_dir


def extract_sub_dataset_based_on_scan_names(dataset: SliceDataset,
                                            group_names: t.Iterable[str]) -> SliceDataset:
    """A copy of ``dataset`` restricted to the scans ``group_names`` (the
    decoded slices are shared, not copied)."""
    keep = set(group_names)
    sub = copy.copy(dataset)
    first = dataset._sub_folders[0]
    idx = [i for i, p in enumerate(dataset._memory[first])
           if dataset.get_scan_name(get_stem(p)) in keep]
    sub._memory = OrderedDict((k, [v[i] for i in idx]) for k, v in dataset._memory.items())
    sub._preload = {k: [v[i] for i in idx] for k, v in dataset._preload.items()}
    sub._scan_slice_count = sub._count_slices_per_scan()
    return sub
