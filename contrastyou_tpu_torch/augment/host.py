"""Host-side per-item transforms (counterpart of
contrastyou_tpu/augment/host.py): each slice is brought to the dataset's
fixed shape on the host, image and label by the same draw; the stochastic
views (affine, flips, gamma) are made on the device by the train step
(``ops/affine.py``).

Ported: the crops of the ACDC family, mmwhs and hippocampus, and the label
remaps of ``acdc_lv/rv/myo`` (taken from ``data/datasets.py``'s table). The
prostate and spleen pipelines resize with PIL's bilinear filter, which numpy
does not reproduce bit for bit; ``transform_zoo`` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.datasets import dataset_spec

__all__ = ["HostTransform", "Compose", "RandomCrop", "CenterCrop", "LabelRemap",
           "TransformSpec", "transform_zoo"]


class HostTransform:
    """(image f32 [H,W], label i32 [H,W] or None, rng) -> the same."""

    def __call__(self, image: np.ndarray, label: Optional[np.ndarray],
                 rng: np.random.Generator):
        raise NotImplementedError


class Compose(HostTransform):
    def __init__(self, *transforms: HostTransform):
        self._transforms = transforms

    def __call__(self, image, label, rng):
        for t in self._transforms:
            image, label = t(image, label, rng)
        return image, label


def _size(size) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def _pad_to(image: np.ndarray, size: Tuple[int, int], value=0.0) -> np.ndarray:
    ph, pw = max(size[0] - image.shape[0], 0), max(size[1] - image.shape[1], 0)
    if ph == 0 and pw == 0:
        return image
    return np.pad(image, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)),
                  constant_values=value)


class RandomCrop(HostTransform):
    def __init__(self, size, pad_if_needed: bool = True):
        self._size, self._pad = _size(size), pad_if_needed

    def __call__(self, image, label, rng):
        if self._pad:
            image = _pad_to(image, self._size)
            if label is not None:
                label = _pad_to(label, self._size)
        (h, w), (th, tw) = image.shape[:2], self._size
        y = int(rng.integers(0, h - th + 1))
        x = int(rng.integers(0, w - tw + 1))
        return (image[y:y + th, x:x + tw],
                None if label is None else label[y:y + th, x:x + tw])


class CenterCrop(HostTransform):
    def __init__(self, size):
        self._size = _size(size)

    def __call__(self, image, label, rng):
        image = _pad_to(image, self._size)
        if label is not None:
            label = _pad_to(label, self._size)
        (h, w), (th, tw) = image.shape[:2], self._size
        y, x = (h - th) // 2, (w - tw) // 2
        return (image[y:y + th, x:x + tw],
                None if label is None else label[y:y + th, x:x + tw])


class LabelRemap(HostTransform):
    """Class remap of the binary ACDC sub-tasks."""

    def __init__(self, mapping: Dict[int, int]):
        self._mapping = dict(mapping)

    def __call__(self, image, label, rng):
        if label is not None:
            out = np.zeros_like(label)
            for src, dst in self._mapping.items():
                out[label == src] = dst
            label = out
        return image, label


@dataclass
class TransformSpec:
    """A dataset's host pipelines (train, val) and its crop."""
    train: HostTransform
    val: HostTransform
    crop_size: Tuple[int, int]


def make_crop_transforms(size: int, mapping: Optional[Dict[int, int]] = None) -> TransformSpec:
    train, val = RandomCrop(size), CenterCrop(size)
    if mapping:
        train, val = Compose(train, LabelRemap(mapping)), Compose(val, LabelRemap(mapping))
    return TransformSpec(train=train, val=val, crop_size=(size, size))


def _acdc(name: str):
    label_map = dataset_spec(name).label_map
    return lambda: make_crop_transforms(
        224, None if label_map is None else dict(enumerate(label_map)))


def _resize_unported(name: str):
    def make():
        raise NotImplementedError(
            f"{name}: its host transforms resize with PIL's bilinear filter, which the "
            f"port does not reproduce; only the crop datasets are ported")
    return make


#: ``Data.name`` -> () -> TransformSpec
transform_zoo = {
    **{name: _acdc(name) for name in ("acdc", "acdc_superpixel", "acdc_lv", "acdc_rv",
                                      "acdc_myo", "mmwhsct", "mmwhsmr")},
    "hippocampus": lambda: make_crop_transforms(64),
    **{name: _resize_unported(name) for name in ("prostate", "prostate_md", "spleen")},
}
