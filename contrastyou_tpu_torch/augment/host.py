"""Host-side per-item transforms (counterpart of
contrastyou_tpu/augment/host.py): each slice is brought to the dataset's
fixed shape on the host, image and label by the same draw; the stochastic
views (affine, flips, gamma) are made on the device by the train step
(``ops/affine.py``).

Every dataset's pipeline is ported: the crops of the ACDC family, mmwhs and
hippocampus, the label remaps of ``acdc_lv/rv/myo`` (taken from
``data/datasets.py``'s table), and the resizes of prostate, prostate_md
(224) and spleen (320, then a 256 crop). :class:`Resize` gives PIL's
``Image.resize`` bit for bit without PIL (which the card's machine lacks):
the image is quantized to 8 bits as JAX does, resampled by PIL's
fixed-point ``BILINEAR`` convolution (:func:`resize_bilinear_u8`), and the
label by PIL's ``NEAREST`` sampling (:func:`resize_nearest`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.base import normalize_u8
from ..data.datasets import dataset_spec

__all__ = ["HostTransform", "Compose", "RandomCrop", "CenterCrop", "Resize", "LabelRemap",
           "TransformSpec", "bilinear_coefficients", "resize_bilinear_u8", "resize_nearest",
           "make_prostate_transforms", "make_spleen_transforms", "transform_zoo"]


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


#: fractional bits of PIL's fixed-point resampling coefficients (8-bit images)
PRECISION_BITS = 32 - 8 - 2


@lru_cache(maxsize=64)
def bilinear_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] int64: PIL's ``BILINEAR`` weights of one axis in
    fixed point (Pillow ``Resample.c`` ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``). The triangle filter is widened by the scale
    when downsampling (support ``max(scale, 1)``); each output's window is
    ``[int(center - support + 0.5), int(center + support + 0.5))`` clipped to
    the input, its weights summed in order and normalized in double, then
    rounded half away from zero to :data:`PRECISION_BITS` bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support, ss = filterscale, 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        weights = []
        for x in range(xmin, xmax):
            t = abs((x - center + 0.5) * ss)
            weights.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in weights:
            total += w
        for x, w in zip(range(xmin, xmax), weights):
            k = w / total if total != 0.0 else w
            out[xx, x] = int(0.5 + k * (1 << PRECISION_BITS))
    return out


def _apply_u8(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """One resampling pass, ``x @ coeffs.T`` (uint8 values, [.., in] ->
    [.., out]), rounded and clipped to uint8 as PIL's ``clip8``. The product
    runs in float64 and is exact: every term and partial sum is an integer
    below 255 * 2**22 * (1 + 2**-20) < 2**31, far inside float64's 2**53, so
    it equals int64 accumulation in any order."""
    acc = (x.astype(np.float64) @ coeffs.T.astype(np.float64)).astype(np.int64)
    return np.clip((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] -> uint8 ``size`` = (th, tw): PIL's ``Image.resize((tw,
    th), BILINEAR)`` of an ``L`` image, bit for bit. Separable, horizontal
    pass first into a clipped uint8 intermediate; an axis of unchanged size
    is not resampled."""
    th, tw = size
    x = np.asarray(image, np.uint8)
    if tw != x.shape[1]:
        x = _apply_u8(x, bilinear_coefficients(x.shape[1], tw))
    if th != x.shape[0]:
        x = _apply_u8(x.T, bilinear_coefficients(x.shape[0], th)).T
    return np.ascontiguousarray(x)


@lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's ``NEAREST`` source index of each output pixel (Pillow
    ``Geometry.c`` ``ImagingScaleAffine``): the pixel centre ``a / 2`` stepped
    by ``a = in / out`` in double, by repeated addition as PIL steps it, and
    truncated."""
    a = in_size / out_size
    steps = np.full(out_size, a)
    steps[0] = a * 0.5
    return np.add.accumulate(steps).astype(np.int64)


def resize_nearest(label: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W] -> ``size`` = (th, tw): PIL's ``Image.resize((tw, th), NEAREST)``."""
    th, tw = size
    h, w = label.shape
    if (h, w) == (th, tw):
        return label.copy()
    return label[_nearest_index(h, th)[:, None], _nearest_index(w, tw)[None, :]]


class Resize(HostTransform):
    """The image quantized to 8 bits (``(clip(image, 0, 1) * 255)`` in f32,
    truncated), resized by :func:`resize_bilinear_u8` and normalized back;
    the label cast to uint8 and resized by :func:`resize_nearest`, as int32."""

    def __init__(self, size):
        self._size = _size(size)

    def __call__(self, image, label, rng):
        u8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        image = normalize_u8(resize_bilinear_u8(u8, self._size))
        if label is not None:
            label = resize_nearest(label.astype(np.uint8), self._size).astype(np.int32)
        return image, label


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


def make_prostate_transforms() -> TransformSpec:
    """Prostate and prostate_md: every slice resized to 224 x 224."""
    return TransformSpec(train=Resize(224), val=Resize(224), crop_size=(224, 224))


def make_spleen_transforms() -> TransformSpec:
    """Spleen: resized to 320 x 320, then a random (train) or centre crop of 256."""
    return TransformSpec(train=Compose(Resize(320), RandomCrop(256)),
                         val=Compose(Resize(320), CenterCrop(256)), crop_size=(256, 256))


#: ``Data.name`` -> () -> TransformSpec
transform_zoo = {
    **{name: _acdc(name) for name in ("acdc", "acdc_superpixel", "acdc_lv", "acdc_rv",
                                      "acdc_myo", "mmwhsct", "mmwhsmr")},
    "hippocampus": lambda: make_crop_transforms(64),
    "prostate": make_prostate_transforms, "prostate_md": make_prostate_transforms,
    "spleen": make_spleen_transforms,
}
