"""ctypes binding of the host batch assembler ``native/fast_collate.cpp``
(counterpart of contrastyou_tpu/native): crop, scale to [0, 1] and stack
uint8 slices over a thread pool, for ``BatchLoader(fast_crop=...)``.

The library is built at first use with g++ from the repo's
``native/fast_collate.cpp`` into ``build/torch_native/`` (a file name keyed
by a hash of the source and the flags), never beside the source. A missing
compiler or a failed build raises with the compiler's output; there is no
fall-back to another path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "FLAGS", "load", "fast_collate_crop"]

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "fast_collate.cpp"
BUILD_DIR = REPO / "build" / "torch_native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _library_path() -> Path:
    if not SOURCE.is_file():
        raise FileNotFoundError(f"{SOURCE}: the native batch assembler's source is missing")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastcollate-{key}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library (built here on first use)."""
    path = _library_path()
    if not path.is_file():
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError("fast_crop needs g++ to build native/fast_collate.cpp; "
                               "none is on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{id(path)}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    lib.collate_crop_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.collate_crop_u8.restype = None
    return lib


def fast_collate_crop(images: Sequence[np.ndarray], labels: Optional[Sequence[np.ndarray]],
                      ys: np.ndarray, xs: np.ndarray, out_h: int, out_w: int,
                      num_threads: int = 4) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """[in_h, in_w] uint8 slices cropped at (ys, xs) -> (f32 [N, out_h,
    out_w] in [0, 1], i32 [N, out_h, out_w] or None without ``labels``)."""
    lib = load()
    n = len(images)
    in_h, in_w = images[0].shape
    if any(im.shape != (in_h, in_w) for im in images):
        raise ValueError("fast_crop takes slices of one shape")
    ys32, xs32 = (np.ascontiguousarray(v, np.int32) for v in (ys, xs))
    if (ys32 < 0).any() or (xs32 < 0).any() or (ys32 + out_h > in_h).any() \
            or (xs32 + out_w > in_w).any():
        raise ValueError(f"a crop of {out_h}x{out_w} does not fit slices of {in_h}x{in_w}")
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    img_ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    out_img = np.empty((n, out_h, out_w), np.float32)
    lab_ptrs, out_lab = None, None
    if labels is not None:
        labels = [np.ascontiguousarray(lb, np.uint8) for lb in labels]
        lab_ptrs = (ctypes.c_void_p * n)(*[lb.ctypes.data for lb in labels])
        out_lab = np.empty((n, out_h, out_w), np.int32)
    lib.collate_crop_u8(
        img_ptrs, lab_ptrs, n, in_h, in_w,
        ys32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        xs32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), out_h, out_w,
        out_img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        (out_lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if out_lab is not None
         else ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))), int(num_threads))
    return out_img, out_lab
