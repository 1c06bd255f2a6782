"""8-bit grayscale and RGB PNG reader and writer on ``zlib`` and numpy (the
role PIL plays in contrastyou_tpu/data/base.py ``read_image``,
data/synthetic.py and the savers).

:func:`read_png` takes non-interlaced 8-bit grayscale (colour type 0) and
RGB (colour type 2, when asked for: ``rgb=True``) files with any of the
five row filters; PIL's writer
picks a filter per row. Rows filtered with None, Sub or Up are undone with
numpy; Average and Paeth rows depend on their own left neighbour, so those
run as a loop over the row. Any other file raises ``ValueError`` naming it
and what it holds. :func:`write_png` writes [H, W] uint8 as grayscale and
[H, W, 3] uint8 as RGB, choosing None, Sub or Up per row;
:func:`encode_png` / :func:`decode_png` do the same in memory.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["read_png", "write_png", "encode_png", "decode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha", 6: "RGBA"}


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _average_row(raw: list, prior: list, bpp: int) -> list:
    out = [0] * len(raw)
    for i, r in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (r + ((a + prior[i]) >> 1)) & 255
    return out


def _paeth_row(raw: list, prior: list, bpp: int) -> list:
    out = [0] * len(raw)
    for i, r in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (r + pred) & 255
    return out


def read_png(path, *, rgb: bool = False) -> np.ndarray:
    """The pixels [H, W] uint8 of an 8-bit grayscale, non-interlaced PNG;
    with ``rgb`` also of an RGB one, as [H, W, 3] (the datasets read
    grayscale slices and refuse anything else)."""
    return decode_png(Path(path).read_bytes(), path, rgb=rgb)


def decode_png(data: bytes, path="<bytes>", *, rgb: bool = False) -> np.ndarray:
    """:func:`read_png` of the file's bytes (``path`` names it in errors)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in ((0, 2) if rgb else (0,)) or depth != 8:
        raise ValueError(f"{path}: colour type {colour} "
                         f"({_COLOUR_TYPES.get(colour, 'unknown')}) at bit depth {depth}; "
                         f"only 8-bit grayscale (colour type 0) is read"
                         + ("" if rgb else ", and RGB (2) with rgb=True"))
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
    bpp = 3 if colour == 2 else 1
    stride = width * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"{path}: {rows.size} bytes of pixel data for {height}x{width}")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y, (kind, raw) in enumerate(zip(rows[:, 0].tolist(), rows[:, 1:])):
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = np.cumsum(raw.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = raw + prior
        elif kind == 3:
            cur = np.array(_average_row(raw.tolist(), prior.tolist(), bpp), np.uint8)
        elif kind == 4:
            cur = np.array(_paeth_row(raw.tolist(), prior.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out.reshape(height, width, 3) if bpp == 3 else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG bytes of [H, W] (grayscale) or [H, W, 3] (RGB) uint8 pixels;
    each row takes the None, Sub or Up filter whose output has the least sum
    of absolute (signed) bytes, the heuristic of the PNG specification."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3] uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    flat = img.reshape(h, w * bpp)
    sub = flat.copy()
    sub[:, bpp:] -= flat[:, :-bpp]
    up = flat.copy()
    up[1:] -= flat[:-1]
    cands = np.stack([flat, sub, up])                             # [3, H, W*bpp]
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)   # [3, H]
    kind = cost.argmin(0).astype(np.uint8)
    rows = np.concatenate([kind[:, None], cands[kind, np.arange(h)]], 1)
    colour = 0 if bpp == 1 else 2
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """Write [H, W] uint8 pixels as an 8-bit grayscale PNG, [H, W, 3] as RGB
    (:func:`encode_png`)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{path}: write_png takes [H, W] or [H, W, 3] uint8, got {img.dtype} "
                         f"{img.shape}")
    Path(path).write_bytes(encode_png(img))
