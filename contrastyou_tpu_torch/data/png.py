"""8-bit grayscale PNG reader and writer on ``zlib`` and numpy (the role PIL
plays in contrastyou_tpu/data/base.py ``read_image`` and data/synthetic.py).

:func:`read_png` takes non-interlaced 8-bit grayscale files (colour type 0)
with any of the five row filters; PIL's writer picks a filter per row. Rows
filtered with None, Sub or Up are undone with numpy; Average and Paeth rows
depend on their own left neighbour, so those run as a loop over the row.
Any other file raises ``ValueError`` naming it and what it holds.
:func:`write_png` writes 8-bit grayscale, choosing None, Sub or Up per row.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["read_png", "write_png"]

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


def _average_row(raw: list, prior: list) -> list:
    out, a = [0] * len(raw), 0
    for i, r in enumerate(raw):
        a = (r + ((a + prior[i]) >> 1)) & 255
        out[i] = a
    return out


def _paeth_row(raw: list, prior: list) -> list:
    out, a, c = [0] * len(raw), 0, 0
    for i, r in enumerate(raw):
        b = prior[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (r + pred) & 255
        out[i] = a
        c = b
    return out


def read_png(path) -> np.ndarray:
    """The pixels [H, W] uint8 of an 8-bit grayscale, non-interlaced PNG."""
    data = Path(path).read_bytes()
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
    if colour != 0 or depth != 8:
        raise ValueError(f"{path}: colour type {colour} "
                         f"({_COLOUR_TYPES.get(colour, 'unknown')}) at bit depth {depth}; "
                         f"only 8-bit grayscale (colour type 0) is read")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != height * (width + 1):
        raise ValueError(f"{path}: {rows.size} bytes of pixel data for {height}x{width}")
    rows = rows.reshape(height, width + 1)
    out = np.empty((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for y, (kind, raw) in enumerate(zip(rows[:, 0].tolist(), rows[:, 1:])):
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = np.cumsum(raw, dtype=np.uint8)
        elif kind == 2:
            cur = raw + prior
        elif kind == 3:
            cur = np.array(_average_row(raw.tolist(), prior.tolist()), np.uint8)
        elif kind == 4:
            cur = np.array(_paeth_row(raw.tolist(), prior.tolist()), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, image: np.ndarray) -> None:
    """Write [H, W] uint8 pixels as an 8-bit grayscale PNG; each row takes
    the None, Sub or Up filter whose output has the least sum of absolute
    (signed) bytes, the heuristic of the PNG specification."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"{path}: write_png takes [H, W] uint8, got {img.dtype} {img.shape}")
    h, w = img.shape
    sub = img.copy()
    sub[:, 1:] -= img[:, :-1]
    up = img.copy()
    up[1:] -= img[:-1]
    cands = np.stack([img, sub, up])                              # [3, H, W]
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)   # [3, H]
    kind = cost.argmin(0).astype(np.uint8)
    rows = np.concatenate([kind[:, None], cands[kind, np.arange(h)]], 1)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
