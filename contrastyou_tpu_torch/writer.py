"""TensorBoard event files written by hand (counterpart of
contrastyou_tpu/writer.py, which is tensorboardX's ``SummaryWriter``; the
card's machine has neither tensorboardX nor TensorBoard).

:class:`SummaryWriter` ``(log_dir)`` writes
``<log_dir>/tensorboard/events.out.tfevents.<time>.<host>.<pid>.<n>``, a new
file for each writer (so a resumed run adds a file beside the earlier ones,
as tensorboardX does): ``add_scalar``, ``add_image`` (uint8 pixels, PNG
encoded), ``add_scalars_from_meter_interface`` with JAX's tags
(``stage/group/name`` and ``stage/group/name/sub``; groups starting with
``_`` and values that are not numbers are skipped), ``flush`` / ``close``,
and ``with writer:``, which makes it the writer :func:`get_tb_writer`
returns. ``write=False`` makes a writer that writes nothing (a data-parallel
rank other than 0).

The file is TFRecord-framed, each record an ``Event`` protobuf encoded here:
the record is its length (uint64, little-endian), the length's masked
CRC32C, the data and the data's masked CRC32C, where CRC32C is the
Castagnoli checksum and the mask ``((c >> 15 | c << 17) + 0xa282ead8) mod
2^32``. ``Event``: ``wall_time`` field 1 (double), ``step`` 2 (int64),
``file_version`` 3 (``brain.Event:2``, the first record), ``summary`` 5.
``Summary``: repeated ``value`` 1; ``Summary.Value``: ``tag`` 1,
``simple_value`` 2 (float32), ``image`` 4; ``Summary.Image``: ``height``
1, ``width`` 2, ``colorspace`` 3 (1 grayscale, 3 RGB), the PNG bytes 4.
:func:`read_events` parses such a file back.
"""
from __future__ import annotations

import itertools
import math
import os
import socket
import struct
import time
from pathlib import Path
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

from .data.png import encode_png

__all__ = ["SummaryWriter", "get_tb_writer", "read_events", "storage_tag", "crc32c",
           "masked_crc32c"]


def storage_tag(column: str) -> str:
    """The tag :meth:`SummaryWriter.add_scalars_from_meter_interface` gives
    the value of a ``storage.csv`` column: a scalar meter's column ends in
    ``/value``, its tag does not."""
    return column[:-len("/value")] if column.endswith("/value") else column


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """The CRC32C (Castagnoli, reflected polynomial 0x82F63B78) of ``data``."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire format ---------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # negative int64s take ten bytes, two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _image(height: int, width: int, colorspace: int, png: bytes) -> bytes:
    return (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
            + _key(3, 0) + _varint(colorspace) + _bytes_field(4, png))


def _event(wall_time: float, step: int, *, file_version: Optional[str] = None,
           values: Optional[List[bytes]] = None) -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if values is not None:
        out += _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))
    return out


def _record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


_writer_stack: List["SummaryWriter"] = []
_file_count = itertools.count()


class SummaryWriter:
    """Event-file writer of ``<log_dir>/tensorboard`` (see the module docstring)."""

    def __init__(self, log_dir, *, write: bool = True):
        self._file: Optional[BinaryIO] = None
        self.path: Optional[Path] = None
        if not write:
            return
        logdir = Path(log_dir) / "tensorboard"
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / (f"events.out.tfevents.{int(time.time()):010d}."
                              f"{socket.gethostname()}.{os.getpid()}.{next(_file_count)}")
        self._file = open(self.path, "xb")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))
        self.flush()

    def _write(self, event: bytes) -> None:
        if self._file is not None:
            self._file.write(_record(event))

    def add_scalar(self, tag: str, scalar_value, global_step: Optional[int] = None,
                   walltime: Optional[float] = None) -> None:
        value = _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(scalar_value))
        self._write(_event(time.time() if walltime is None else walltime, global_step or 0,
                           values=[value]))

    def add_image(self, tag: str, img_tensor, global_step: Optional[int] = None,
                  walltime: Optional[float] = None, dataformats: str = "CHW") -> None:
        """``img_tensor``: uint8 pixels laid out as ``dataformats`` says
        (``CHW``, ``HWC`` or ``HW``; one channel is grayscale, three RGB),
        stored as PNG."""
        img = np.asarray(img_tensor)
        if img.dtype != np.uint8:
            raise ValueError(f"add_image {tag}: uint8 pixels, got {img.dtype}")
        if dataformats == "CHW" and img.ndim == 3:
            img = img.transpose(1, 2, 0)
        elif dataformats not in ("HWC", "HW", "CHW") or img.ndim not in (2, 3):
            raise ValueError(f"add_image {tag}: {img.shape} as {dataformats}")
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[..., 0]
        if img.ndim == 3 and img.shape[2] != 3:
            raise ValueError(f"add_image {tag}: 1 or 3 channels, got {img.shape[2]}")
        img = np.ascontiguousarray(img)
        colorspace = 1 if img.ndim == 2 else 3
        value = _bytes_field(1, tag.encode()) + _bytes_field(
            4, _image(img.shape[0], img.shape[1], colorspace, encode_png(img)))
        self._write(_event(time.time() if walltime is None else walltime, global_step or 0,
                           values=[value]))

    def add_scalars_from_meter_interface(self, *, epoch: int, **stages) -> None:
        """``stages``: ``tra={group: {meter: value or {sub: value}}}``,
        ``val=...``, each value a scalar under ``stage/group/meter[/sub]``
        at step ``epoch``."""
        for stage, groups in stages.items():
            for group, meters in dict(groups).items():
                if group.startswith("_"):
                    continue
                for name, value in dict(meters).items():
                    tag = f"{stage}/{group}/{name}"
                    if isinstance(value, dict):
                        for sub, v in value.items():
                            self._safe_add_scalar(f"{tag}/{sub}", v, epoch)
                    else:
                        self._safe_add_scalar(tag, value, epoch)

    def _safe_add_scalar(self, tag: str, value, step: int) -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        self.add_scalar(tag, value, global_step=step)

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        _writer_stack.append(self)
        return self

    def __exit__(self, *exc):
        assert _writer_stack and _writer_stack[-1] is self
        _writer_stack.pop()
        self.flush()


def get_tb_writer() -> SummaryWriter:
    """The innermost writer entered with ``with writer:``."""
    if not _writer_stack:
        raise RuntimeError("no SummaryWriter active; use `with writer:`")
    return _writer_stack[-1]


# --- reading -------------------------------------------------------------------

def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes) -> Iterator[tuple]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read")
        yield field, wire, value


def _records(path) -> Iterator[bytes]:
    data = Path(path).read_bytes()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record at byte {i}")
        length_bytes = data[i:i + 8]
        (length,) = struct.unpack("<Q", length_bytes)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(length_bytes):
            raise ValueError(f"{path}: bad length checksum at byte {i}")
        body = data[i + 12:i + 12 + length]
        (crc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if len(body) != length or crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad data checksum at byte {i}")
        yield body
        i += 16 + length


def read_events(path) -> List[dict]:
    """The summary values of an event file, in order: ``{"wall_time",
    "step", "tag", "value"}`` where ``value`` is a float (``simple_value``)
    or, for an image, ``{"height", "width", "colorspace", "png"}``; the
    ``file_version`` record is skipped. Checksums are verified."""
    out = []
    for body in _records(path):
        wall_time, step, summary = math.nan, 0, None
        for field, _, value in _fields(body):
            if field == 1:
                (wall_time,) = struct.unpack("<d", value)
            elif field == 2:
                step = value - (1 << 64) if value >> 63 else value
            elif field == 5:
                summary = value
        if summary is None:
            continue
        for field, _, value in _fields(summary):
            if field != 1:
                continue
            tag, item = None, None
            for f, _, v in _fields(value):
                if f == 1:
                    tag = v.decode()
                elif f == 2:
                    (item,) = struct.unpack("<f", v)
                elif f == 4:
                    img = {1: "height", 2: "width", 3: "colorspace", 4: "png"}
                    item = {img[k]: x for k, _, x in _fields(v) if k in img}
            out.append({"wall_time": wall_time, "step": step, "tag": tag, "value": item})
    return out
