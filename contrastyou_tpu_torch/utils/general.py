"""General helpers (counterpart of contrastyou_tpu/utils/general.py)."""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
from itertools import repeat
from pathlib import Path
from typing import Callable, Iterable, Mapping

__all__ = ["class_name", "ntuple", "path2Path", "safe_save", "ignore_exception",
           "flatten_dict"]

logger = logging.getLogger(__name__)


def class_name(obj) -> str:
    return obj.__class__.__name__


def ntuple(n: int) -> Callable:
    """A scalar (or string) -> ``n`` copies; any other iterable -> a tuple of
    its items."""
    def parse(x):
        if isinstance(x, Iterable) and not isinstance(x, str):
            return tuple(x)
        return tuple(repeat(x, n))
    return parse


def path2Path(path) -> Path:
    return path if isinstance(path, Path) else Path(path)


def safe_save(save_fn: Callable[[str], None], target_path) -> None:
    """``save_fn(tmp)`` into a temporary file beside ``target_path``, then an
    atomic move onto it; the temporary file never outlives the call."""
    target_path = path2Path(target_path)
    target_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(target_path.parent), suffix=".tmp")
    os.close(fd)
    try:
        save_fn(tmp)
        shutil.move(tmp, str(target_path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class ignore_exception:
    """Context manager that swallows the listed exception types (every
    ``Exception`` when none is listed), logging a warning with ``log``."""

    def __init__(self, *exceptions, log: bool = False):
        self._exceptions = exceptions or (Exception,)
        self._log = log

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and issubclass(exc_type, self._exceptions):
            if self._log:
                logger.warning("ignored %s: %s", exc_type.__name__, exc)
            return True
        return False


def flatten_dict(d: Mapping, parent_key: str = "", sep: str = "/") -> dict:
    """Nested mappings -> one level, keys joined with ``sep``."""
    items: list = []
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, Mapping):
            items.extend(flatten_dict(v, new_key, sep).items())
        else:
            items.append((new_key, v))
    return dict(items)
