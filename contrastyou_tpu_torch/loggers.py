"""Console logging of the port (counterpart of contrastyou_tpu/loggers.py).

The package logs through the standard ``logging`` module, one logger a
module. :func:`setup_logging` gives the ``contrastyou_tpu_torch`` logger one
console handler: its level from ``LOG_LEVEL`` (or ``LOGURU_LEVEL``; a name
or a number, INFO by default), the TRACE (5) and SUCCESS (25) levels
named, and the JAX logger's line ``time | LEVEL | module:line - message``,
coloured by level when the stream is a terminal.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional, TextIO

__all__ = ["TRACE", "SUCCESS", "console_level", "setup_logging"]

TRACE = 5
SUCCESS = 25
logging.addLevelName(TRACE, "TRACE")
logging.addLevelName(SUCCESS, "SUCCESS")

_COLORS = {"TRACE": "\x1b[36m", "DEBUG": "\x1b[34m", "INFO": "\x1b[37m",
           "SUCCESS": "\x1b[32m", "WARNING": "\x1b[33m", "ERROR": "\x1b[31m",
           "CRITICAL": "\x1b[41m"}
_RESET = "\x1b[0m"
#: the package's root logger
PACKAGE = "contrastyou_tpu_torch"


class _Formatter(logging.Formatter):
    def __init__(self, colored: bool):
        super().__init__()
        self._colored = colored

    def format(self, record: logging.LogRecord) -> str:
        line = (f"{self.formatTime(record, '%Y-%m-%d %H:%M:%S')} | {record.levelname:<8} | "
                f"{record.name}:{record.lineno} - {record.getMessage()}")
        if record.exc_info:
            line += "\n" + self.formatException(record.exc_info)
        if self._colored:
            return f"{_COLORS.get(record.levelname, '')}{line}{_RESET}"
        return line


def console_level() -> int:
    """The console level ``LOG_LEVEL`` (else ``LOGURU_LEVEL``) names: a
    level name (TRACE and SUCCESS included) or a number; INFO when unset."""
    level = os.environ.get("LOG_LEVEL", os.environ.get("LOGURU_LEVEL", "INFO")).strip()
    if level.isdigit():
        return int(level)
    value = logging.getLevelName(level.upper())
    if not isinstance(value, int):
        raise ValueError(f"LOG_LEVEL={level!r} names no logging level")
    return value


def setup_logging(stream: Optional[TextIO] = None) -> logging.Logger:
    """The package logger with one console handler on ``stream`` (stderr
    by default), replacing one an earlier call added."""
    stream = sys.stderr if stream is None else stream
    log = logging.getLogger(PACKAGE)
    for h in [h for h in log.handlers if getattr(h, "_console", False)]:
        log.removeHandler(h)
    handler = logging.StreamHandler(stream)
    handler._console = True
    handler.setLevel(console_level())
    isatty = getattr(stream, "isatty", None)
    handler.setFormatter(_Formatter(colored=bool(isatty and isatty())))
    log.addHandler(handler)
    log.setLevel(handler.level)
    return log
