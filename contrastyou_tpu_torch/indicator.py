"""Progress display of the train, pretrain, monitor and adversarial loops
(counterpart of contrastyou_tpu/indicator.py, without tqdm).

:class:`Indicator` wraps the loop's iterable. On a terminal it redraws one
line with ``\\r`` (at most every ``mininterval`` seconds, and at the end) and
clears it at :meth:`close`, as the JAX loops' ``leave=False`` bars; on any
other stream it writes nothing while the loop runs and one line at
:meth:`close`. A line reads ``<desc>: <n>/<total> [<elapsed>, <rate>,
<postfix>]``. The postfix is JAX's: :meth:`set_postfix_statics` flattens the
nested meter statistics (``utils.general.flatten_dict``), keeps a key's
last component unless it has three or more, formats each value as JAX's
``_fmt`` and shows the first 8, recomputed only every ``update_every``
calls. The indicator itself reads no meter: the loops hand it statistics
where JAX's train loop does (every tenth step and the last), so it adds no
device synchronization a step.
"""
from __future__ import annotations

import logging
import sys
import time
import typing as t

from .utils.general import flatten_dict

__all__ = ["Indicator", "format_value"]

logger = logging.getLogger(__name__)


def format_value(value) -> str:
    """JAX's ``_fmt``: 0 as ``0``, magnitudes below 1e-3 or from 1e4 in
    ``.2e``, the rest in ``.3f``; a non-number as ``str``."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return str(value)
    if v == 0:
        return "0"
    if abs(v) < 1e-3 or abs(v) >= 1e4:
        return f"{v:.2e}"
    return f"{v:.3f}"


class Indicator:
    def __init__(self, iterable: t.Sized, *, desc: str = "", update_every: int = 20,
                 stream: t.Optional[t.TextIO] = None, mininterval: float = 0.1):
        self._iterable = iterable
        self.total, self.n, self.desc = len(iterable), 0, desc
        self.postfix = ""
        self._stream = sys.stderr if stream is None else stream
        isatty = getattr(self._stream, "isatty", None)
        self._tty = bool(isatty and isatty())
        self._update_every = max(int(update_every), 1)
        self._count = 0
        self._last_stats: dict = {}
        self._mininterval = float(mininterval)
        self._start = self._last_draw = time.perf_counter()
        self._closed = False

    # --- the loop ---------------------------------------------------------
    def __iter__(self):
        try:
            for item in self._iterable:
                yield item
                self.update()
        finally:
            self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.perf_counter()
        if self._tty and (now - self._last_draw >= self._mininterval or self.n == self.total):
            self._last_draw = now
            self._stream.write("\r" + self.line() + "\x1b[K")
            self._stream.flush()

    def set_description(self, desc: str) -> None:
        self.desc = desc

    def set_postfix(self, values: t.Mapping[str, str]) -> None:
        """``key=value, ...`` after the counts (tqdm's postfix)."""
        self.postfix = ", ".join(f"{k}={str(v).strip()}" for k, v in values.items())

    def set_postfix_statics(self, statistics: t.Mapping, *, force_update: bool = False) -> None:
        """``statistics``: nested ``{group: {meter: value or dict}}``; see the
        module docstring."""
        self._count += 1
        if not force_update and self._count % self._update_every != 1:
            return
        flat = flatten_dict(dict(statistics))
        self._last_stats = flat
        shown = {k.split("/")[-1] if len(k.split("/")) < 3 else k: format_value(v)
                 for k, v in flat.items() if not isinstance(v, str)}
        self.set_postfix(dict(list(shown.items())[:8]))

    def log_result(self, prefix: str = "") -> str:
        """Log (INFO) and return ``prefix`` + every last statistic as
        ``key=value``; nothing before the first :meth:`set_postfix_statics`."""
        if not self._last_stats:
            return ""
        text = prefix + ", ".join(f"{k}={format_value(v)}" for k, v in self._last_stats.items())
        logger.info("%s", text)
        return text

    # --- the line ---------------------------------------------------------
    def line(self) -> str:
        elapsed = time.perf_counter() - self._start
        rate = f"{self.n / elapsed:.2f}it/s" if elapsed > 0 and self.n else "?it/s"
        tail = f", {self.postfix}" if self.postfix else ""
        return (f"{self.desc + ': ' if self.desc else ''}{self.n}/{self.total} "
                f"[{elapsed:.1f}s, {rate}{tail}]")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._tty:
            self._stream.write("\r\x1b[K")
        else:
            self._stream.write(self.line() + "\n")
        self._stream.flush()
