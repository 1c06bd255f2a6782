"""Host spans of the port on the profiler's clock.

``span("cy/<layer>/<what>")`` marks a block at a layer boundary (the data
draws, the CUDA graph's key, copies and replays, the step's forward, hooks,
backward and optimizer, the trainer's calls). While a ``torch.profiler``
session records (the benchmark's traced window, ``Trainer.profile``'s
epoch, ``profile_step``, an operator's own session), the span is a CPU
event of the trace, nested in the span that caused it, on the clock of the
device's intervals; otherwise ``span`` returns one shared no-op context, at
the cost of one flag test. There is no knob: the profiler turns them on.

The event is a ``torch._C._profiler._RecordFunctionFast`` record: it nests
and times as ``torch.profiler.record_function`` does, but makes no
``gpu_user_annotation`` mirror on the device's timeline, so a reader that
unions the device's events counts no span as device time. A span never
reads a device value, allocates on the device or builds its name: names
are literals, or made once when a step is built (:func:`hook_span_names`).

While a session records, each span also adds its host time to
:data:`SPAN_TOTALS`, for readers that hold the session's counts but not its
events (the benchmark's per-layer metrics).
"""
from __future__ import annotations

import contextlib
import time
import typing as t

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "SPAN_TOTALS", "span", "hook_span_names"]

#: the prefix of every span name of the port
PREFIX = "cy/"
#: span name -> [count, host nanoseconds], summed while a profiler recorded
SPAN_TOTALS: t.Dict[str, t.List[int]] = {}

_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "record", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = torch._C._profiler._RecordFunctionFast(self.name)
        self.record.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.record.__exit__(*exc)
        total = SPAN_TOTALS.setdefault(self.name, [0, 0])
        total[0] += 1
        total[1] += ns
        return False


def span(name: str):
    """A context marking ``name`` (``cy/...``) while a profiler records; the
    shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def hook_span_names(hooks) -> t.Dict[str, str]:
    """``cy/hook/<name>`` of each hook, made once when a step is built."""
    return {h.name: f"{PREFIX}hook/{h.name}" for h in hooks}
