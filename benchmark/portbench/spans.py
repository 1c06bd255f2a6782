"""Reading the traced window with the port's own host spans: the successor
of ``trace.read_profile``, read by ``idle_split.py`` and by the per-layer
metrics of the port's spans and counters.

:func:`read_profile` returns a :class:`SpanTrace`, a ``trace.Trace`` whose
readings of the device (``busy_s``, ``device_seconds``, ``device_ops``)
are those of ``trace.read_profile`` on a trace without ``cy/`` spans. It
differs in three ways:
- the spans are those of the benchmark (``bench/``) and of the port
  (``cy/``, ``contrastyou_tpu_torch/tracing.py``), and the device-side
  mirrors of both are left out of the device's intervals;
- each device interval keeps the end of its launch, the CUDA runtime call
  of the same correlation id (``cudaLaunchKernel``, ``cudaGraphLaunch``,
  ``cudaMemcpyAsync``, ...);
- each idle gap ``[a, b)`` is ``in_graph`` when the ops on both sides of
  it came from one launch (the nodes of one CUDA graph's replay, whose
  ``cudaGraphLaunch`` returns only when most of the replay has run: the
  launch call's end says nothing of when a node was submitted, so such a
  gap may be a bubble between queued nodes or a wait for CUDA to
  submit the next one, and the trace does not tell which); otherwise a
  host wait when the launch of the op that ends it ended after ``a`` (the
  device had nothing queued), a queued bubble when it ended before (the gap
  between dependent ops already submitted), ``unlinked`` where no launch
  was found; each gap is named by the innermost span of either prefix open
  on the host at ``a``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .trace import Trace

#: prefixes of the host spans: the benchmark's and the port's
SPAN_PREFIXES = ("bench/", "cy/")
#: the prefix of the CUDA API calls (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...)
LAUNCH_PREFIX = "cu"


class Event(NamedTuple):
    """One event of the trace: its name, [start, end) in ns, whether it lies
    on the device's timeline, the correlation id that links a launch call
    to its device op (0: none) and whether it is an annotation's
    device-side mirror."""
    name: str
    start: int
    end: int
    device: bool
    corr: int = 0
    annotation: bool = False


@dataclass
class SpanTrace(Trace):
    #: the end of each device interval's launch call (ns), or None
    launch_ends: List[Optional[int]] = field(default_factory=list)
    #: each device interval's correlation id (0: none)
    corrs: List[int] = field(default_factory=list)
    #: device-side mirrors of other annotations, kept in the intervals as
    #: ``trace.read_profile`` keeps them: name -> seconds
    other_mirrors: Dict[str, float] = field(default_factory=dict)

    def span_at(self, t: int, _starts: Optional[list] = None) -> str:
        """The innermost span open at ``t`` (the latest started)."""
        spans = sorted(self.spans)
        starts = _starts if _starts is not None else [s for s, _, _ in spans]
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, n = spans[i]
            if s <= t < e:
                return n
        return "outside the spans"

    def gaps(self) -> List[Tuple[int, int, str, str]]:
        """(start, end, kind, span) of every idle gap between the device's
        intervals inside the spans' extent, as ``Trace.idle_gaps`` cuts
        them; ``kind`` is ``host``, ``queued``, ``in_graph`` or ``unlinked``
        (see the module docstring). The gap after the last interval, which no op ends, is a
        host wait."""
        if not self.kernels or not self.spans:
            return []
        lo = min(s for s, _, _ in self.spans)
        hi = max(e for _, e, _ in self.spans)
        # [start, end, the op that opens the block, the op that ends last in it]
        blocks: List[list] = []
        for i in sorted(range(len(self.kernels)), key=lambda i: self.kernels[i][:2]):
            s, e, _ = self.kernels[i]
            if blocks and s <= blocks[-1][1]:
                if e > blocks[-1][1]:
                    blocks[-1][1], blocks[-1][3] = e, i
            else:
                blocks.append([s, e, i, i])
        starts = [s for s, _, _ in sorted(self.spans)]
        out, prev, last = [], lo, None
        for s, e, i, j in blocks + [[hi, hi, None, None]]:
            a, b = max(prev, lo), min(s, hi)
            if b > a:
                out.append((a, b, self._kind(last, i, a), self.span_at(a, starts)))
            prev, last = max(prev, e), j
        return out

    def _kind(self, before: Optional[int], after: Optional[int], a: int) -> str:
        """The kind of the gap from op ``before`` (at ``a``) to op ``after``."""
        if after is None:
            return "host"
        corr = self.corrs[after] if self.corrs else 0
        if corr and before is not None and self.corrs[before] == corr:
            return "in_graph"
        launched = self.launch_ends[after]
        return "unlinked" if launched is None else "host" if launched > a else "queued"

    def idle_s(self, kind: str) -> float:
        return sum(b - a for a, b, k, _ in self.gaps() if k == kind) * 1e-9

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds by the innermost span open at each gap's start and
        by the gap's kind, largest first."""
        totals: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for a, b, kind, name in self.gaps():
            totals[f"{name}: {kind}"] += (b - a) * 1e-9
            counts[f"{name}: {kind}"] += 1
        return [[f"{k} ({counts[k]} gaps)", v]
                for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def linked_share(self) -> float:
        """The share of the device intervals whose launch was found."""
        return sum(x is not None for x in self.launch_ends) / max(len(self.launch_ends), 1)


def from_events(events: Sequence[Event], window_s: float) -> SpanTrace:
    """The :class:`SpanTrace` of ``events``."""
    launch_end: Dict[int, int] = {}
    for e in events:
        if not e.device and e.corr and e.name.startswith(LAUNCH_PREFIX):
            launch_end[e.corr] = max(launch_end.get(e.corr, e.end), e.end)
    kernels, launches, corrs, spans = [], [], [], []
    mirrors: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.device:
            if e.name.startswith(SPAN_PREFIXES):         # a span's device-side mirror
                continue
            if e.annotation:
                mirrors[e.name] += (e.end - e.start) * 1e-9
            kernels.append((e.start, e.end, e.name))
            launches.append(launch_end.get(e.corr) if e.corr else None)
            corrs.append(e.corr)
        elif e.name.startswith(SPAN_PREFIXES):
            spans.append((e.start, e.end, e.name))
    return SpanTrace(kernels, spans, window_s, launches, corrs, dict(mirrors))


def _events(prof) -> List[Event]:
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        device = e.device_type() == DeviceType.CUDA
        out.append(Event(e.name(), s, s + e.duration_ns(), device, int(e.correlation_id()),
                         device and bool(e.is_user_annotation())))
    return out


def read_profile(prof, window_s: float) -> SpanTrace:
    """The device intervals, their launches and both prefixes' spans of a
    finished profiler."""
    return from_events(_events(prof), window_s)


# --- the port's own counts, read by the per-layer metrics ------------------
def span_ms_per_update(rec, names: Sequence[str] = (), prefix: str = "") -> Optional[float]:
    """Host ms an update in the port's spans named ``names`` or starting
    with ``prefix``, over the traced window (``tracing.SPAN_TOTALS``, summed
    while the profiler records); None where the port has no spans or
    none of these ran."""
    try:
        from contrastyou_tpu_torch.tracing import SPAN_TOTALS
    except ImportError:
        return None
    ns = [v[1] for k, v in SPAN_TOTALS.items() if k in names or (prefix and k.startswith(prefix))]
    if not ns or not rec.traced_updates:
        return None
    return sum(ns) * 1e-6 / rec.traced_updates
