"""Reading a ``torch.profiler`` trace of the window: the device's intervals
(kernels, copies, fills), their union, the idle gaps between them named by
the benchmark span the host was in, and the device time by kernel."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: prefix of the benchmark's own host spans (``torch.profiler.record_function``)
SPAN_PREFIX = "bench/"


def hand_kernel(name: str) -> Optional[str]:
    """The port's hand-written kernel a device event belongs to, by its CUDA
    function's name, or None for a library or PyTorch kernel."""
    if "tapmma_kernel<" in name:   # <Cout, Cin, KIND, ...>: KIND 1 is K2, 2 is K3
        kind = name.split("tapmma_kernel<", 1)[1].split(",")[2].strip()
        return {"1": "K2 upconv3x3_stats", "2": "K3 upconv3x3_dx"}.get(kind, "K1 conv3x3_stats")
    for fn, label in (("conv1ch_kernel<", "K1 conv3x3_stats"), ("dw_mma_kernel<", "C1 conv_dw_taps"),
                      ("dw1ch_kernel<", "C1 conv_dw_taps"), ("convbwd_kernel<", "C2 conv3x3_bwd_fused"),
                      ("supcon_", "D1/D2 supcon"), ("iic_joints_bwd", "E2 iic_joints_bwd"),
                      ("iic_joints", "E1 iic_joints"),
                      ("sum_partials(", "partial sums of C1/C2, E1"), ("sum_dw(", "partial sums of E2")):
        if fn in name:
            return label
    return None


@dataclass
class Trace:
    """The device's intervals [start, end) in ns and their names, the host
    spans, and the traced window's length by the host clock."""
    kernels: List[Tuple[int, int, str]]
    spans: List[Tuple[int, int, str]]
    window_s: float

    def busy_s(self) -> float:
        total, end = 0, None
        for s, e, _ in sorted(self.kernels):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def device_seconds(self, labels) -> float:
        """Device seconds of the kernels :func:`hand_kernel` names one of
        ``labels``."""
        return sum((e - s) * 1e-9 for s, e, n in self.kernels if hand_kernel(n) in labels)

    def count(self, label: str) -> int:
        return sum(1 for _, _, n in self.kernels if hand_kernel(n) == label)

    def has(self, fragment: str) -> bool:
        return any(fragment in n for _, _, n in self.kernels)

    def device_ops(self, top: int = 10) -> List[list]:
        """The ``top`` device items by total seconds, hand kernels by label."""
        totals: Dict[str, float] = defaultdict(float)
        for s, e, n in self.kernels:
            totals[hand_kernel(n) or n[:96]] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds between the device's intervals inside the spans,
        summed by the innermost benchmark span open at each gap's start."""
        if not self.kernels or not self.spans:
            return []
        lo = min(s for s, _, _ in self.spans)
        hi = max(e for _, e, _ in self.spans)
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.kernels):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        spans = sorted(self.spans)
        starts = [s for s, _, _ in spans]
        totals: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            name = "outside the spans"
            for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
                s, e, n = spans[i]
                if s <= a < e:
                    name = n
                    break
            totals[name] += (b - a) * 1e-9
            counts[name] += 1
        return [[f"{k} ({counts[k]} gaps)", v]
                for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def read_profile(prof, window_s: float) -> Trace:
    """The device intervals and benchmark spans of a finished profiler."""
    from torch.autograd import DeviceType
    kernels, spans = [], []
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith(SPAN_PREFIX):    # a span's device-side mirror
                    kernels.append((s, s + d, e.name()))
            elif e.name().startswith(SPAN_PREFIX):
                spans.append((s, s + d, e.name()))
    except AttributeError:
        for e in prof.events():
            s, d = int(e.time_range.start * 1e3), int(e.time_range.elapsed_us() * 1e3)
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith(SPAN_PREFIX):
                    kernels.append((s, s + d, e.name))
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((s, s + d, e.name))
    return Trace(kernels, spans, window_s)
