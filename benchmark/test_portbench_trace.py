"""CPU tests of ``portbench/spans.py`` on synthetic traces: the spans'
device-side mirrors left out of the busy time, idle gaps split into host
waits, queued bubbles and gaps inside one graph launch and named by the
innermost span, the readings of
``trace.read_profile`` kept on a trace without the port's spans, and the
readers of the port's spans and counters silent where the port has none.

    python -m pytest benchmark/test_portbench_trace.py -q
"""
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, spans, trace
from portbench.spans import Event

NEW_READERS = ("draw_ms_per_step", "graph_host_ms_per_step", "issue_ms_per_step",
               "graph_capture_s")


def _graph_window() -> list:
    """One call: draws launched on the host, a graph launch whose three
    kernels run back to back with 2 ns bubbles while the launch call lasts
    (as ``cudaGraphLaunch`` of a large graph does), a late memcpy launched
    after the device ran dry, and the device-side mirrors of both
    prefixes' spans."""
    return [
        Event("bench/call", 0, 100, False), Event("bench/sync", 100, 140, False),
        Event("cy/data/draw", 2, 12, False),
        Event("cudaLaunchKernel", 4, 6, False, corr=1),
        Event("cy/graph/replay", 20, 58, False),
        Event("cudaGraphLaunch", 22, 58, False, corr=2),
        Event("cy/graph/outputs", 58, 70, False),
        Event("cudaMemcpyAsync", 80, 85, False, corr=3),
        Event("draw_kernel", 8, 10, True, corr=1),
        Event("node_a", 30, 40, True, corr=2), Event("node_b", 42, 50, True, corr=2),
        Event("node_c", 52, 60, True, corr=2),
        Event("Memcpy DtoD", 84, 88, True, corr=3),
        Event("bench/call", 8, 88, True, annotation=True),
        Event("cy/graph/replay", 30, 60, True, annotation=True),
    ]


def test_mirrors_of_both_prefixes_are_not_busy():
    t = spans.from_events(_graph_window(), 140e-9)
    assert [n for _, _, n in t.kernels] == ["draw_kernel", "node_a", "node_b", "node_c",
                                            "Memcpy DtoD"]
    assert t.busy_s() == pytest.approx((2 + 10 + 8 + 8 + 4) * 1e-9)
    assert {n for _, _, n in t.spans} == {"bench/call", "bench/sync", "cy/data/draw",
                                          "cy/graph/replay", "cy/graph/outputs"}
    assert t.linked_share() == 1.0 and t.other_mirrors == {}


def test_gaps_split_into_host_waits_and_gaps_inside_a_graph():
    """Each gap named by the innermost span open at its start: 0..8 waits
    for the draw's launch (it ended at 6, after the device went idle); 10..30
    for the graph's launch; 40..42 and 50..52, between nodes of one launch,
    are ``in_graph`` (the launch call lasts to 58, so its end cannot tell a
    queued bubble from a late submission); 60..84 waits for the copy launched
    at 80-85; 88..140, the window's tail, is ended by no op."""
    t = spans.from_events(_graph_window(), 140e-9)
    assert t.gaps() == [(0, 8, "host", "bench/call"), (10, 30, "host", "cy/data/draw"),
                        (40, 42, "in_graph", "cy/graph/replay"),
                        (50, 52, "in_graph", "cy/graph/replay"),
                        (60, 84, "host", "cy/graph/outputs"), (88, 140, "host", "bench/call")]
    assert t.idle_s("in_graph") == pytest.approx(4e-9) and t.idle_s("queued") == 0
    assert t.idle_s("host") == pytest.approx((8 + 20 + 24 + 52) * 1e-9)
    gaps = dict(t.idle_gaps())
    assert gaps["cy/graph/replay: in_graph (2 gaps)"] == pytest.approx(4e-9)
    assert gaps["bench/call: host (2 gaps)"] == pytest.approx(60e-9)
    # the gaps are those trace.Trace cuts, only named and split
    old = trace.Trace(t.kernels, [s for s in t.spans if s[2].startswith("bench/")], t.window_s)
    assert sum(v for _, v in old.idle_gaps()) == pytest.approx(sum(v for _, v in t.idle_gaps()))


def test_a_gap_after_a_launch_that_ended_is_queued():
    """A kernel launched (4-6) long before the device reached it (20): the
    gap before it, behind another launch's kernel, was queued."""
    events = [Event("bench/call", 0, 50, False), Event("cudaLaunchKernel", 1, 2, False, corr=1),
              Event("cudaLaunchKernel", 4, 6, False, corr=2),
              Event("a", 3, 10, True, corr=1), Event("b", 20, 30, True, corr=2)]
    t = spans.from_events(events, 50e-9)
    assert [(a, b, k) for a, b, k, _ in t.gaps()] == [(0, 3, "host"), (10, 20, "queued"),
                                                      (30, 50, "host")]


def test_a_launch_never_found_is_unlinked():
    events = [Event("bench/call", 0, 50, False), Event("k", 10, 20, True, corr=7),
              Event("k", 30, 40, True)]
    t = spans.from_events(events, 50e-9)
    assert [k for _, _, k, _ in t.gaps()] == ["unlinked", "unlinked", "host"]
    assert t.linked_share() == 0.0


class _KinetoEvent:
    """The methods of a profiler's kineto event that the readers call."""

    def __init__(self, e: Event):
        self.e = e

    def name(self):
        return self.e.name

    def start_ns(self):
        return self.e.start

    def duration_ns(self):
        return self.e.end - self.e.start

    def device_type(self):
        return DeviceType.CUDA if self.e.device else DeviceType.CPU

    def correlation_id(self):
        return self.e.corr

    def is_user_annotation(self):
        return self.e.annotation


def _prof(events):
    results = SimpleNamespace(events=lambda: [_KinetoEvent(e) for e in events])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _record(t, updates: int = 4):
    cell = SimpleNamespace(name="semi.cached_k8")
    return harness.Record(cell=cell, device=torch.device("cpu"), trace=t, traced_updates=updates)


def test_a_trace_without_port_spans_reads_as_before():
    """Without ``cy/`` spans (the parent's trace) every reading of the
    device is what ``trace.read_profile`` gives, mirrors of other
    annotations (the optimizer's ``record_function``) kept as it keeps them."""
    events = [e for e in _graph_window() if not e.name.startswith("cy/")]
    events.append(Event("Optimizer.step#RAdam.step", 30, 60, True, annotation=True))
    old, new = (m.read_profile(_prof(events), 140e-9) for m in (trace, spans))
    assert new.kernels == old.kernels and new.spans == old.spans
    assert new.busy_s() == old.busy_s() and new.device_ops() == old.device_ops()
    assert new.other_mirrors == {"Optimizer.step#RAdam.step": pytest.approx(30e-9)}
    for name in ("device_busy_ms_per_step", "idle_pct"):
        assert harness.reader(name)(_record(new)) == harness.reader(name)(_record(old))
    by_span = {}
    for k, v in new.idle_gaps():
        by_span[k.split(": ")[0]] = by_span.get(k.split(": ")[0], 0.0) + v
    assert by_span == pytest.approx({k.split(" (")[0]: v for k, v in old.idle_gaps()})


def test_new_readers_are_silent_on_the_parent(monkeypatch):
    """Where the port has neither span totals nor graph counts, as on the
    parent, each new reader returns None and raises nothing."""
    from contrastyou_tpu_torch.engine import graph
    monkeypatch.setitem(sys.modules, "contrastyou_tpu_torch.tracing", None)
    monkeypatch.delattr(graph, "GRAPH_STATS")
    rec = _record(spans.from_events(_graph_window(), 140e-9))
    for name in NEW_READERS:
        assert harness.reader(name)(rec) is None, name


def test_new_readers_read_the_port(monkeypatch):
    from contrastyou_tpu_torch import tracing
    from contrastyou_tpu_torch.engine import graph
    monkeypatch.setattr(tracing, "SPAN_TOTALS", {
        "cy/data/draw": [32, 8_000_000], "cy/data/sampler": [4, 2_000_000],
        "cy/data/index_copy": [4, 160_000_000],
        "cy/graph/key": [4, 400_000], "cy/graph/inputs": [4, 200_000],
        "cy/graph/replay": [4, 9_000_000], "cy/graph/outputs": [4, 200_000],
        "cy/step/forward": [4, 40_000_000], "cy/step/hooks": [4, 4_000_000],
        "cy/hook/consistency": [4, 3_000_000], "cy/step/backward": [4, 30_000_000],
        "cy/step/optimizer": [4, 5_000_000], "cy/step/commit": [4, 1_000_000]})
    monkeypatch.setattr(graph, "GRAPH_STATS", {**graph.GRAPH_STATS, "step_captures": 1,
                                               "step_capture_s": 1.5, "eval_captures": 2,
                                               "eval_capture_s": 0.7})
    rec = _record(None, updates=4)
    got = {name: harness.reader(name)(rec) for name in NEW_READERS}
    assert got == pytest.approx({"draw_ms_per_step": 2.5, "graph_host_ms_per_step": 0.2,
                                 "issue_ms_per_step": 20.0, "graph_capture_s": 1.5})
    monkeypatch.setattr(graph, "GRAPH_STATS", {**graph.GRAPH_STATS, "step_captures": 0})
    assert harness.reader("graph_capture_s")(rec) is None
