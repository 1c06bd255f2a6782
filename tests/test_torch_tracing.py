"""The port's host spans (contrastyou_tpu_torch/tracing.py): under
``torch.profiler`` a ``semi`` call at K = 1 and K = 2 and a pretraining call
emit the documented ``cy/`` names, each hook's ``cy/hook/<name>`` inside
``cy/step/hooks``; without a profiler a span is one shared no-op context that
never opens a record. Tiny sizes (max_channel 16, 16 x 16 crops, float32)."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from contrastyou_tpu_torch import tracing
from contrastyou_tpu_torch.engine.trainer import graph_stats
from contrastyou_tpu_torch.main import build_pretrain_run, build_semi_run, parse_config

TINY = dict(device="cpu", dtype=torch.float32, raw_size=20, crop=16, max_channel=16)
STEP = ["cy/step/forward", "cy/step/hooks", "cy/step/backward", "cy/step/optimizer",
        "cy/step/commit"]


def _semi(K: int):
    cfg = parse_config(["-o", "Trainer.name=semi", f"Trainer.unroll_steps={K}"])
    run = build_semi_run(cfg, n_slices=8, **TINY)
    return run, lambda: run.step(run.state, run.generator, 0, run.host_rng)


def _pretrain():
    run = build_pretrain_run(parse_config(["-o", "Trainer.name=pretrain_decoder"]),
                             n_scans=6, **TINY)
    return run, lambda: run.step(run.state, run.generator)


@pytest.mark.parametrize("kind,expected", [
    ("semi-1", ["cy/data/draw"] * 2 + STEP[:2] + ["cy/hook/consistency"] + STEP[2:]),
    ("semi-2", ["cy/data/draw"] * 3 + STEP[:2] + ["cy/hook/consistency"] + STEP[2:]
     + ["cy/data/draw"] + STEP[:2] + ["cy/hook/consistency"] + STEP[2:]),
    ("pretrain", ["cy/data/sampler", "cy/data/index_copy", "cy/data/draw"] + STEP[:2]
     + ["cy/hook/infonce/Conv5/partition", "cy/hook/infonce/Up_conv2/self"] + STEP[2:])])
def test_spans_name_the_layers_under_the_profiler(kind, expected):
    """One call under the profiler: the ``cy/`` CPU events in start order
    (at K = 2 both steps' draws come first, then the K steps, each drawing
    its crops; pretraining's sampler, its index copy and draws, then the
    step), the hooks'
    spans inside ``cy/step/hooks``, the others inside no span (no CUDA
    graph on the CPU), and :data:`tracing.SPAN_TOTALS` counting each one."""
    run, call = _semi(int(kind[-1])) if kind.startswith("semi") else _pretrain()
    before = {k: c for k, (c, _) in tracing.SPAN_TOTALS.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    # the profiler's own events (building its FunctionEvents costs seconds here)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(tracing.PREFIX))
    assert [n for _, _, n in spans] == expected
    for s, e, n in spans:
        inside = [o for os_, oe, o in spans if os_ <= s and e <= oe and (os_, oe) != (s, e)]
        assert inside == (["cy/step/hooks"] if n.startswith("cy/hook/") else []), n
    counted = {k: c - before.get(k, 0) for k, (c, _) in tracing.SPAN_TOTALS.items()}
    assert {k: v for k, v in counted.items() if v} == {n: expected.count(n) for n in expected}


def test_spans_are_one_noop_without_a_profiler(monkeypatch):
    """Without a profiler ``span`` returns one shared context whatever the
    name, and a ``semi`` call opens no span's record (the classes a span
    could open raise here; the optimizer's own ``record_function`` runs
    either way), adds to no span total and, on the CPU, to no graph count."""
    def refuse(*args, **kwargs):
        raise AssertionError("a record was opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("cy/data/draw") is tracing.span("cy/step/forward")
    totals, graphs = {k: list(v) for k, v in tracing.SPAN_TOTALS.items()}, graph_stats()
    _, call = _semi(1)
    call()
    assert tracing.SPAN_TOTALS == totals and graph_stats() == graphs
    assert set(graphs) == {"step_warmups", "step_captures", "step_replays", "step_capture_s",
                           "eval_warmups", "eval_captures", "eval_replays", "eval_capture_s"}
