"""One run of one cell: set-up, the measured window, the traced window
where asked, the check against the reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``: the
configuration's file, ``traffic/<traffic>.json`` (whose ``kind`` picks the
runner, the class ``Runner`` of ``portbench/runners/<kind>.py``),
``checks/<workload>.json`` (the limits of the comparison) and
``metrics/<metric>.py`` (each metric's reader, a ``read(record)`` that
returns a number or None).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check
from .trace import Trace, read_profile

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "contrastyou_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, manifest: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(ROOT / configs[w["config"]]["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "checks" / f"{workload}.json")["limits"],
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def runner_class(kind: str):
    """The class ``Runner`` of ``portbench/runners/<kind>.py``."""
    return importlib.import_module(f"portbench.runners.{kind}").Runner


def make_runner(cell: Cell, seed: int, device, **kwargs):
    return runner_class(cell.traffic["kind"])(cell, seed, device, **kwargs)


@dataclass
class Record:
    """What a metric's reader reads: the run's host-clock spans, its window,
    the traced window and the port's counters."""
    cell: Cell
    device: torch.device
    setup_s: float = 0.0
    import_s: float = 0.0
    build_s: float = 0.0
    capture_s: Optional[float] = None
    window_s: float = 0.0
    updates: int = 0
    slices: int = 0
    #: the device's peak of allocated bytes from the process's start to the
    #: window's end, and over the window alone (from a reset at its start)
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    #: the traced window and what the port counted in it
    trace: Optional[Trace] = None
    traced_updates: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    #: the untraced rest of a traced run: (updates, seconds)
    rest: Optional[tuple] = None
    sites: list = field(default_factory=list)
    model_flops: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    from contrastyou_tpu_torch.engine.trainer import kernel_launches
    return dict(kernel_launches())


def run_window(runner, rec: Record, seconds: float, traced_calls: int, trace: bool) -> None:
    """The measured window (``seconds`` of calls, ended by a synchronize);
    with ``trace``, its first ``traced_calls`` calls under the profiler.
    The device's peak memory is read at the window's start, then reset."""
    dev = rec.device
    K = runner.updates_per_call
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    calls = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        before = _launches()
        with profile(activities=acts) as prof:
            t_traced = time.perf_counter()
            for _ in range(traced_calls):
                with torch.profiler.record_function("bench/call"):
                    runner.call()
            with torch.profiler.record_function("bench/sync"):
                _sync(dev)
            traced_s = time.perf_counter() - t_traced
        calls = traced_calls
        after = _launches()
        rec.launches = {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}
        rec.traced_updates = traced_calls * K
        rec.trace = read_profile(prof, traced_s)
        del prof
        t_rest = time.perf_counter()
        rest_calls = 0
        while time.perf_counter() - t0 < seconds or rest_calls == 0:
            runner.call()
            rest_calls += 1
        _sync(dev)
        rec.rest = (rest_calls * K, time.perf_counter() - t_rest)
        calls += rest_calls
    else:
        while time.perf_counter() - t0 < seconds:
            runner.call()
            calls += 1
        _sync(dev)
    rec.window_s = time.perf_counter() - t0
    rec.updates = calls * K
    rec.slices = rec.updates * runner.slices_per_update
    if dev.type == "cuda":
        rec.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        rec.peak_bytes = max(setup_peak, rec.window_peak_bytes)


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def check_numbers(runner, prog: check.Readings, n_calls: int) -> Dict[str, float]:
    """Free the program, run the float32 reference (TF32 off) over the
    compared calls, and return the numbers compared."""
    from .reference import Precision
    runner.free()
    if runner.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return check.gaps(prog, runner.reference(Precision("float32"), n_calls))


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device=None, sizes: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
        fault: Optional[str] = None, manifest: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result line's object. ``sizes``,
    ``dtype`` and ``fault`` are for the tests and the fault runs."""
    import contrastyou_tpu_torch.main  # noqa: F401  (the program's import, timed)
    cell = load_cell(workload, manifest)
    device = torch.device(device or "cuda")
    rec = Record(cell=cell, device=device, import_s=time.perf_counter() - t_start)

    t = time.perf_counter()
    runner = make_runner(cell, seed, device, dtype=dtype, sizes=sizes, fault=fault)
    runner.build()
    _sync(device)
    rec.build_s = time.perf_counter() - t
    n_check = int(cell.traffic["check_calls"])
    t = time.perf_counter()
    prog = runner.first_calls(n_check)
    if runner.captures:
        rec.capture_s = sum(runner.call_seconds[:2])   # the eager warm-up and the capture
    _sync(device)
    rec.setup_s = time.perf_counter() - t_start

    run_window(runner, rec, seconds, int(cell.traffic.get("traced_calls", 1)), trace)
    rec.sites = runner.sites()
    rec.model_flops = runner.model_flops()

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    numbers = check_numbers(runner, prog, n_check)
    correct = check.verdict(numbers, cell.limits)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(rec.peak_bytes)}
    result = {"correct": bool(correct), "attempted": rec.updates,
              "failed": 0 if correct else rec.updates, "metrics": metrics, "device": info,
              "window_peak_bytes": int(rec.window_peak_bytes)}
    if trace:
        info["busy_s"] = rec.trace.busy_s()
        info["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = {k: {"value": _num(numbers[k]), "limit": cell.limits[k]}
                        for k in cell.limits}
    return result


def _num(x: float):
    return x if math.isfinite(x) else str(x)
