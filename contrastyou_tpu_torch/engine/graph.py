"""CUDA graphs of the port: one per call of K train steps (the counterpart
of JAX's ``build_unrolled_train_step`` / ``build_cached_train_step(unroll=K)``,
which compile K steps into one XLA program) and one per chunk of eval
batches (JAX's ``build_scanned_eval_step``, a ``lax.scan`` over the chunk).

:class:`StepGraph` wraps ``body(state, inputs, epoch) -> outputs``, the K
steps of one call. On the CPU, with K = 1, or where it is built with
``capture=False``, it calls ``body``: on W > 1 ranks the K steps run as a
loop, because the ranks' collectives (gloo's host round trips; NCCL with
one rank a card cannot be checked on a one-card machine) are not captured.
On a CUDA device otherwise:

- the first call of a shape runs ``body`` eagerly on a side stream (the
  warm-up: lazily made state such as the optimizer's moments, cuBLAS and
  cuDNN handles are made outside the capture);
- the next call captures ``body`` into a ``torch.cuda.CUDAGraph`` on static
  copies of ``inputs``, then replays it; later calls copy ``inputs`` into
  those buffers and replay. A new shape, another state object or another
  ``epoch`` (hooks read it as a host number) recaptures, without a second
  warm-up.

Everything a step changes must be changed in place on tensors that live
across calls (a hook's new state is written into its old tensors by
``engine/steps.py`` ``commit_state``), and every per-step scalar must be
computed on the device: the optimizer's (``engine/optim.py``), the mean
teachers' ``ema_step`` (``hooks/mt.py``). The draws of each call (the device cache's indices and
crops, the transforms, the hooks' draws from the generator and from the
host) are made before the replay and reach the graph as inputs, so no draw
is frozen into it. A capture that fails, or that finds the step replacing a
state tensor or advancing host state, raises and names the path: K > 1 on
one process on the card never runs eagerly in place of the graph (on W > 1
ranks it runs eagerly by construction, and its ``replays`` stay 0).

:class:`EvalGraph` wraps ``body(model, *inputs) -> outputs``, the eval
forwards of one chunk. On the CPU it calls ``body``; on a CUDA device it
keeps one graph per chunk shape and eval model: the first call of a shape
is the eager warm-up, the second captures and replays, later calls copy the
inputs into the graph's and replay, across passes and epochs (eval reads no
host epoch). A model whose parameter or buffer tensors are no longer the
objects captured (a warm start that replaced them) is recaptured, and a
capture that fails raises naming the path.

The graphs of one trainer capture into one memory pool (:class:`GraphPool`):
a graph's intermediates are free between its replays, so another graph's
capture reuses them, and every replay's outputs are copied out before
anything else runs. A graph is replaced only after its successor is
captured, so the pool always has a live graph.

``state.step`` advances by K a call. The hand kernels' launch counters
(``ops`` ``LAUNCHES``) count on the host where a wrapper launches; a replay
launches without calling the wrappers, so the launches a capture recorded
are kept (``launches_per_graph``) and added to the counters at each replay:
``kernel_launches()`` reads replays x captured, for both kinds of graph.

:data:`GRAPH_STATS` counts, over the process, the step and eval graphs'
warm-ups, captures and replays and the host seconds of their captures
(``step_capture_s``, ``eval_capture_s``: from ``torch.cuda.graph``'s entry
to its exit, no synchronize added), for a whole run's ``launches.json`` and
the benchmark; a :class:`StepGraph` keeps its own ``captures`` and
``capture_s``, which the trainer's train ``timing`` records read, as its
eval records read their :class:`EvalGraph`'s ``replays``. The phases of a
call are host spans (``tracing.py``):
``cy/graph/warmup``, ``cy/graph/capture``, ``cy/graph/key`` (the state's
fingerprint walk and the key compare), ``cy/graph/inputs`` (the copies into
the static inputs), ``cy/graph/replay`` (the launch and the counters) and
``cy/graph/outputs`` (the outputs' copies).
"""
from __future__ import annotations

import time
import typing as t

import torch
from torch.utils import _pytree as pytree

from ..tracing import span

__all__ = ["GRAPH_STATS", "GraphPool", "StepGraph", "EvalGraph"]

#: the process's graph warm-ups, captures and replays and the host seconds
#: spent capturing, by kind
GRAPH_STATS: t.Dict[str, float] = {
    "step_warmups": 0, "step_captures": 0, "step_replays": 0, "step_capture_s": 0.0,
    "eval_warmups": 0, "eval_captures": 0, "eval_replays": 0, "eval_capture_s": 0.0}


def _launch_counters() -> tuple:
    from ..ops import convblock, iic, supcon
    return convblock.LAUNCHES, supcon.LAUNCHES, iic.LAUNCHES


def _walk(prefix: str, node, out: dict) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(f"{prefix}[{k!r}]", v, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(f"{prefix}[{i}]", v, out)
    else:
        out[prefix] = node


def _state_leaves(state) -> dict:
    """path -> leaf of everything a step may change: the model's tensors,
    the optimizer's per-parameter state and its counters, the hook states."""
    leaves = {f"model.{k}": v for k, v in state.model.state_dict(keep_vars=True).items()}
    opt = state.optimizer
    for i, st in enumerate(opt.state.values()):
        _walk(f"optimizer.state[{i}]", st, leaves)
    _walk("optimizer", getattr(opt, "_counters", {}), leaves)
    _walk("hook_states", state.hook_states, leaves)
    return leaves


def _identities(leaves: dict) -> dict:
    """path -> the tensor's identity and storage, or a host value."""
    return {k: (id(v), v.data_ptr()) if isinstance(v, torch.Tensor) else v
            for k, v in leaves.items()}


def _fingerprint(state) -> dict:
    return _identities(_state_leaves(state))


def _model_fingerprint(model: torch.nn.Module) -> tuple:
    return tuple(_identities(model.state_dict(keep_vars=True)).items())


def _shape_key(leaves: list) -> tuple:
    return tuple((tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
                 else ("host", v) for v in leaves)


class GraphPool:
    """The memory pool the graphs sharing it capture into, made at the first
    capture (the CPU never asks for one)."""

    def __init__(self):
        self._handle = None

    def __call__(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _warm_up(fn, kind: str):
    GRAPH_STATS[f"{kind}_warmups"] += 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with span("cy/graph/warmup"), torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


def _capture(fn, pool: GraphPool, failed: str, kind: str) -> tuple:
    """Capture ``fn()`` into a new graph in ``pool`` -> (graph, its outputs,
    the hand kernels' launches it recorded, a dict per counter, the host
    seconds of the capture); the counters are left as they were, the
    seconds added to ``GRAPH_STATS`` under ``kind``. A capture that fails
    raises ``RuntimeError`` starting with ``failed``."""
    counters = _launch_counters()
    counts = [dict(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with span("cy/graph/capture"), torch.cuda.graph(graph, pool=pool(),
                                                        capture_error_mode="thread_local"):
            out = fn()
    except Exception as e:
        raise RuntimeError(f"{failed} ({type(e).__name__}: {e})") from e
    finally:
        seconds = time.perf_counter() - t0
        GRAPH_STATS[f"{kind}_capture_s"] += seconds
        deltas = []
        for c, old in zip(counters, counts):
            delta = {k: v - old.get(k, 0) for k, v in c.items()}
            deltas.append({k: v for k, v in delta.items() if v})
            c.clear()
            c.update(old)
    return graph, out, deltas, seconds


def _replay(graph, deltas: list, out, kind: str):
    """Replay ``graph``, add its launches to the counters and return copies
    of its outputs (the next replay of any graph in the pool may overwrite
    them)."""
    with span("cy/graph/replay"):
        graph.replay()
        for c, delta in zip(_launch_counters(), deltas):
            for k, v in delta.items():
                c[k] = c.get(k, 0) + v
        GRAPH_STATS[f"{kind}_replays"] += 1
    with span("cy/graph/outputs"):
        return pytree.tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, out)


def _copy_into(statics: list, values: list) -> None:
    with span("cy/graph/inputs"):
        for s, v in zip(statics, values):
            if isinstance(v, torch.Tensor):
                s.copy_(v)


def _per_graph(deltas: list) -> t.Dict[str, int]:
    return {k: v for d in deltas for k, v in d.items()}


class StepGraph:
    """``body`` of ``unroll`` steps, captured once per shape and epoch on a
    CUDA device and replayed, or with ``capture`` False always run eagerly
    (see the module docstring); ``name`` names the path in errors."""

    def __init__(self, body: t.Callable, *, unroll: int, name: str, capture: bool = True,
                 pool: t.Optional[GraphPool] = None):
        self.body, self.unroll, self.name = body, int(unroll), name
        self.capture = bool(capture)
        self.pool = pool if pool is not None else GraphPool()
        self.replays = self.captures = 0
        #: the host seconds of the captures so far
        self.capture_s = 0.0
        #: the hand kernels' launches one replay makes (counted at capture)
        self.launches_per_graph: t.Dict[str, int] = {}
        self._graph: t.Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self._warm: set = set()
        self._statics: list = []
        self._out = None
        self._deltas: list = []

    def __call__(self, state, inputs, epoch: int = 0):
        if (self.unroll == 1 or not self.capture
                or not next(state.model.parameters()).is_cuda):
            return self.body(state, inputs, epoch)
        with span("cy/graph/key"):
            leaves, spec = pytree.tree_flatten(inputs)
            shape_key = (spec, _shape_key(leaves), id(state))
            warm = shape_key in self._warm
            same = warm and self._key == (shape_key, int(epoch),
                                          tuple(_fingerprint(state).items()))
        if not warm:
            out = _warm_up(lambda: self.body(state, inputs, epoch), "step")
            self._warm.add(shape_key)
            return out
        if not same:
            self._capture(state, leaves, spec, epoch)
            with span("cy/graph/key"):
                self._key = (shape_key, int(epoch), tuple(_fingerprint(state).items()))
        else:
            _copy_into(self._statics, leaves)
        out = _replay(self._graph, self._deltas, self._out, "step")
        self.replays += 1
        state.step += self.unroll
        return out

    def _capture(self, state, leaves, spec, epoch) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        statics = [v.clone() if isinstance(v, torch.Tensor) else v for v in leaves]
        step, before = state.step, _fingerprint(state)
        try:
            graph, out, deltas, seconds = _capture(
                lambda: self.body(state, pytree.tree_unflatten(statics, spec), epoch),
                self.pool, f"{self.name}: the CUDA graph capture of {self.unroll} steps failed",
                "step")
        finally:
            state.step = step
        after = _fingerprint(state)
        changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
        if changed:
            raise RuntimeError(
                f"{self.name}: the step changed {changed[:4]} (and {max(len(changed) - 4, 0)} "
                f"more) by replacing a tensor or a host value, which a replay of the CUDA "
                f"graph would not repeat; such state must be updated in place on the device")
        self._graph, self._out, self._deltas, self._statics = graph, out, deltas, statics
        self.launches_per_graph = _per_graph(deltas)
        self.captures += 1
        self.capture_s += seconds
        GRAPH_STATS["step_captures"] += 1


class _Captured(t.NamedTuple):
    graph: torch.cuda.CUDAGraph
    model: torch.nn.Module
    fingerprint: tuple
    statics: list
    out: t.Any
    deltas: list


class EvalGraph:
    """``body(model, *inputs)`` (no gradient, no state changed), one CUDA
    graph per input shape and eval model on a CUDA device, replayed across
    passes (see the module docstring); ``name`` names the path in errors."""

    def __init__(self, body: t.Callable, *, name: str, pool: t.Optional[GraphPool] = None):
        self.body, self.name = body, name
        self.pool = pool if pool is not None else GraphPool()
        self.replays = self.captures = 0
        #: the hand kernels' launches of the last graph captured
        self.launches_per_graph: t.Dict[str, int] = {}
        self._warm: set = set()
        self._graphs: t.Dict[tuple, _Captured] = {}

    def __call__(self, model: torch.nn.Module, *inputs: torch.Tensor):
        if not inputs[0].is_cuda:
            return self.body(model, *inputs)
        with span("cy/graph/key"):
            key = (id(model), _shape_key(list(inputs)))
            warm = key in self._warm
            if warm:
                fingerprint = _model_fingerprint(model)
                entry = self._graphs.get(key)
                same = (entry is not None and entry.model is model
                        and entry.fingerprint == fingerprint)
        if not warm:
            out = _warm_up(lambda: self.body(model, *inputs), "eval")
            self._warm.add(key)
            return out
        if not same:
            statics = [x.clone() for x in inputs]
            graph, out, deltas, _ = _capture(
                lambda: self.body(model, *statics), self.pool,
                f"{self.name}: the CUDA graph capture of the eval chunk "
                f"{tuple(inputs[0].shape)} failed", "eval")
            # the entry replaced only now: the pool keeps a live graph
            entry = self._graphs[key] = _Captured(graph, model, fingerprint, statics, out,
                                                  deltas)
            self.captures += 1
            GRAPH_STATS["eval_captures"] += 1
            self.launches_per_graph = _per_graph(deltas)
        else:
            _copy_into(entry.statics, inputs)
        out = _replay(entry.graph, entry.deltas, entry.out, "eval")
        self.replays += 1
        return out
