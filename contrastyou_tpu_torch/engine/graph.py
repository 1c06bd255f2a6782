"""One CUDA graph per call of K train steps (the counterpart of JAX's
``build_unrolled_train_step`` / ``build_cached_train_step(unroll=K)``,
which compile K steps into one XLA program).

:class:`StepGraph` wraps ``body(state, inputs, epoch) -> outputs``, the K
steps of one call. On the CPU, or with K = 1, it calls ``body``. On a CUDA
device:

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
the card never runs eagerly in place of the graph.

``state.step`` advances by K a call. The hand kernels' launch counters
(``ops`` ``LAUNCHES``) count on the host where a wrapper launches; a replay
launches without calling the wrappers, so the launches a capture recorded
are kept (:attr:`StepGraph.launches_per_graph`) and added to the counters
at each replay: ``kernel_launches()`` reads replays x captured.
"""
from __future__ import annotations

import typing as t

import torch
from torch.utils import _pytree as pytree

__all__ = ["StepGraph"]


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


def _fingerprint(state) -> dict:
    """path -> the tensor's identity and storage, or a host value."""
    return {k: (id(v), v.data_ptr()) if isinstance(v, torch.Tensor) else v
            for k, v in _state_leaves(state).items()}


class StepGraph:
    """``body`` of ``unroll`` steps, captured once per shape and epoch on a
    CUDA device and replayed (see the module docstring); ``name`` names the
    path in errors."""

    def __init__(self, body: t.Callable, *, unroll: int, name: str):
        self.body, self.unroll, self.name = body, int(unroll), name
        self.replays = 0
        #: the hand kernels' launches one replay makes (counted at capture)
        self.launches_per_graph: t.Dict[str, int] = {}
        self._graph: t.Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self._warm: set = set()
        self._statics: list = []
        self._out = None
        self._deltas: list = []

    def __call__(self, state, inputs, epoch: int = 0):
        if self.unroll == 1 or not next(state.model.parameters()).is_cuda:
            return self.body(state, inputs, epoch)
        leaves, spec = pytree.tree_flatten(inputs)
        shapes = tuple((tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
                       else ("host", v) for v in leaves)
        shape_key = (spec, shapes, id(state))
        if shape_key not in self._warm:
            out = self._warm_up(state, inputs, epoch)
            self._warm.add(shape_key)
            return out
        key = (shape_key, int(epoch), tuple(_fingerprint(state).items()))
        if key != self._key:
            self._capture(state, leaves, spec, epoch)
            self._key = (shape_key, int(epoch), tuple(_fingerprint(state).items()))
        else:
            for s, v in zip(self._statics, leaves):
                if isinstance(v, torch.Tensor):
                    s.copy_(v)
        return self._replay(state)

    # --- pieces -------------------------------------------------------------
    def _warm_up(self, state, inputs, epoch):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.body(state, inputs, epoch)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self, state, leaves, spec, epoch) -> None:
        self._graph, self._out = None, None
        state.optimizer.zero_grad(set_to_none=True)
        self._statics = [v.clone() if isinstance(v, torch.Tensor) else v for v in leaves]
        statics = pytree.tree_unflatten(self._statics, spec)
        counters = _launch_counters()
        counts = [dict(c) for c in counters]
        step, before = state.step, _fingerprint(state)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.body(state, statics, epoch)
        except Exception as e:
            raise RuntimeError(f"{self.name}: the CUDA graph capture of {self.unroll} steps "
                               f"failed ({type(e).__name__}: {e})") from e
        finally:
            state.step = step
            self._deltas = []
            for c, old in zip(counters, counts):
                delta = {k: v - old.get(k, 0) for k, v in c.items()}
                self._deltas.append({k: v for k, v in delta.items() if v})
                c.clear()
                c.update(old)
        after = _fingerprint(state)
        changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
        if changed:
            raise RuntimeError(
                f"{self.name}: the step changed {changed[:4]} (and {max(len(changed) - 4, 0)} "
                f"more) by replacing a tensor or a host value, which a replay of the CUDA "
                f"graph would not repeat; such state must be updated in place on the device")
        self._graph, self._out = graph, out
        self.launches_per_graph = {k: v for d in self._deltas for k, v in d.items()}

    def _replay(self, state):
        self._graph.replay()
        self.replays += 1
        state.step += self.unroll
        for c, delta in zip(_launch_counters(), self._deltas):
            for k, v in delta.items():
                c[k] = c.get(k, 0) + v
        return pytree.tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v,
                               self._out)
