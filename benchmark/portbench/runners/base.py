"""What every runner of a training cell shares: the program's first calls
and their readings, the window's calls, freeing the program before the
reference runs, and the planted faults of the fault tests."""
from __future__ import annotations

import contextlib
import copy
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..check import Readings

#: faults a test or a fault run plants in the program
FAULTS = ("half_batch", "state_unchanged")


@contextlib.contextmanager
def no_synthetic_slices(port):
    """``port.synthetic_split`` (the port's synthetic slices, a Python loop
    over the slices on the host) giving zeros of its shapes while the port's
    build runs: the benchmark loads the seed's slices into the built caches,
    so the port's own would be made and thrown away."""
    def zeros(n_slices: int, size: int, **_):
        return (np.zeros((n_slices, size, size), np.float32),
                np.zeros((n_slices, size, size), np.int64))

    original = port.synthetic_split
    port.synthetic_split = zeros
    try:
        yield
    finally:
        port.synthetic_split = original


def first_half(x: Any, batch: int) -> Any:
    """``x`` with every tensor whose first axis is ``batch`` long cut to its
    first ``batch - batch // 2`` rows, through tuples, named tuples and dicts."""
    if isinstance(x, torch.Tensor):
        return x[:batch - batch // 2] if x.dim() and x.shape[0] == batch else x
    if isinstance(x, dict):
        return {k: first_half(v, batch) for k, v in x.items()}
    if isinstance(x, tuple):
        parts = [first_half(v, batch) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def half_batch(sample: Callable, batch_arg: int = 1) -> Callable:
    """``sample`` (a draw function whose argument ``batch_arg`` is the batch
    size, or a cache's ``sample_at``) with its result cut to the first half
    of the rows: half of the batch left out, the mean taken over the rest."""
    def cut(*args, **kwargs):
        batch = args[batch_arg] if batch_arg is not None else args[0].shape[0]
        return first_half(sample(*args, **kwargs), batch)
    return cut


class Runner:
    """A training cell's program run. A subclass builds ``self.run`` (the
    port's run with the seed's inputs loaded), and sets ``updates_per_call``,
    ``slices_per_update``, ``initial`` (leaf -> its starting tensor) and
    ``names`` (id of each optimized tensor -> its leaf name)."""

    updates_per_call = 1
    slices_per_update = 0

    def __init__(self, cell, seed: int, device, *, dtype: torch.dtype = torch.bfloat16,
                 sizes: Optional[dict] = None, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.cell, self.seed, self.device, self.dtype = cell, int(seed), torch.device(device), dtype
        self.traffic = {**cell.traffic, **(sizes or {})}
        self.config = copy.deepcopy(cell.config["config"])
        if sizes and "max_channel" in sizes:
            self.config["Arch"]["max_channel"] = int(sizes["max_channel"])
        self.config["RandomSeed"] = self.seed
        self.fault = fault
        self.run = None
        self.initial: Dict[str, torch.Tensor] = {}
        self.names: Dict[int, str] = {}
        self._patched: list = []

    def plant(self, owner, name: str, wrapper: Callable) -> None:
        """Replace ``owner.name`` by ``wrapper(owner.name)`` until :meth:`free`."""
        self._patched.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrapper(getattr(owner, name)))

    @property
    def captures(self) -> bool:
        """Whether a call is one CUDA graph, its first two calls the eager
        warm-up and the capture."""
        return False

    @property
    def max_channel(self) -> int:
        return int(self.config["Arch"]["max_channel"])

    # --- the program -----------------------------------------------------
    def build(self) -> None:
        raise NotImplementedError

    def call(self):
        """One call of the timed entry; returns its metrics (on the device)."""
        raise NotImplementedError

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every tensor the comparison reads, by leaf name."""
        raise NotImplementedError

    def first_calls(self, n: int) -> Readings:
        """The first ``n`` calls, which are also the set-up's warm-up; the
        readings of the check: each update's loss, each optimized leaf's
        first moment after the first update, each leaf's change."""
        opt = self.run.state.optimizer
        first: Dict[str, torch.Tensor] = {}
        step = opt.step

        def recording_step(*args, **kwargs):
            out = step(*args, **kwargs)
            if not first:
                for group in opt.param_groups:
                    for p in group["params"]:
                        if p in opt.state and "mu" in opt.state[p]:
                            first[self.names[id(p)]] = opt.state[p]["mu"].float().norm()
            return out

        if self.fault == "state_unchanged":
            opt.step = lambda *a, **k: None
        else:
            opt.step = recording_step
        losses: List[torch.Tensor] = []
        self.call_seconds = []
        for i in range(n):
            if i == 1 and self.fault != "state_unchanged":
                del opt.step           # the class's step again before any capture
            t = time.perf_counter()
            losses.append(self.loss_of(self.call()).reshape(-1).float())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.call_seconds.append(time.perf_counter() - t)
        if self.fault == "state_unchanged":
            del opt.step
            first = {k: torch.zeros((), device=self.device) for k in self.names.values()}
        with torch.no_grad():
            change = {k: (v.float() - self.initial[k].float()).norm()
                      for k, v in self.leaves().items()}
        self.initial = {}
        return Readings(loss=torch.cat(losses).tolist(),
                        grad={k: float(v) for k, v in first.items()},
                        change={k: float(v) for k, v in change.items()})

    def loss_of(self, metrics) -> torch.Tensor:
        raise NotImplementedError

    def free(self) -> None:
        """Drop the program's run, undo the planted faults and return the
        memory to the device."""
        for owner, name, original in reversed(self._patched):
            setattr(owner, name, original)
        self._patched = []
        self.run = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # --- work counts -----------------------------------------------------
    def sites(self) -> list:
        """The hand-written conv kernels' launches of one update."""
        raise NotImplementedError

    def model_flops(self) -> float:
        """Model FLOPs of one update."""
        raise NotImplementedError

    # --- the reference ---------------------------------------------------
    def reference(self, prec, n_calls: int) -> Readings:
        raise NotImplementedError


def readings_of(losses: List[float], first: Dict[str, torch.Tensor],
                start: Dict[str, torch.Tensor], end: Dict[str, torch.Tensor]) -> Readings:
    """The reference's readings from its first moments and leaves."""
    return Readings(loss=list(losses), grad={k: float(v.float().norm()) for k, v in first.items()},
                    change={k: float((end[k].float() - start[k].float()).norm()) for k in start})
