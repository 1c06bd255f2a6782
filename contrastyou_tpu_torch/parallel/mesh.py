"""Data parallelism over processes (counterpart of
contrastyou_tpu/parallel/mesh.py).

JAX shards a global batch over a one-axis device mesh and lets GSPMD insert
the collectives, so a sharded step computes what the unsharded one computes
on the whole batch. The port keeps those semantics with one process per
rank: a :class:`DataGroup` (rank, world size, process group, device) takes
the place of the mesh and its ``data`` axis, each rank holds ``1/W`` of the
global batch (:func:`shard_batch`), the parameters start equal on every
rank (:func:`replicate`), and the step runs the collectives of
``parallel/collectives.py`` itself: BatchNorm's batch sums and the InfoNCE
anchors are global, and the gradients are summed over ranks. This is not
``DistributedDataParallel``'s mean of per-rank means, which differs
wherever a reduction spans the batch.

``init_distributed`` starts ``torch.distributed`` from explicit arguments
or from torchrun's environment: NCCL on CUDA devices, gloo on the CPU (and
gloo with every rank on one card, where NCCL refuses two ranks on a
device). :func:`data_parallel` makes a group the active one for the
duration of a step; BatchNorm reads it through :func:`active_group`.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import typing as t
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["DataGroup", "init_distributed", "is_master", "multi_rank", "shard_batch",
           "replicate", "data_parallel", "active_group"]


@dataclass(frozen=True)
class DataGroup:
    """The ranks of one data-parallel run: this process's ``rank`` of
    ``size``, the ``process_group`` of the collectives (None: the default
    group) and the ``device`` whose tensors they carry."""

    rank: int
    size: int
    device: torch.device
    process_group: t.Any = None

    @classmethod
    def single(cls, device="cpu") -> "DataGroup":
        """One process: no collective ever runs."""
        return cls(0, 1, torch.device(device))

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one element on the group's
        device, which every backend supports)."""
        if self.size > 1:
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.process_group)


def _env_int(name: str) -> t.Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_distributed(init_method: t.Optional[str] = None, *, world_size: t.Optional[int] = None,
                     rank: t.Optional[int] = None, backend: t.Optional[str] = None,
                     device=None) -> DataGroup:
    """Start the default process group and return its :class:`DataGroup`.

    Without ``world_size`` the torchrun variables (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) give it; without
    them either, the run is one process and nothing is started (JAX's
    ``init_distributed`` without a coordinator). ``init_method`` defaults to
    ``env://``, e.g. ``tcp://127.0.0.1:<port>``. ``device`` defaults to the
    card ``cuda:<LOCAL_RANK>`` (``cuda:<rank % cards>``); ``backend`` to
    NCCL for a CUDA device and gloo for the CPU."""
    world_size = _env_int("WORLD_SIZE") if world_size is None else int(world_size)
    rank = _env_int("RANK") if rank is None else int(rank)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        local = _env_int("LOCAL_RANK")
        device = f"cuda:{(local if local is not None else rank or 0) % torch.cuda.device_count()}"
    device = torch.device(device)
    if not world_size or world_size == 1:
        return DataGroup.single(device)
    if rank is None or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return DataGroup(rank, world_size, device)


def multi_rank(group: t.Optional[DataGroup]) -> t.Optional[DataGroup]:
    """``group`` when it spans more than one rank, else None: one rank runs
    the one-process code, without a collective."""
    return group if group is not None and group.size > 1 else None


def is_master() -> bool:
    """Whether this process is rank 0 (or the only one): it alone writes
    the run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _map(fn, tree):
    """``fn`` on every tensor of a nest of dicts, lists, tuples and named
    tuples; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(batch, group: t.Optional[DataGroup], batch_dim: int = 0):
    """This rank's rows of a global batch: every tensor with a ``batch_dim``
    axis is cut into ``group.size`` equal runs along it and keeps run
    ``group.rank``; lower-rank tensors (scalars) stay whole, as JAX's
    ``shard_batch`` replicates them. The batch axis must divide by the
    world size. Without a group, or with one rank, ``batch`` is returned
    as it is."""
    if multi_rank(group) is None:
        return batch

    def cut(x: torch.Tensor) -> torch.Tensor:
        if x.dim() <= batch_dim:
            return x
        n = x.shape[batch_dim]
        if n % group.size:
            raise ValueError(f"a batch axis of {n} does not divide over {group.size} ranks")
        per = n // group.size
        return x.narrow(batch_dim, group.rank * per, per)

    return _map(cut, batch)


@torch.no_grad()
def replicate(module: torch.nn.Module, group: t.Optional[DataGroup]) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place,
    so every rank starts from the same state."""
    if multi_rank(group) is not None:
        for tensor in [*module.parameters(), *module.buffers()]:
            dist.broadcast(tensor.data, src=0, group=group.process_group)
    return module


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_parallel(group: t.Optional[DataGroup]):
    """Make ``group`` the active group inside the block (None, or one rank:
    none is active)."""
    token = _ACTIVE.set(multi_rank(group))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_group() -> t.Optional[DataGroup]:
    """The group of the step running in this context, or None."""
    return _ACTIVE.get()
