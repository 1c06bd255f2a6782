"""Shared hook utilities (counterpart of contrastyou_tpu/hooks/utils.py)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["draw_mixup", "mixup_draw_tensors", "mixup_data"]


def draw_mixup(rng: np.random.Generator, n: int, alpha: float = 1.0
               ) -> Tuple[float, Tuple[int, ...]]:
    """The draws of :func:`mixup_data` on the host: ``lam`` ~ Beta(alpha,
    alpha) rounded to f32 (1.0 when ``alpha`` <= 0) and a permutation of
    ``n``."""
    lam = float(np.float32(rng.beta(alpha, alpha))) if alpha > 0 else 1.0
    return lam, tuple(int(i) for i in rng.permutation(n))


def mixup_draw_tensors(rng: np.random.Generator, n: int, alpha: float,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`draw_mixup` as tensors on ``device``: ``lam`` an f32 scalar,
    the permutation int64 [n]. A step reads them as data, so a CUDA graph of
    the step replays the draws of each call (``engine/graph.py``)."""
    lam, perm = draw_mixup(rng, n, alpha)
    return (torch.tensor(lam, dtype=torch.float32, device=device),
            torch.tensor(perm, dtype=torch.int64, device=device))


def mixup_data(x: torch.Tensor, y: torch.Tensor, lam, perm,
               rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-lambda mixup over the f32 batch with explicit draws (JAX draws
    ``lam`` and ``perm`` from its key): ``lam * x + (1 - lam) * x[perm]``,
    the same for ``y``, with ``1 - lam`` in f32 as JAX computes it; only the
    mixed ``rows`` when given (a data-parallel rank's rows of the mixed
    global batch), each bitwise as in the whole. ``lam`` and ``perm`` are
    tensors (:func:`mixup_draw_tensors`) or host values (a float, a sequence
    of ints)."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    index = torch.as_tensor(perm, dtype=torch.int64, device=x.device)
    own = None
    if rows is not None:
        own = torch.as_tensor(list(rows), dtype=torch.int64, device=x.device)
        index = index[own]
    return tuple(lam * (a if own is None else a.index_select(0, own))
                 + (1.0 - lam) * a.index_select(0, index) for a in (x, y))
