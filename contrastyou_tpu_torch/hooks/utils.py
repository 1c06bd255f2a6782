"""Shared hook utilities (counterpart of contrastyou_tpu/hooks/utils.py)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["draw_mixup", "mixup_data"]


def draw_mixup(rng: np.random.Generator, n: int, alpha: float = 1.0
               ) -> Tuple[float, Tuple[int, ...]]:
    """The draws of :func:`mixup_data` on the host: ``lam`` ~ Beta(alpha,
    alpha) rounded to f32 (1.0 when ``alpha`` <= 0) and a permutation of
    ``n``."""
    lam = float(np.float32(rng.beta(alpha, alpha))) if alpha > 0 else 1.0
    return lam, tuple(int(i) for i in rng.permutation(n))


def mixup_data(x: torch.Tensor, y: torch.Tensor, lam: float, perm: Sequence[int],
               rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-lambda mixup over the batch with explicit draws (JAX draws
    ``lam`` and ``perm`` from its key): ``lam * x + (1 - lam) * x[perm]``,
    the same for ``y``, with ``1 - lam`` in f32 as JAX computes it; only the
    mixed ``rows`` when given (a data-parallel rank's rows of the mixed
    global batch), each bitwise as in the whole. The rows are gathered by
    slicing, so no index tensor goes to the device."""
    rest = float(np.float32(1.0) - np.float32(lam))
    rows = range(len(perm)) if rows is None else rows
    return tuple(lam * torch.stack([a[i] for i in rows])
                 + rest * torch.stack([a[perm[i]] for i in rows]) for a in (x, y))
