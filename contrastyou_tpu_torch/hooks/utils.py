"""Shared hook utilities (counterpart of contrastyou_tpu/hooks/utils.py)."""
from __future__ import annotations

from typing import Sequence, Tuple

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


def mixup_data(x: torch.Tensor, y: torch.Tensor, lam: float, perm: Sequence[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-lambda mixup over the batch with explicit draws (JAX draws
    ``lam`` and ``perm`` from its key): ``lam * x + (1 - lam) * x[perm]``,
    the same for ``y``, with ``1 - lam`` in f32 as JAX computes it. The
    permuted batch is gathered by slicing, so no index tensor goes to the
    device."""
    rest = float(np.float32(1.0) - np.float32(lam))

    def mix(a):
        return lam * a + rest * torch.stack([a[i] for i in perm])

    return mix(x), mix(y)
