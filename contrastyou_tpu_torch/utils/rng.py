"""Host seeds (counterpart of contrastyou_tpu/utils/rng.py). The port's
device draws take explicit ``torch.Generator`` s, so JAX's ``key_iter`` (a
stream of PRNG keys) has no counterpart."""
from __future__ import annotations

import random

import numpy as np

__all__ = ["fix_all_seed"]


def fix_all_seed(seed: int) -> None:
    """Seed python's ``random`` and numpy's global generator."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
