"""The comparison that decides ``correct`` for a training cell.

Both sides give :class:`Readings` of the same first calls: the loss of
every update, the norm of each leaf's first moment after the first update
(the first gradient as the optimizer takes it, times 1 - beta1), and the
norm of each leaf's change over the compared calls (parameters and BN
running statistics). From them :func:`gaps` forms every number a cell may
compare; ``checks/<workload>.json`` names those the cell compares, each
with its limit:

- ``loss``: the largest relative gap of an update's loss;
- ``grad``: the largest gap of a leaf's first-gradient norm, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  ``grad_median``: the median leaf's such gap;
- ``change``, ``change_median``: the same for the change of each leaf the
  reference moves, leaving out the parameters whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone);
  ``stats_median``: the median of those gaps over the BatchNorm running
  statistics alone.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List

#: a parameter leaves the change comparison below this share of the median
#: leaf's first-gradient norm
GRAD_FLOOR = 1e-3


@dataclass
class Readings:
    loss: List[float] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)


def _finite(x: float) -> float:
    """``x``, or infinity where it is not a number."""
    return x if math.isfinite(x) else math.inf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of the leaf or of
    the median leaf, whichever is larger."""
    keys = list(keys)
    missing = [k for k in keys if k not in prog]
    if missing:
        raise KeyError(f"the program has no reading of {missing[:4]}")
    med = statistics.median(ref[k] for k in keys)
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)) for k in keys}


def moved(ref: Readings) -> List[str]:
    """The leaves whose change is compared: those the reference moves, but
    the parameters whose first gradient is under :data:`GRAD_FLOOR` of the
    median leaf's."""
    med = statistics.median(ref.grad.values())
    return [k for k, v in ref.change.items()
            if v > 0 and (k not in ref.grad or ref.grad[k] >= GRAD_FLOOR * med)]


def gaps(prog: Readings, ref: Readings) -> Dict[str, float]:
    """Every number a cell may compare (see the module docstring)."""
    if len(prog.loss) != len(ref.loss):
        raise ValueError(f"{len(prog.loss)} program losses against {len(ref.loss)}")
    loss = [_finite(abs(p - r) / max(abs(r), 1e-30)) for p, r in zip(prog.loss, ref.loss)]
    grad = leaf_gaps(prog.grad, ref.grad, ref.grad)
    change = leaf_gaps(prog.change, ref.change, moved(ref))
    stats = [v for k, v in change.items() if k not in ref.grad]
    return {"loss": max(loss),
            "grad": max(grad.values()), "grad_median": statistics.median(grad.values()),
            "change": max(change.values()), "change_median": statistics.median(change.values()),
            "stats_median": statistics.median(stats) if stats else 0.0}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def detail(prog: Readings, ref: Readings, top: int = 6) -> dict:
    """The look behind :func:`gaps`: the worst leaves of each kind with both
    norms, and each update's loss on both sides."""
    out = {"loss": [[p, r] for p, r in zip(prog.loss, ref.loss)]}
    for kind, p, r, keys in (("grad", prog.grad, ref.grad, list(ref.grad)),
                             ("change", prog.change, ref.change, moved(ref))):
        g = leaf_gaps(p, r, keys)
        out[kind] = [[k, g[k], p[k], r[k]] for k in sorted(g, key=lambda k: -g[k])[:top]]
    return out
