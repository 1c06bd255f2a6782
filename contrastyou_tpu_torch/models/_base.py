"""Layer-name range algebra for named-layer architectures (counterpart of
contrastyou_tpu/models/_base.py): topological indices of layer names and
(start, end) ranges with optional inclusive bounds."""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["arch_order", "check_range_params", "complete_arch_start2end"]


def arch_order(name: str, *, elements: Sequence[str]) -> int:
    if name not in elements:
        raise ValueError(f"unknown layer '{name}' (have {', '.join(elements)})")
    return list(elements).index(name)


def check_range_params(start, end, include_start, include_end, *,
                       elements: Sequence[str]) -> None:
    if start is None and not include_start:
        raise ValueError("include_start must be True when start is None")
    if end is None and not include_end:
        raise ValueError("include_end must be True when end is None")
    for name in (start, end):
        if isinstance(name, str):
            arch_order(name, elements=elements)
    if isinstance(start, str) and isinstance(end, str):
        if arch_order(start, elements=elements) > arch_order(end, elements=elements):
            raise ValueError(f"start '{start}' after end '{end}'")


def complete_arch_start2end(start: str, end: str, *, elements: Sequence[str],
                            include_start: bool = True,
                            include_end: bool = True) -> List[str]:
    i0 = arch_order(start, elements=elements)
    i1 = arch_order(end, elements=elements)
    if i0 > i1:
        raise ValueError(f"start '{start}' after end '{end}'")
    lo = i0 if include_start else i0 + 1
    hi = i1 + 1 if include_end else i1
    return list(elements[lo:hi])
