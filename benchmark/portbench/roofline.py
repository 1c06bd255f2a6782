"""A family of hand-written kernels' share of its roofline in the traced
window, from the table of launch sites (``work.kernel_sites``) held against
the port's launch counters first."""
from __future__ import annotations

from typing import Optional, Sequence

from .work import counted_launches, launches

#: each kernel family's label in the trace (``trace.hand_kernel``)
LABELS = {"K1": "K1 conv3x3_stats", "K2": "K2 upconv3x3_stats", "K3": "K3 upconv3x3_dx",
          "C1": "C1 conv_dw_taps", "C2": "C2 conv3x3_bwd_fused"}
#: the reduction that C1 and C2 launch after their partial products
PARTIALS = "partial sums of C1/C2, E1"


def share(rec, families: Sequence[str]) -> Optional[float]:
    """Least time of the families' launches over their device time, in %.
    None without a trace or a card, or where the port launched none of them
    (a kernel taken off the path); raises where the port's counters disagree
    with the site table, which is then stale."""
    if rec.trace is None or rec.device.type != "cuda":
        return None
    counted = counted_launches(rec.launches)
    if not any(counted.get(f) for f in families):
        return None
    table = launches(rec.sites)
    for f in families:
        want = table.get(f, 0) * rec.traced_updates
        if counted.get(f, 0) != want:
            raise RuntimeError(f"{f}: the port counted {counted.get(f, 0)} launches in "
                               f"{rec.traced_updates} updates, the site table gives {want}: "
                               f"the table is stale")
        seen = rec.trace.count(LABELS[f])
        if seen != want:
            raise RuntimeError(f"{f}: {seen} kernels of that name in the trace against {want} "
                               f"launches: the kernel names of trace.hand_kernel are stale")
    least = sum(s.least_s() for s in rec.sites if s.kernel in families) * rec.traced_updates
    labels = {LABELS[f] for f in families}
    if {"C1", "C2"} & set(families) and not rec.trace.has("iic_joints"):
        labels.add(PARTIALS)
    device = rec.trace.device_seconds(labels)
    return 100.0 * least / device if device > 0 else None
