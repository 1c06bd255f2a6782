"""Host ms an update in the step's top-level spans (``cy/step/forward``,
``hooks``, ``backward``, ``optimizer``, ``commit``) over the traced
window: how long the host takes to issue an eager update, to hold against
``device_busy_ms_per_step``; from the port's span totals, none without
them (under a CUDA graph the step's spans run only at warm-up and capture).
Host wall time under the profiler: a launch that finds the card's queue
full waits inside these spans, and that wait is counted."""
from portbench.spans import span_ms_per_update

STEP_SPANS = tuple(f"cy/step/{p}" for p in ("forward", "hooks", "backward", "optimizer",
                                            "commit"))


def read(rec):
    return span_ms_per_update(rec, STEP_SPANS)
