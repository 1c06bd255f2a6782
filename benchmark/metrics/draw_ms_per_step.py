"""Host ms an update in the port's data work (``cy/data/draw``: the device
cache's draws; ``cy/data/sampler``: the contrastive sampler's next batch of
indices; ``cy/data/host_batch``: a host-fed batch) over the traced window,
from the port's span totals (``contrastyou_tpu_torch/tracing.py``); none
without them. Host wall time under the profiler. ``cy/data/index_copy``,
the sampler's pageable copy of its indices to the card, is left out: the
host waits there for the card's earlier work, which is time waited, not
the data layer's work."""
from portbench.spans import span_ms_per_update

DATA_SPANS = ("cy/data/draw", "cy/data/sampler", "cy/data/host_batch")


def read(rec):
    return span_ms_per_update(rec, DATA_SPANS)
