"""Host ms an update in the CUDA graph's own work around a replay
(``cy/graph/key``: the state's fingerprint walk and the key compare;
``cy/graph/inputs``: the copies into the static inputs; ``cy/graph/outputs``:
the outputs' copies) over the traced window, from the port's span totals;
none without them."""
from portbench.spans import span_ms_per_update


def read(rec):
    return span_ms_per_update(rec, ("cy/graph/key", "cy/graph/inputs", "cy/graph/outputs"))
