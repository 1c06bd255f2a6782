"""Host seconds of the train step's CUDA graph captures over the run, from
``torch.cuda.graph``'s entry to its exit without the eager warm-up
(``contrastyou_tpu_torch/engine/graph.py`` ``GRAPH_STATS`` ``step_capture_s``;
an eval graph's captures are counted apart); none where the port keeps no
such count or captured no step graph."""


def read(rec):
    try:
        from contrastyou_tpu_torch.engine.graph import GRAPH_STATS
    except ImportError:
        return None
    if not GRAPH_STATS.get("step_captures"):
        return None
    return GRAPH_STATS.get("step_capture_s")
