"""The eager warm-up call and the capture call of the step's CUDA graph
(``engine/graph.py`` ``StepGraph``), each synchronized; none without a graph."""


def read(rec):
    return rec.capture_s
