"""The device's peak of allocated memory in GiB from the process's start
to the window's end (``torch.cuda.max_memory_allocated``), read before the
reference runs: the eager warm-up and the capture included. Under a CUDA
graph the replays allocate nothing, and what the graph's working memory
takes was allocated at its capture and sits in its pool, which a peak over
the window alone does not see (the run prints that one on standard error)."""


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
