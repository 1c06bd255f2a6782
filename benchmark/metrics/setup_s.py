"""From the process's start to the first timed call: imports, the build,
the inputs, the first calls (the warm-up, the capture where there is one,
and the kernel build of a checkout's first run), synchronized."""


def read(rec):
    return rec.setup_s
