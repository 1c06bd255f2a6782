"""The share of the traced window in which nothing ran on the device:
100 minus the union of its intervals over the window's host-clock length."""


def read(rec):
    if rec.trace is None or not rec.trace.kernels:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)
