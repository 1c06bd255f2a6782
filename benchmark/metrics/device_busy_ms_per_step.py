"""The union of the device's intervals (kernels, copies, fills) in the
traced window, per update, from the profiler's trace."""


def read(rec):
    if rec.trace is None or not rec.trace.kernels or not rec.traced_updates:
        return None
    return rec.trace.busy_s() / rec.traced_updates * 1e3
