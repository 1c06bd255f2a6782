"""Training slices of every update completed in the window, over the
window's wall time (host clock; the window ends in a synchronize)."""


def read(rec):
    return rec.slices / rec.window_s if rec.window_s > 0 else None
