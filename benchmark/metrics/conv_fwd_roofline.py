"""K1 ``conv3x3_stats`` and K2 ``upconv3x3_stats``: their least time on
the H100 (bytes over HBM bandwidth or FLOPs over the bf16 peak, launch by
launch) over their device time in the traced window."""
from portbench.roofline import share


def read(rec):
    return share(rec, ("K1", "K2"))
