"""K3 ``upconv3x3_dx``, C1 ``conv_dw_taps`` and C2 ``conv3x3_bwd_fused``
(with C1's and C2's partial sums): their least time on the H100 over their
device time in the traced window."""
from portbench.roofline import share


def read(rec):
    return share(rec, ("K3", "C1", "C2"))
