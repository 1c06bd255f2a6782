"""The model's FLOPs an update (every conv and matrix product, forward,
weight and input gradients, counted from shapes whatever runs them) times
the updates of the traced run's untraced rest, over its wall time and the
H100's dense bf16 peak."""
from portbench.work import PEAK_BF16_FLOPS


def read(rec):
    if rec.rest is None or rec.device.type != "cuda" or not rec.model_flops:
        return None
    updates, seconds = rec.rest
    return 100.0 * rec.model_flops * updates / seconds / PEAK_BF16_FLOPS
