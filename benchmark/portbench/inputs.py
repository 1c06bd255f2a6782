"""What the benchmark makes from ``--seed`` and hands to both the port and
the reference: the initial weights and the slices. Both are made on the
device from a ``torch.Generator`` in a few large calls."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: sub-streams of one seed
WEIGHTS, SLICES, DRAWS = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """The seed of one sub-stream of ``seed``."""
    return (int(seed) * 16 + stream) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one sub-stream of ``seed`` on ``device``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def make_weights(shapes: Dict[str, tuple], g: torch.Generator) -> Dict[str, torch.Tensor]:
    """f32 weights for ``shapes``: LeCun-normal kernels (std 1/sqrt(fan in))
    of every tensor of two or more axes from one normal draw, norm scales 1,
    biases 0."""
    kernels = {k: s for k, s in shapes.items() if len(s) >= 2}
    total = sum(math.prod(s) for s in kernels.values())
    flat = torch.randn(total, generator=g, device=g.device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            out[k] = (flat[at:at + n] / math.sqrt(n // s[0])).reshape(s)
            at += n
        elif k.endswith(".weight"):
            out[k] = torch.ones(s, device=g.device)
        else:
            out[k] = torch.zeros(s, device=g.device)
    return out


def make_buffers(shapes: Dict[str, tuple], device) -> Dict[str, torch.Tensor]:
    """BatchNorm running statistics at their start: mean 0, variance 1."""
    return {k: (torch.ones if k.endswith("running_var") else torch.zeros)(s, device=device)
            for k, s in shapes.items()}


def make_slices(n: int, size: int, num_classes: int, g: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, size, size] f32 images in [0, 1] and long targets: per slice,
    nested ellipses (one a class above 0) over a noisy background with a
    horizontal shading, as the port's synthetic ACDC-like scans look."""
    dev = g.device
    u = torch.rand(n, 3, generator=g, device=dev)
    cy = (0.35 + 0.3 * u[:, 0]) * size
    cx = (0.35 + 0.3 * u[:, 1]) * size
    r = (0.18 + 0.1 * u[:, 2]) * size
    yy = torch.arange(size, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(size, device=dev, dtype=torch.float32)[None, None, :]
    dist = torch.sqrt((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2)
    targets = torch.zeros(n, size, size, dtype=torch.long, device=dev)
    for c in range(1, num_classes):
        targets += (dist < (r * (num_classes - c) / (num_classes - 1))[:, None, None]).long()
    noise = torch.randn(n, size, size, generator=g, device=dev)
    images = (targets.float() / max(num_classes - 1, 1) * 0.6 + 0.05 * noise
              + 0.2 * torch.sin(xx / size * 3.1)).clamp(0.0, 1.0)
    return images, targets
