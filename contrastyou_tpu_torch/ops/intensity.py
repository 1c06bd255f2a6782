"""Device-side intensity augmentations on NHWC [0, 1] images (counterpart of
contrastyou_tpu/ops/intensity.py). Random draws are explicit arguments — the
caller draws them from a ``torch.Generator`` or, in tests, hands in the JAX
package's draws. The gamma correction of the train step is
``ops/affine.py`` :func:`apply_gamma`."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gaussian_noise", "color_jitter", "random_cutout"]


def gaussian_noise(images: torch.Tensor, noise: torch.Tensor, *,
                   std: float = 0.05) -> torch.Tensor:
    """``noise`` is a standard-normal tensor of the images' shape."""
    return images + std * noise


def color_jitter(images: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor) -> torch.Tensor:
    """Per-sample brightness / contrast factors [B] (drawn from
    U(1-0.2, 1+0.2) in the reference's ACDC transform)."""
    b = brightness.reshape(-1, 1, 1, 1)
    c = contrast.reshape(-1, 1, 1, 1)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * c + mean * b).clamp(0.0, 1.0)


def random_cutout(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  *, size: Tuple[int, int] = (32, 32)) -> torch.Tensor:
    """Zero a (size_h x size_w) box per sample at top-left corners
    ``ys``/``xs`` [B]."""
    B, H, W, _ = images.shape
    yy = torch.arange(H, device=images.device)[None, :, None]
    xx = torch.arange(W, device=images.device)[None, None, :]
    y0, x0 = ys[:, None, None], xs[:, None, None]
    inside = (yy >= y0) & (yy < y0 + size[0]) & (xx >= x0) & (xx < x0 + size[1])
    return images * (~inside)[..., None].to(images.dtype)
