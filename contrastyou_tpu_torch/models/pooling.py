"""Adaptive pooling of NHWC feature maps with torch's bin boundaries
(counterpart of contrastyou_tpu/models/pooling.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["adaptive_avg_pool2d", "adaptive_max_pool2d"]


def _bin_bounds(in_size: int, out_size: int):
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-(i + 1) * in_size // out_size) for i in range(out_size)]
    return starts, ends


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int],
                        accum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC adaptive average pooling. ``accum_dtype`` sets the accumulation
    and output dtype; the sum reads ``x`` in its own dtype (no upcast copy of
    a bf16 map)."""
    B, H, W, C = x.shape
    oh, ow = out_hw
    dtype = accum_dtype or x.dtype
    if H % oh == 0 and W % ow == 0:
        kh, kw = H // oh, W // ow
        s = x.reshape(B, oh, kh, ow, kw, C).sum((2, 4), dtype=dtype)
        return s / float(kh * kw)
    hs, he = _bin_bounds(H, oh)
    ws, we = _bin_bounds(W, ow)
    rows = [torch.stack([x[:, hs[i]:he[i], ws[j]:we[j]].mean((1, 2), dtype=dtype)
                         for j in range(ow)], 1) for i in range(oh)]
    return torch.stack(rows, 1)


def adaptive_max_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    B, H, W, C = x.shape
    oh, ow = out_hw
    if H % oh == 0 and W % ow == 0:
        return x.reshape(B, oh, H // oh, ow, W // ow, C).amax((2, 4))
    hs, he = _bin_bounds(H, oh)
    ws, we = _bin_bounds(W, ow)
    rows = [torch.stack([x[:, hs[i]:he[i], ws[j]:we[j]].amax((1, 2))
                         for j in range(ow)], 1) for i in range(oh)]
    return torch.stack(rows, 1)
