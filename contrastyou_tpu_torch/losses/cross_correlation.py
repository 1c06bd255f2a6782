"""Local windowed normalized cross-correlation, the VoxelMorph-style NCC
(counterpart of contrastyou_tpu/losses/cross_correlation.py): window sums of
I, J, I², J² and IJ give local means and variances, the loss is minus the
mean squared NCC. Inputs are NHWC single-channel maps.

The five window sums are one average pool over the stacked maps times the
window's area (zero padding of ``win // 2``, odd windows only), where JAX
sums with ``lax.reduce_window``; a pool keeps the sums in full f32 whatever
the backend's TF32 setting for convolutions.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["window_sum", "windowed_ncc_loss", "CCLoss"]


def window_sum(x: torch.Tensor, win: Tuple[int, int]) -> torch.Tensor:
    """Sliding-window sum over H, W of an NHWC tensor, same-size output."""
    if win[0] % 2 != 1 or win[1] % 2 != 1:
        raise ValueError(f"window must be odd, got {win}")
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(win), stride=1,
                          padding=(win[0] // 2, win[1] // 2), count_include_pad=True)
    return pooled.permute(0, 2, 3, 1) * float(win[0] * win[1])


def windowed_ncc_loss(y_true: torch.Tensor, y_pred: torch.Tensor, *,
                      win: Tuple[int, int] = (9, 9), eps: float = 1e-5) -> torch.Tensor:
    """-mean(local NCC²) between two NHWC single-channel maps; the cross
    term and both variances clamped below at ``eps``."""
    I, J = y_true, y_pred
    win_size = win[0] * win[1]
    sums = window_sum(torch.cat([I, J, I * I, J * J, I * J], 0), win)
    I_sum, J_sum, I2_sum, J2_sum, IJ_sum = torch.chunk(sums, 5, 0)
    u_I, u_J = I_sum / win_size, J_sum / win_size
    cross = (IJ_sum - u_J * I_sum - u_I * J_sum + u_I * u_J * win_size).clamp(min=eps)
    I_var = (I2_sum - 2 * u_I * I_sum + u_I * u_I * win_size).clamp(min=eps)
    J_var = (J2_sum - 2 * u_J * J_sum + u_J * u_J * win_size).clamp(min=eps)
    return -(cross * cross / (I_var * J_var)).mean()


class CCLoss:
    def __init__(self, win: Tuple[int, int] = (9, 9), *, eps: float = 1e-5):
        self._win, self._eps = tuple(win), eps

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        return windowed_ncc_loss(y_true, y_pred, win=self._win, eps=self._eps)
