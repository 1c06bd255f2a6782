"""Fused supervised-contrastive loss: kernels D1/D2, their plain versions and
the differentiable loss (counterpart of contrastyou_tpu/ops/pallas/infonce.py).

Two hand-written CUDA kernels (``csrc/supcon.cu``), f32 in and f32 math:

- ``supcon_loss`` (D1): per anchor row of the stacked projections z [M, d],
  the masked log-sum-exp of z z^T / tau and the mean over its positives ->
  loss [M], plus the residuals lse [M] (log softmax denominator) and pcount [M]
  (positives per row).
- ``supcon_dz`` (D2): the analytic gradient dz [M, d] from z, the masks, D1's
  residuals and the cotangent of the mean loss.

The pair masks travel as one byte per pair (:func:`pair_code`: bit 0 =
positive, bit 1 = negative, diagonal cleared). Every wrapper dispatches on the
device of its input: a CPU tensor goes to the plain PyTorch version beside it
(the literal math of the TPU kernels, ``_loss_kernel`` / ``_bwd_kernel``), a
CUDA tensor to the kernel, which raises on what it does not take.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

__all__ = ["pair_code", "supcon_loss", "supcon_loss_plain", "supcon_dz",
           "supcon_dz_plain", "sup_con_from_code", "LAUNCHES", "MAX_ANCHORS",
           "MAX_DIM", "reset_launch_counts"]

#: launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {"supcon_loss": 0, "supcon_dz": 0}

#: widest projection the kernels take (D2: 16 dz columns a lane)
MAX_DIM = 512
#: most anchors the kernels take at d <= MAX_DIM: the pair bytes are indexed
#: in 32 bits, M^2 < 2^31 (``supcon_max_anchors`` reports the same number)
MAX_ANCHORS = 46340


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pair_code(pos_mask: torch.Tensor, neg_mask: torch.Tensor) -> torch.Tensor:
    """[M, M] uint8: bit 0 where ``pos_mask`` > 0, bit 1 where ``neg_mask`` > 0."""
    return ((pos_mask > 0).to(torch.uint8) | ((neg_mask > 0).to(torch.uint8) << 1)).contiguous()


def _masks(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (code & 1).float(), ((code >> 1) & 1).float()


def supcon_loss_plain(z: torch.Tensor, code: torch.Tensor, temperature: float):
    """Plain version of :func:`supcon_loss` (``_loss_kernel``'s math)."""
    pos, neg = _masks(code)
    s = (z @ z.T) / temperature
    m = pos + neg
    s_masked = torch.where(m > 0, s, -1e30)
    row_max = torch.clamp(s_masked.max(1, keepdim=True).values, min=-0.0)
    e = torch.where(m > 0, torch.exp(s - row_max), 0.0)
    denom = e.sum(1, keepdim=True)
    log_denom = torch.log(denom + 1e-16) + row_max
    pos_count = pos.sum(1)
    loss = -((s - log_denom) * pos).sum(1) / torch.clamp(pos_count, min=1.0)
    lse = (row_max + torch.log(torch.clamp(denom, min=1e-16)))[:, 0]
    return loss, lse, pos_count


@functools.lru_cache(maxsize=None)
def _max_anchors(d: int) -> int:
    """``supcon_max_anchors(d)`` of the library, asked once per width."""
    return _build.load_library("supcon").supcon_max_anchors(d)


def _cuda_check(what: str, z: torch.Tensor, code: torch.Tensor, *f32) -> None:
    M, d = z.shape
    for t in (z, *f32):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: f32 inputs must be contiguous CUDA tensors, "
                             f"got {t.dtype} on {t.device}")
    if code.device != z.device or code.dtype != torch.uint8 or code.shape != (M, M):
        raise ValueError(f"{what}: code must be a uint8 [{M}, {M}] tensor on {z.device}")
    if d > MAX_DIM:
        raise ValueError(f"{what}: projection width {d} > {MAX_DIM}")
    if M > _max_anchors(d):
        raise ValueError(f"{what}: {M} anchors > {_max_anchors(d)}, the kernels' capacity")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def supcon_loss(z: torch.Tensor, code: torch.Tensor, temperature: float):
    """Per-anchor SupCon loss of ``z`` [M, d] f32 under the pair ``code``
    [M, M] uint8 -> ``(loss, lse, pcount)``, each [M] f32. Kernel D1 on
    CUDA."""
    if z.device.type == "cpu":
        return supcon_loss_plain(z, code, temperature)
    z, code = z.contiguous(), code.contiguous()
    _cuda_check("supcon_loss", z, code)
    M, d = z.shape
    loss, lse, pcount = torch.empty(3, M, dtype=torch.float32, device=z.device)
    rc = _build.load_library("supcon").supcon_loss(
        _ptr(z), _ptr(code), M, d, float(temperature), _ptr(loss), _ptr(lse),
        _ptr(pcount), _stream())
    _build.check(rc, "supcon_loss", "supcon")
    LAUNCHES["supcon_loss"] += 1
    return loss, lse, pcount


def supcon_dz_plain(z: torch.Tensor, code: torch.Tensor, lse: torch.Tensor,
                    pcount: torch.Tensor, g: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Plain version of :func:`supcon_dz` (``_bwd_kernel``'s math, which
    recomputes the softmax and so needs neither residual)."""
    pos, neg = _masks(code)
    M = z.shape[0]
    s = (z @ z.T) / temperature
    m = pos + neg
    row_max = torch.where(m > 0, s, -1e30).max(1, keepdim=True).values
    e = torch.where(m > 0, torch.exp(s - row_max), 0.0)
    p = e / torch.clamp(e.sum(1, keepdim=True), min=1e-16)
    a = pos / torch.clamp(pos.sum(1, keepdim=True), min=1.0)
    w = a.sum(1, keepdim=True)
    G = -(a - w * p) / M
    return (G @ z + G.T @ z) / temperature * g


def supcon_dz(z: torch.Tensor, code: torch.Tensor, lse: torch.Tensor,
              pcount: torch.Tensor, g: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """Gradient of ``supcon_loss(z, code, temperature)[0].mean()`` in ``z``
    times the cotangent ``g`` (a one-element tensor) -> dz [M, d] f32, from
    D1's residuals ``lse`` and ``pcount``. Kernel D2 on CUDA."""
    if z.device.type == "cpu":
        return supcon_dz_plain(z, code, lse, pcount, g, temperature)
    z, code = z.contiguous(), code.contiguous()
    g = g.reshape(1).to(torch.float32).contiguous()
    _cuda_check("supcon_dz", z, code, lse, pcount, g)
    M, d = z.shape
    dz = torch.empty_like(z)
    rc = _build.load_library("supcon").supcon_dz(
        _ptr(z), _ptr(code), _ptr(lse), _ptr(pcount), _ptr(g), M, d,
        float(temperature), _ptr(dz), _stream())
    _build.check(rc, "supcon_dz", "supcon")
    LAUNCHES["supcon_dz"] += 1
    return dz


class _SupCon(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, code, temperature):
        loss, lse, pcount = supcon_loss(z, code, temperature)
        ctx.save_for_backward(z, code, lse, pcount)
        ctx.temperature = temperature
        return loss.mean()

    @staticmethod
    def backward(ctx, g):
        z, code, lse, pcount = ctx.saved_tensors
        return supcon_dz(z, code, lse, pcount, g, ctx.temperature), None, None


def sup_con_from_code(z: torch.Tensor, code: torch.Tensor,
                      temperature: float = 0.07) -> torch.Tensor:
    """z: [M, d] L2-normalized stacked projections (both views); code: [M, M]
    uint8 pair code (:func:`pair_code`, diagonal cleared). Returns the scalar
    mean per-anchor loss, differentiable in z (D1 forward, D2 backward)."""
    return _SupCon.apply(z.float(), code.contiguous(), float(temperature))
