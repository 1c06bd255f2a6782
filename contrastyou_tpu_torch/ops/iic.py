"""Dense-IIC displacement joints: kernels E1/E2, their plain versions and the
differentiable joints (counterpart of contrastyou_tpu/ops/pallas/iic.py).

A linear dense cluster head with S subheads of K clusters projects each pixel
of two NHWC feature maps, ``f1`` (the aligned first view) and ``f2`` (the
second view), through one merged weight ``w`` [C, S*K] (subhead-major) and
bias ``b`` [S*K], takes a softmax per subhead, and sums the displacement
joints

    raw[s, ty, tx, i, j] = sum_{b,h,w} p1[b, h+dy, w+dx, s, i] * p2[b, h, w, s, j]

over the (2*padding+1)^2 displacements (dy, dx) = (ty, tx) - padding, with p1
zero outside the image. Two hand-written CUDA kernels (``csrc/iic.cu``):

- ``iic_joints`` (E1): the raw joints [S, Td, Td, K, K] f32 straight from the
  features; the probability maps never reach device memory.
- ``iic_joints_bwd`` (E2): from a cotangent of the joints, df1 and df2 (in the
  features' dtype), dW [C, S*K] and db [S*K] (f32), recomputing the softmaxes.

Both take ``w`` and ``b`` with the temperature already folded in (1/T);
:func:`fused_dense_iic_raw_joints` folds it with differentiable torch ops, so
the gradients of the unfolded parameters pass through the fold. Every wrapper
dispatches on the device of its input: a CPU tensor goes to the plain PyTorch
version beside it (the literal math of ``dense_cluster_probs_merged`` +
``_merged_displacement_joints`` and of their VJP), a CUDA tensor to the
kernel, which raises on what it does not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["KERNEL_C", "KERNEL_K", "MAX_PADDING", "MAX_SK", "LAUNCHES",
           "reset_launch_counts", "iic_joints", "iic_joints_plain",
           "iic_joints_bwd", "iic_joints_bwd_plain", "fused_dense_iic_raw_joints"]

#: launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {"iic_joints": 0, "iic_joints_bwd": 0}

#: what the kernels take: feature widths, clusters per subhead, the largest
#: displacement padding and the largest merged head width S*K
KERNEL_C = (8, 16, 32)
KERNEL_K = (20,)
MAX_PADDING = 2
MAX_SK = 160


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _probs(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           num_subheads: int, num_clusters: int) -> torch.Tensor:
    """[B, H, W, C] features -> [B, H, W, S, K] per-subhead softmaxes of
    ``f @ w + b`` (the merged projection, computed in w's dtype: f32 on every
    path, f64 for a reference)."""
    z = f.to(w.dtype) @ w + b
    return torch.softmax(z.reshape(*f.shape[:3], num_subheads, num_clusters), -1)


def _pad_hw(p: torch.Tensor, padding: int) -> torch.Tensor:
    """Zero-pad H and W of a [B, H, W, S, K] map by ``padding``."""
    return F.pad(p, (0, 0, 0, 0, padding, padding, padding, padding))


def iic_joints_plain(f1: torch.Tensor, f2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     *, num_subheads: int, num_clusters: int, padding: int) -> torch.Tensor:
    """Plain version of :func:`iic_joints`: both softmaxes, then one
    per-subhead contraction per displacement against the zero-padded p1."""
    p1 = _pad_hw(_probs(f1, w, b, num_subheads, num_clusters), padding)
    p2 = _probs(f2, w, b, num_subheads, num_clusters)
    H, W = f2.shape[1:3]
    td = 2 * padding + 1
    return torch.stack([torch.stack([
        torch.einsum("bhwsi,bhwsj->sij", p1[:, ty:ty + H, tx:tx + W], p2)
        for tx in range(td)], 1) for ty in range(td)], 1)


def _softmax_vjp(dp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """dz = s * (dp - <dp, s>) per subhead (the softmax's VJP)."""
    return s * (dp - (dp * s).sum(-1, keepdim=True))


def iic_joints_bwd_plain(f1: torch.Tensor, f2: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, jbar: torch.Tensor, *, num_subheads: int,
                         num_clusters: int, padding: int):
    """Plain version of :func:`iic_joints_bwd` (``_bwd_kernel``'s formulas):
    dp2 = sum_t Jbar_t^T shift_t(p1), dp1 = sum_t shift_t^-1(Jbar_t p2), the
    softmax VJP per subhead, then df = dz W^T, dW = sum f dz^T, db = sum dz."""
    S, K, p = num_subheads, num_clusters, padding
    B, H, W, C = f1.shape
    td = 2 * p + 1
    s1 = _probs(f1, w, b, S, K)
    s2 = _probs(f2, w, b, S, K)
    p1 = _pad_hw(s1, p)
    dp2 = sum(torch.einsum("bhwsi,sij->bhwsj", p1[:, ty:ty + H, tx:tx + W], jbar[:, ty, tx])
              for ty in range(td) for tx in range(td))
    dp1 = s2.new_zeros(B, H + 2 * p, W + 2 * p, S, K)
    for ty in range(td):
        for tx in range(td):
            dp1[:, ty:ty + H, tx:tx + W] += torch.einsum("bhwsj,sij->bhwsi", s2,
                                                         jbar[:, ty, tx])
    dz1 = _softmax_vjp(dp1[:, p:p + H, p:p + W], s1).reshape(B, H, W, S * K)
    dz2 = _softmax_vjp(dp2, s2).reshape(B, H, W, S * K)
    df1 = (dz1 @ w.T).to(f1.dtype)
    df2 = (dz2 @ w.T).to(f2.dtype)
    dw = (torch.einsum("bhwc,bhwk->ck", f1.to(dz1.dtype), dz1)
          + torch.einsum("bhwc,bhwk->ck", f2.to(dz2.dtype), dz2))
    db = dz1.sum((0, 1, 2)) + dz2.sum((0, 1, 2))
    return df1, df2, dw, db


def _cuda_check(what: str, f1, f2, w, b, S: int, K: int, padding: int,
                jbar: Optional[torch.Tensor] = None) -> None:
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"{what}: f1 and f2 must lie on one CUDA device")
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise ValueError(f"{what}: features must both be bfloat16 or float32, "
                         f"got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f2.shape != f1.shape:
        raise ValueError(f"{what}: f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} must be "
                         "one NHWC shape")
    C = f1.shape[-1]
    if (C not in KERNEL_C or K not in KERNEL_K or S < 1 or S * K > MAX_SK
            or not 0 <= padding <= MAX_PADDING):
        raise ValueError(f"{what}: C={C}, K={K}, S*K={S * K}, padding={padding}; the kernel "
                         f"takes C in {KERNEL_C}, K in {KERNEL_K}, S*K <= {MAX_SK}, "
                         f"padding <= {MAX_PADDING}")
    td = 2 * padding + 1
    want = [(w, (C, S * K)), (b, (S * K,))]
    if jbar is not None:
        want.append((jbar, (S, td, td, K, K)))
    for t, shape in want:
        if t.device != f1.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: want a float32 {shape} tensor on {f1.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (f1, f2, *(t for t, _ in want)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and 16-byte aligned")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _num_partials(lib, mode: int, f: torch.Tensor, S: int, K: int, padding: int) -> int:
    """Rows of the f32 buffer a kernel writes its per-block partials into:
    E1 (mode 0) one per block; E2 (mode 1) one per block, then the rows of
    E2's workspace (each subhead's centred, split cotangent and split W_s,
    written by its preparation kernel)."""
    B, H, W, C = f.shape
    n = lib.iic_num_partials(mode, B, H, W, C, S, K, padding, int(f.dtype == torch.bfloat16))
    if n <= 0:
        _build.check(-n or 1, "iic_num_partials", "iic")
    return n


def iic_joints(f1: torch.Tensor, f2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               num_subheads: int, num_clusters: int, padding: int) -> torch.Tensor:
    """Raw displacement joints [S, Td, Td, K, K] f32 of the features ``f1``
    (aligned view) and ``f2`` [B, H, W, C] under the merged head ``w`` [C,
    S*K], ``b`` [S*K] (1/T folded in). Kernel E1 on CUDA (bf16 or f32
    features, C in :data:`KERNEL_C`, K in :data:`KERNEL_K`)."""
    S, K, p = int(num_subheads), int(num_clusters), int(padding)
    if f1.device.type == "cpu":
        return iic_joints_plain(f1, f2, w, b, num_subheads=S, num_clusters=K, padding=p)
    _cuda_check("iic_joints", f1, f2, w, b, S, K, p)
    B, H, W, C = f1.shape
    lib = _build.load_library("iic")
    td = 2 * p + 1
    nparts = _num_partials(lib, 0, f1, S, K, p)
    part = torch.empty(S, nparts, td * td, K, K, dtype=torch.float32, device=f1.device)
    raw = torch.empty(S, td, td, K, K, dtype=torch.float32, device=f1.device)
    rc = lib.iic_joints(_ptr(f1), _ptr(f2), _ptr(w), _ptr(b), _ptr(part), _ptr(raw),
                        B, H, W, C, S, K, p, int(f1.dtype == torch.bfloat16), _stream())
    _build.check(rc, "iic_joints", "iic")
    LAUNCHES["iic_joints"] += 1
    return raw


def iic_joints_bwd(f1: torch.Tensor, f2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   jbar: torch.Tensor, *, num_subheads: int, num_clusters: int,
                   padding: int) -> Tuple[torch.Tensor, ...]:
    """VJP of :func:`iic_joints` for the cotangent ``jbar`` [S, Td, Td, K, K]
    -> (df1, df2 in the features' dtype, dW [C, S*K] f32, db [S*K] f32).
    Kernel E2 on CUDA (the inputs E1 takes)."""
    S, K, p = int(num_subheads), int(num_clusters), int(padding)
    if f1.device.type == "cpu":
        return iic_joints_bwd_plain(f1, f2, w, b, jbar, num_subheads=S, num_clusters=K,
                                    padding=p)
    _cuda_check("iic_joints_bwd", f1, f2, w, b, S, K, p, jbar)
    B, H, W, C = f1.shape
    lib = _build.load_library("iic")
    # the blocks' dW / db partials followed by the operand workspace
    rows = _num_partials(lib, 1, f1, S, K, p)
    work = torch.empty(rows, S * (C + 1) * K, dtype=torch.float32, device=f1.device)
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    dw = torch.empty(C, S * K, dtype=torch.float32, device=f1.device)
    db = torch.empty(S * K, dtype=torch.float32, device=f1.device)
    rc = lib.iic_joints_bwd(_ptr(f1), _ptr(f2), _ptr(w), _ptr(b), _ptr(jbar), _ptr(df1),
                            _ptr(df2), _ptr(work), _ptr(dw), _ptr(db), B, H, W, C, S, K, p,
                            int(f1.dtype == torch.bfloat16), _stream())
    _build.check(rc, "iic_joints_bwd", "iic")
    LAUNCHES["iic_joints_bwd"] += 1
    return df1, df2, dw, db


class _Joints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, b, f1, f2, S, K, padding):
        ctx.save_for_backward(w, b, f1, f2)
        ctx.meta = (S, K, padding)
        return iic_joints(f1, f2, w, b, num_subheads=S, num_clusters=K, padding=padding)

    @staticmethod
    def backward(ctx, jbar):
        w, b, f1, f2 = ctx.saved_tensors
        S, K, p = ctx.meta
        df1, df2, dw, db = iic_joints_bwd(f1, f2, w, b, jbar.contiguous(), num_subheads=S,
                                          num_clusters=K, padding=p)
        return dw, db, df1, df2, None, None, None


def fused_dense_iic_raw_joints(w: torch.Tensor, b: torch.Tensor, f1: torch.Tensor,
                               f2: torch.Tensor, *, num_subheads: int, num_clusters: int,
                               padding: int, T: float = 1.0) -> torch.Tensor:
    """Raw per-subhead displacement joints [S, Td, Td, K, K] of a linear
    dense cluster head, ``w`` [C, S*K] and ``b`` [S*K] with temperature
    ``T``, on ``f1`` (aligned view) and ``f2`` [B, H, W, C]; differentiable
    in all four (E1 forward, E2 backward; the 1/T fold is a torch op, so dW
    and db pass through it)."""
    return _Joints.apply((w / T).contiguous(), (b / T).contiguous(), f1.contiguous(),
                         f2.contiguous(), int(num_subheads), int(num_clusters), int(padding))
