"""Conv-block kernels of the wide U-Net levels, their plain versions, their
gradients and the conv-block stage (counterpart of
contrastyou_tpu/ops/pallas/convblock.py).

Three hand-written CUDA kernels (``csrc/tapconv.cu``) carry the five levels
with at most 64 channels (Conv1, Conv2, Up_conv3, Up2, Up_conv2):

- ``conv3x3_stats`` (K1): SAME 3x3 conv, optional skip input with its own
  weight slice, per-sample sum / sum-of-squares of the bf16 output. It is also
  the dx of its own backward, run on flipped, channel-swapped weights.
- ``upconv3x3_stats`` (K2): ``conv3x3(upsample2x_nearest(x))`` as four
  2x2-tap parity convs at input resolution, with the same statistics.
- ``upconv3x3_dx`` (K3): the adjoint of K2, on K1's body with the four
  parity sub-grids of the cotangent as its sources.

Two more (``csrc/convbwd.cu``) carry the backward from batch
:data:`BWD_KERNEL_MIN_BATCH` (96, the prostate contrastive batch), where the
JAX package routes its Pallas dW and fused-backward kernels:

- ``conv_dw_taps`` (C1): the weight gradient over a static tap set (the 3x3
  taps, or the 16 parity taps of Up2).
- ``conv3x3_bwd_fused`` (C2): dx and dW of a 3x3 conv from one pass over the
  cotangent.

Below that batch the weight gradients are per-tap einsums, as the JAX package
leaves them to XLA there.

Every wrapper dispatches on the device of its input: a CPU tensor goes to the
plain PyTorch version beside it (same signature, same rounding points: f32
accumulation, one rounding of the output to the input dtype, statistics of the
rounded output), a CUDA tensor to the kernel — which raises on what it does
not take. Activations are NHWC, weights HWIO.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3_stats", "conv3x3_stats_plain", "upconv3x3_stats",
           "upconv3x3_stats_plain", "upconv3x3_dx", "upconv3x3_dx_plain",
           "conv_dw_taps", "conv_dw_taps_plain", "conv3x3_bwd_fused",
           "conv3x3_bwd_fused_plain", "parity_taps", "conv3x3_bn_stats",
           "upconv3x3_bn_stats", "bn_relu", "bn_affine", "convblock_stage",
           "LAUNCHES", "reset_launch_counts", "BWD_KERNEL_MIN_BATCH"]

#: launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {"conv3x3_stats": 0, "upconv3x3_stats": 0, "upconv3x3_dx": 0,
            "conv_dw_taps": 0, "conv3x3_bwd_fused": 0}

#: output channel counts the kernels are instantiated for
KERNEL_COUT = (32, 64)
#: input channel counts K1 takes (1: the image conv, without a skip; a skip
#: has as many channels as the input beside it)
K1_CIN = (1, 32, 64)
#: input channel count K2 takes
K2_CIN = 64
#: input channel counts C1 takes on the 3x3 taps (on Up2's: K2_CIN only)
C1_CIN = (1, 32, 64)
#: batch from which the backward runs C1 / C2 (the automatic routing of the
#: JAX package's ``_dw_enabled`` and ``_fusedbwd_enabled``)
BWD_KERNEL_MIN_BATCH = 96
#: input channels from which a 3x3 conv's backward is fused (C2); the image
#: conv below it keeps dx on K1 and dW on C1 (``_plane_conv_bwd``)
FUSED_BWD_MIN_CIN = 8


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor by one pixel."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _stats(out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    of = out.float()
    return of.sum((1, 2)), (of * of).sum((1, 2))


def _cuda_check(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if (t.is_cuda and t.dtype is torch.bfloat16 and t.is_contiguous()
                and not t.data_ptr() % 16):
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs must be on the same CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address for a ``c_void_p`` argument (ctypes converts the int)."""
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s card, without building a
    ``torch.cuda.Stream`` (K1 launches dozens of times per step)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _partials_to_sums(part: torch.Tensor):
    return part.sum(1).unbind(1)                     # [B, 2, C] -> sum, sumsq


@functools.lru_cache(maxsize=None)
def _num_partials_tapconv(kind: int, H: int, W: int, cout: int) -> int:
    """Stat partials per sample of K1 (kind 0) or K2 (kind 1), as the
    library tiles the image."""
    return _build.load_library("tapconv").tapconv_num_partials(kind, H, W, cout)


# --- K1: 3x3 conv (+ skip) with BN statistics -----------------------------

def conv3x3_stats_plain(x: torch.Tensor, w: torch.Tensor,
                        skip: Optional[torch.Tensor] = None,
                        w_skip: Optional[torch.Tensor] = None,
                        stats: bool = True):
    """Plain version of :func:`conv3x3_stats`."""
    def conv(a, k):
        return F.conv2d(a.float().permute(0, 3, 1, 2),
                        k.float().permute(3, 2, 0, 1), padding=1)

    acc = conv(x, w)
    if skip is not None:
        acc = acc + conv(skip, w_skip)
    out = acc.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    return (out, *_stats(out)) if stats else (out, None, None)


def conv3x3_stats(x: torch.Tensor, w: torch.Tensor,
                  skip: Optional[torch.Tensor] = None,
                  w_skip: Optional[torch.Tensor] = None,
                  stats: bool = True):
    """SAME 3x3 correlation of NHWC ``x`` [B,H,W,Cin] with HWIO ``w``
    [3,3,Cin,Cout], plus ``skip`` [B,H,W,Cs] with ``w_skip`` [3,3,Cs,Cout]
    when given (== one conv over ``cat([skip, x], -1)``).

    Returns ``(out [B,H,W,Cout] in x.dtype, sum, sumsq)``: the per-sample
    [B, Cout] f32 statistics of the rounded output, or ``None`` when
    ``stats=False``. Kernel K1 on CUDA (bf16, Cin in {1, 32, 64}, a skip
    as wide as ``x``, Cout in {32, 64})."""
    if x.is_cpu:
        return conv3x3_stats_plain(x, w, skip, w_skip, stats)
    out, part = _conv3x3_launch(x, w, skip, w_skip, stats)
    return (out, *_partials_to_sums(part)) if stats else (out, None, None)


def _conv3x3_launch(x, w, skip, w_skip, stats: bool):
    """One K1 launch on CUDA tensors -> (out, the per-(sample, tile) stat
    partials [B, tiles, 2, Cout] f32, or None without stats)."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    cs = 0 if skip is None else skip.shape[-1]
    if (cout not in KERNEL_COUT or cin not in K1_CIN or tuple(w.shape) != (3, 3, cin, cout)
            or (skip is not None and (cin == 1 or cs != cin or skip.shape[:3] != x.shape[:3]
                                      or tuple(w_skip.shape) != (3, 3, cs, cout)))):
        raise ValueError(f"conv3x3_stats: x {tuple(x.shape)}, w {tuple(w.shape)}, skip "
                         f"channels {cs}; the kernel takes Cin in {K1_CIN} (a skip of the "
                         f"same size only beside Cin > 1) and Cout in {KERNEL_COUT}")
    w9 = w.reshape(9, cin, cout).contiguous()
    ws9 = None if skip is None else w_skip.reshape(9, cs, cout).contiguous()
    _cuda_check("conv3x3_stats", *[t for t in (x, w9, skip, ws9) if t is not None])
    lib = _build.load_library("tapconv")
    out = x.new_empty((B, H, W, cout))
    part = (x.new_empty((B, _num_partials_tapconv(0, H, W, cout), 2, cout), dtype=torch.float32)
            if stats else None)
    rc = lib.conv3x3_stats(_ptr(x), cin, _ptr(w9), _ptr(skip), cs, _ptr(ws9), _ptr(out),
                           _ptr(part), B, H, W, cout, _stream(x))
    _build.check(rc, "conv3x3_stats", "tapconv")
    LAUNCHES["conv3x3_stats"] += 1
    return out, part


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """HWIO kernel of the transposed conv: spatially flipped, in/out swapped
    (convblock.py ``fold_kernel_transposed``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [3,3,Cin,Cout] of the SAME 3x3 conv: per-tap shifted views of
    ``x`` contracted with ``g`` in their dtype, f32 accumulation and one
    rounding (the XLA einsums of convblock.py ``_plane_conv_bwd``)."""
    B, H, W, _ = x.shape
    xp = _pad_hw(x)
    taps = [torch.einsum("bhwi,bhwo->io", xp[:, dy:dy + H, dx:dx + W], g)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, *taps[0].shape)


def _cotangent(out, g_out, g_s, g_sq, dtype):
    """Fold the statistics' cotangents into the output's:
    d(sum)/d(out) = 1, d(sumsq)/d(out) = 2*out (convblock.py _pcs_bwd)."""
    g = g_out.float() if g_out is not None else torch.zeros_like(out, dtype=torch.float32)
    if g_s is not None:
        g = g + g_s[:, None, None, :]
    if g_sq is not None:
        g = g + 2.0 * out.float() * g_sq[:, None, None, :]
    return g.to(dtype).contiguous()


class _Conv3x3Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, skip, w_skip):
        out, s, sq = conv3x3_stats(x, w, skip, w_skip, stats=True)
        ctx.save_for_backward(x, w, skip, w_skip, out)
        return out, s, sq

    @staticmethod
    def backward(ctx, g_out, g_s, g_sq):
        x, w, skip, w_skip, out = ctx.saved_tensors
        g = _cotangent(out, g_out, g_s, g_sq, x.dtype)
        need = ctx.needs_input_grad
        dx, dw = _conv3x3_bwd(x, w, g, need[0], need[1])
        dskip = dws = None
        if skip is not None:
            # the skip's slice of the conv: its own C2 launch on the same g
            dskip, dws = _conv3x3_bwd(skip, w_skip, g, need[2], need[3])
        return dx, dw, dskip, dws


def _conv3x3_bwd(x, w, g, need_dx: bool, need_dw: bool):
    """(dx, dW) of one input of a 3x3 conv for the folded cotangent ``g``,
    None where not needed (convblock.py ``_plane_conv_bwd``). Below
    :data:`BWD_KERNEL_MIN_BATCH`: dx on K1 with the flipped kernel, dW by
    per-tap einsums. From it: C2 when Cin >= :data:`FUSED_BWD_MIN_CIN`, else
    dx on K1 and dW on C1."""
    if x.shape[0] >= BWD_KERNEL_MIN_BATCH:
        if need_dw and x.shape[-1] >= FUSED_BWD_MIN_CIN:
            dx, dk = conv3x3_bwd_fused(x, w, g)
            return (dx if need_dx else None), dk.to(w.dtype)
        dw = conv_dw_taps(x, g).reshape(w.shape).to(w.dtype) if need_dw else None
    else:
        dw = conv3x3_dw(x, g).to(w.dtype) if need_dw else None
    dx = conv3x3_stats(g, flip_transpose(w), stats=False)[0] if need_dx else None
    return dx, dw


def conv3x3_bn_stats(x, w, skip=None, w_skip=None):
    """Differentiable :func:`conv3x3_stats` (stats included)."""
    return _Conv3x3Stats.apply(x, w, skip, w_skip)


# --- K2 / K3: nearest-2x upsample + 3x3 conv as four parity convs --------

def parity_taps(k3: torch.Tensor) -> torch.Tensor:
    """Fold an HWIO [3,3,Cin,Cout] kernel into the 2x2 taps of each output
    parity of ``conv3x3_SAME(upsample2x_nearest(x))`` -> [4 parities (a, b),
    4 taps (r, c), Cin, Cout]; tap (r, c) of parity (a, b) reads input offset
    (r + a - 1, c + b - 1) (convblock.py ``_parity_taps``). Plain torch, so
    autograd carries the taps' gradient back to ``k3``."""
    out = []
    for a in (0, 1):
        rows = (k3[0], k3[1] + k3[2]) if a == 0 else (k3[0] + k3[1], k3[2])
        for b in (0, 1):
            for kr in rows:
                out += ([kr[0], kr[1] + kr[2]] if b == 0
                        else [kr[0] + kr[1], kr[2]])
    return torch.stack(out).reshape(4, 4, *k3.shape[2:])


def _parity_offsets(p: int, t: int) -> Tuple[int, int]:
    a, b = divmod(p, 2)
    r, c = divmod(t, 2)
    return r + a - 1, c + b - 1


def upconv3x3_stats_plain(x: torch.Tensor, taps: torch.Tensor):
    """Plain version of :func:`upconv3x3_stats`."""
    B, H, W, _ = x.shape
    xp = _pad_hw(x.float())
    out = torch.empty(B, 2 * H, 2 * W, taps.shape[-1], dtype=x.dtype,
                      device=x.device)
    for p in range(4):
        acc = 0.0
        for t in range(4):
            dy, dx = _parity_offsets(p, t)
            acc = acc + torch.einsum(
                "bhwi,io->bhwo", xp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W],
                taps[p, t].float())
        a, b = divmod(p, 2)
        out[:, a::2, b::2] = acc.to(x.dtype)
    return (out, *_stats(out))


def upconv3x3_stats(x: torch.Tensor, taps: torch.Tensor):
    """``conv3x3_SAME(upsample2x_nearest(x))`` for NHWC ``x`` [B,H,W,Cin] with
    parity ``taps`` [4,4,Cin,Cout] (:func:`parity_taps`) -> (out
    [B,2H,2W,Cout], per-sample sum, sumsq of the rounded output). Kernel K2
    on CUDA (bf16, Cin 64, Cout in {32, 64})."""
    if x.is_cpu:
        return upconv3x3_stats_plain(x, taps)
    out, part = _upconv_launch(x, taps)
    return (out, *_partials_to_sums(part))


def _upconv_launch(x, taps):
    """One K2 launch on CUDA tensors -> (out, the per-(sample, tile) stat
    partials [B, tiles, 2, Cout] f32)."""
    B, H, W, cin = x.shape
    cout = taps.shape[-1]
    if cout not in KERNEL_COUT or cin != K2_CIN or taps.shape[:3] != (4, 4, cin):
        raise ValueError(f"upconv3x3_stats: taps {tuple(taps.shape)} for Cin={cin}; the "
                         f"kernel takes Cin {K2_CIN} and Cout in {KERNEL_COUT}")
    taps = taps.contiguous()
    _cuda_check("upconv3x3_stats", x, taps)
    lib = _build.load_library("tapconv")
    out = x.new_empty((B, 2 * H, 2 * W, cout))
    part = x.new_empty((B, _num_partials_tapconv(1, H, W, cout), 2, cout), dtype=torch.float32)
    rc = lib.upconv3x3_stats(_ptr(x), _ptr(taps), _ptr(out), _ptr(part),
                             B, H, W, cin, cout, _stream(x))
    _build.check(rc, "upconv3x3_stats", "tapconv")
    LAUNCHES["upconv3x3_stats"] += 1
    return out, part


def upconv3x3_dx_plain(g: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`upconv3x3_dx`."""
    B, H2, W2, _ = g.shape
    H, W = H2 // 2, W2 // 2
    acc = 0.0
    for p in range(4):
        a, b = divmod(p, 2)
        gp = _pad_hw(g[:, a::2, b::2].float())
        for t in range(4):
            dy, dx = _parity_offsets(p, t)
            acc = acc + torch.einsum(
                "bhwo,io->bhwi", gp[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W],
                taps[p, t].float())
    return acc.to(g.dtype).contiguous()


def upconv3x3_dx(g: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`upconv3x3_stats` in x: cotangent ``g``
    [B,2H,2W,Cout] -> dx [B,H,W,Cin]. Kernel K3 on CUDA (bf16, Cin and Cout
    in {32, 64}); it reads ``taps`` as they are."""
    if g.device.type == "cpu":
        return upconv3x3_dx_plain(g, taps)
    B, H2, W2, cg = g.shape
    cin = taps.shape[2]
    if (H2 % 2 or W2 % 2 or cin not in KERNEL_COUT or cg not in KERNEL_COUT
            or tuple(taps.shape) != (4, 4, cin, cg)):
        raise ValueError(f"upconv3x3_dx: g {tuple(g.shape)}, taps {tuple(taps.shape)}; the "
                         f"kernel takes even H and W, Cin and Cout in {KERNEL_COUT}")
    taps = taps.contiguous()
    _cuda_check("upconv3x3_dx", g, taps)
    lib = _build.load_library("tapconv")
    dx = torch.empty(B, H2 // 2, W2 // 2, cin, dtype=g.dtype, device=g.device)
    rc = lib.upconv3x3_dx(_ptr(g), _ptr(taps), _ptr(dx), B, H2 // 2,
                          W2 // 2, cg, cin, _stream(g))
    _build.check(rc, "upconv3x3_dx", "tapconv")
    LAUNCHES["upconv3x3_dx"] += 1
    return dx


def upconv3x3_dtaps(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of the parity taps [4,4,Cin,Cout] (convblock.py ``_pcts_bwd``
    einsums), in the operands' dtype with f32 accumulation."""
    B, H, W, _ = x.shape
    xp = _pad_hw(x)
    out = []
    for p in range(4):
        a, b = divmod(p, 2)
        gp = g[:, a::2, b::2]
        for t in range(4):
            dy, dx = _parity_offsets(p, t)
            out.append(torch.einsum(
                "bhwi,bhwo->io", xp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W],
                gp))
    return torch.stack(out).reshape(4, 4, *out[0].shape)


class _UpconvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        out, s, sq = upconv3x3_stats(x, taps)
        ctx.save_for_backward(x, taps, out)
        return out, s, sq

    @staticmethod
    def backward(ctx, g_out, g_s, g_sq):
        x, taps, out = ctx.saved_tensors
        g = _cotangent(out, g_out, g_s, g_sq, x.dtype)
        dx = upconv3x3_dx(g, taps) if ctx.needs_input_grad[0] else None
        dtaps = None
        if ctx.needs_input_grad[1]:
            dtaps = (conv_dw_taps(x, g, up2=True).reshape(taps.shape)
                     if x.shape[0] >= BWD_KERNEL_MIN_BATCH
                     else upconv3x3_dtaps(x, g)).to(taps.dtype)
        return dx, dtaps


def upconv3x3_bn_stats(x, k3):
    """Differentiable :func:`upconv3x3_stats` on an HWIO 3x3 kernel."""
    return _UpconvStats.apply(x, parity_taps(k3))


# --- C1 / C2: weight gradient and fused backward from batch 96 -------------

def _tap_offsets(up2: bool):
    """(dy, dx) of each tap: the 3x3 taps in HWIO order, or the 16 parity
    taps of Up2 (parity-major, as :func:`parity_taps` orders them)."""
    if up2:
        return [_parity_offsets(p, t) for p in range(4) for t in range(4)]
    return [(dy - 1, dx - 1) for dy in range(3) for dx in range(3)]


def conv_dw_taps_plain(x: torch.Tensor, g: torch.Tensor, up2: bool = False) -> torch.Tensor:
    """Plain version of :func:`conv_dw_taps` (f32 accumulation)."""
    B, H, W, _ = x.shape
    xp = _pad_hw(x.float())
    out = []
    for k, (dy, dx) in enumerate(_tap_offsets(up2)):
        a, b = divmod(k // 4, 2)
        gs = g[:, a::2, b::2] if up2 else g
        out.append(torch.einsum("bhwi,bhwo->io",
                                xp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W], gs.float()))
    return torch.stack(out)


def _num_partials(lib, mode: int, B: int, H: int, W: int, cin: int, cout: int) -> int:
    nb = lib.convbwd_num_partials(mode, B, H, W, cin, cout)
    if nb <= 0:
        _build.check(-nb or 1, "convbwd_num_partials", "convbwd")
    return nb


def conv_dw_taps(x: torch.Tensor, g: torch.Tensor, up2: bool = False) -> torch.Tensor:
    """Weight gradient over a static tap set: dk [T, Cin, Cout] f32 with
    dk[t,i,o] = sum_{b,h,w} x[b, h+dy_t, w+dx_t, i] * g[b,h,w,o], x zero
    outside the image (convblock.py ``plane_conv_dw``). 3x3: the 9 taps of a
    SAME conv in HWIO order, ``g`` [B,H,W,Cout]. ``up2``: the 16 parity taps
    of :func:`upconv3x3_stats` ([4 parities, 4 taps] flattened), ``g``
    [B,2H,2W,Cout] read on parity (a, b)'s sub-grid ``g[:, a::2, b::2]``.
    Kernel C1 on CUDA (bf16, Cin in {1, 32, 64} on the 3x3 taps and 64 on
    the Up2 taps, K2's only input width; Cout in {32, 64})."""
    if x.device.type == "cpu":
        return conv_dw_taps_plain(x, g, up2)
    return _dw_launch(x, g, up2)[0]


def _dw_launch(x: torch.Tensor, g: torch.Tensor, up2: bool):
    """One C1 launch on CUDA tensors -> (dk, the per-block partials
    [nb, T, Cin, Cout] f32 it summed)."""
    B, H, W, cin = x.shape
    cout = g.shape[-1]
    _cuda_check("conv_dw_taps", x, g)
    s = 2 if up2 else 1
    if (cout not in KERNEL_COUT or (cin != K2_CIN if up2 else cin not in C1_CIN)
            or tuple(g.shape[:3]) != (B, s * H, s * W)):
        raise ValueError(f"conv_dw_taps: x {tuple(x.shape)}, g {tuple(g.shape)} "
                         f"(up2={up2}); the kernel takes Cin in {C1_CIN} on the 3x3 "
                         f"taps, {K2_CIN} on the Up2 taps, and Cout in {KERNEL_COUT}")
    lib = _build.load_library("convbwd")
    taps = 16 if up2 else 9
    nb = _num_partials(lib, int(up2), B, H, W, cin, cout)
    part = torch.empty(nb, taps, cin, cout, dtype=torch.float32, device=x.device)
    dk = torch.empty(taps, cin, cout, dtype=torch.float32, device=x.device)
    rc = lib.conv_dw_taps(_ptr(x), _ptr(g), int(up2), _ptr(part), _ptr(dk),
                          B, H, W, cin, cout, _stream(x))
    _build.check(rc, "conv_dw_taps", "convbwd")
    LAUNCHES["conv_dw_taps"] += 1
    return dk, part


def conv3x3_bwd_fused_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Plain version of :func:`conv3x3_bwd_fused`."""
    dx = conv3x3_stats_plain(g, flip_transpose(w), stats=False)[0]
    return dx, conv_dw_taps_plain(x, g).reshape(3, 3, x.shape[-1], g.shape[-1])


def conv3x3_bwd_fused(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Backward of the SAME 3x3 conv of ``x`` [B,H,W,Cin] with HWIO ``w``
    for the output cotangent ``g`` [B,H,W,Cout] (convblock.py
    ``plane_conv_bwd_fused``) -> (dx [B,H,W,Cin] in g's dtype, one rounding
    of f32 sums; dk [3,3,Cin,Cout] f32). Kernel C2 on CUDA (bf16, Cin a
    multiple of 16, Cout in {32, 64}): each cotangent tile is loaded once
    for both products."""
    if x.device.type == "cpu":
        return conv3x3_bwd_fused_plain(x, w, g)
    B, H, W, cin = x.shape
    cout = g.shape[-1]
    w = w.contiguous()
    _cuda_check("conv3x3_bwd_fused", x, w, g)
    if (cout not in KERNEL_COUT or cin % 16 or tuple(w.shape) != (3, 3, cin, cout)
            or g.shape[:3] != x.shape[:3]):
        raise ValueError(f"conv3x3_bwd_fused: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"g {tuple(g.shape)}; Cin must be a multiple of 16, Cout "
                         f"in {KERNEL_COUT}")
    lib = _build.load_library("convbwd")
    nb = _num_partials(lib, 2, B, H, W, cin, cout)
    part = torch.empty(nb, 9, cin, cout, dtype=torch.float32, device=x.device)
    dk = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    rc = lib.conv3x3_bwd_fused(_ptr(x), _ptr(w), _ptr(g), _ptr(dx), _ptr(part), _ptr(dk),
                               B, H, W, cin, cout, _stream(x))
    _build.check(rc, "conv3x3_bwd_fused", "convbwd")
    LAUNCHES["conv3x3_bwd_fused"] += 1
    return dx, dk


# --- BatchNorm + ReLU ------------------------------------------------------

def bn_affine(ssum: torch.Tensor, ssq: torch.Tensor, count: int,
              scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Batch statistics (summed over the batch) + BN params -> the (a, b) of
    ``a*x + b`` and the (mean, biased var) for the running update
    (convblock.py ``bn_affine``)."""
    mean = ssum / count
    var = torch.clamp(ssq / count - mean * mean, min=0.0)
    a = scale * torch.rsqrt(var + eps)
    return a, bias - a * mean, mean, var


class _BNReLU(torch.autograd.Function):
    """``relu(x*a + b)`` in f32, stored in x's dtype. The backward rebuilds
    the ReLU mask from the stored output, so no f32 pre-activation is kept
    (convblock.py ``_bn_relu_planes_bwd``)."""

    @staticmethod
    def forward(ctx, x, a, b):
        h = torch.relu(x.float() * a + b).to(x.dtype)
        ctx.save_for_backward(x, a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        x, a, h = ctx.saved_tensors
        gh = torch.where(h > 0, g.float(), 0.0)
        dims = tuple(range(x.dim() - 1))
        gx = (gh * a).to(x.dtype) if ctx.needs_input_grad[0] else None
        ga = (gh * x.float()).sum(dims) if ctx.needs_input_grad[1] else None
        gb = gh.sum(dims) if ctx.needs_input_grad[2] else None
        return gx, ga, gb


def bn_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _BNReLU.apply(x, a, b)


def convblock_stage(x: torch.Tensor, skip: Optional[torch.Tensor],
                    k0: torch.Tensor, k1: torch.Tensor, bn0, bn1, *,
                    train: bool, update_stats: bool = True) -> torch.Tensor:
    """conv0 (+skip) -> BN -> ReLU -> conv1 -> BN -> ReLU on NHWC tensors,
    through K1 (convblock.py ``convblock_stage``). ``k0``/``k1`` are HWIO in
    the compute dtype; ``bn0``/``bn1`` are the block's BatchNorm modules,
    whose :meth:`affine` turns per-sample statistics into the BN affine and
    updates the running statistics when ``train and update_stats``."""
    if skip is not None:
        cs = skip.shape[-1]
        p0, s0, q0 = conv3x3_bn_stats(x, k0[:, :, cs:], skip, k0[:, :, :cs])
    else:
        p0, s0, q0 = conv3x3_bn_stats(x, k0)
    h0 = bn_relu(p0, *bn0.affine(p0, s0, q0, train=train, update=update_stats))
    p1, s1, q1 = conv3x3_bn_stats(h0, k1)
    return bn_relu(p1, *bn1.affine(p1, s1, q1, train=train, update=update_stats))
