#!/usr/bin/env python3
"""Smoke run of the PyTorch port (contrastyou_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. a CUDA card is present; print its name and power limit (nvidia-smi);
2. build the hand-written kernels from ``contrastyou_tpu_torch/ops/csrc``
   (one nvcc per source, started together);
3. every conv kernel (K1-K3) against its plain PyTorch version on the card,
   at the shapes the main paths give it (forward and dx, batch 5 and 10 of
   ``semi``, batch 36 of ACDC and 96 of prostate pretraining), bf16, with
   kernel, plain and library
   (cuDNN bf16 channels-last convolution) times from CUDA events;
4. the SupCon kernels (D1 ``supcon_loss``, D2 ``supcon_dz``) against their
   plain versions at M = 36, 180 and 256 anchors, d = 256, partition and
   identity masks, f32 with TF32 off;
5. the backward kernels (C1 ``conv_dw_taps``, C2 ``conv3x3_bwd_fused``)
   against their plain versions at the shapes of the paths' backward (C1:
   Conv1.conv0 and the Up2 parity taps; C2: the seven convs with Cin >= 8, a
   skip conv as one launch per input), at batch 96 (prostate) with kernel,
   plain, library (one cuDNN ``convolution_backward``, bf16 channels-last)
   and bound times, then at batches 5, 10 (semi) and 36 (ACDC) with kernel,
   library and bound times beside the einsum form (``conv3x3_dw`` /
   ``upconv3x3_dtaps``, plus K1's dx for C2) that the JAX package's XLA path
   takes there; at every batch C2 also beside the split form on the port's
   own kernels (K1 dx on the flipped kernel + C1 dk), and both kernels
   twice on the same inputs, bitwise equal;
6. the full-width U-Net (max_channel 512, 224x224, 4 classes) on random
   weights: its kernel-path levels against the same levels on the plain
   versions at batch 5 and at batch 96 (the backward takes C1/C2 at both),
   then warm-up and timed ``semi`` + consistency steps (5
   labeled + 5 unlabeled slices) through ``build_cached_train_step`` on a
   device-resident synthetic split; losses finite, parameters changed,
   K1, C1 and C2 launched as often per step as the path implies (16, 4 and
   18), K2 and K3 launched;
7. ``pretrain_decoder`` (config/base + pretrain + hooks/infonce: InfoNCE on
   Conv5 by partition and on Up_conv2 by self, 18-slice contrastive batches,
   36 images per forward) and ``pretrain`` (hooks/infonce_encoder) at full
   width through ``build_pretrain_run``: the hook losses of one batch through
   D1 against the plain SupCon, then warm-up and timed steps; losses finite,
   trainable parameters changed, frozen layers (``_Deconv_1x1``; every
   decoder layer for ``pretrain``) bit-unchanged, D1 and D2 launched once
   per hook per step, C1/C2 as often as the path implies (decoder: 2 and 9
   per step, encoder: 1 and 3);
8. the same two trainers with ``-o Data.name=prostate`` (2 classes, 8
   partitions, random 48-slice batches, 96 images per forward, colour
   jitter 0.1): the same checks, with D1/D2 once per step (the Conv5 hook;
   the dense hook's 480 anchors take the eager form) and C1/C2 as often as
   the path implies (decoder: 2 and 9 per step, encoder: 1 and 3);
9. the dense-IIC kernels (E1 ``iic_joints``, E2 ``iic_joints_bwd``) against
   their plain versions at the Up_conv2 taps of ``semi``'s unlabeled batch
   (f1, f2 [5, 224, 224, 32] bf16, 5 subheads of 20 clusters) at paddings 1
   (the udaiic hook's), 0 and 2 (run right after phase 4);
10. ``semi`` with the udaiic hooks (config/base + hooks/udaiic: IIC on Conv5
   and, at padding 1, on Up_conv2 through E1/E2, plus consistency) through
   ``build_semi_run(UDAIIC_CONFIG)`` at full width: the dense hook's loss on
   one batch through E1 against the plain version, then warm-up and timed
   steps; every hook loss finite, model and head parameters changed, E1 and
   E2 once per step, K1-K3, C1 and C2 as often per step as on ``semi``,
   D1/D2 never (run right after phase 6).

Every launch count is set to 0 just before a path is driven and read just
after. The line before the last is the kernels' JSON record: ``launches``
counted on the kernel's own main path (K1-K3, C1, C2: ``semi``; D1/D2:
``pretrain_decoder``; E1/E2: ``semi/udaiic``; ``launches_by_path`` has all
six), ``max_abs_err`` the largest over the checked shapes, ``ms`` /
``plain_ms`` / ``library_ms`` / ``bound_ms`` the sums over those shapes of
one launch each (C1/C2: over the batch-96 shapes only; ``by_batch`` has the
sums at every checked batch, beside the einsum form's below 96 and, for C2,
the split form's; E1/E2: at padding 1, with every padding in
``by_padding``); ``bound_ms`` is
max(bytes / 3.35 TB/s, operations / peak) with the bf16 tensor peak (989
TFLOP/s) for the conv kernels and the f32 peak (67 TFLOP/s) for SupCon and
IIC. The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

#: tolerance of a kernel against its plain version, in units of the largest
#: magnitude of the plain output: both accumulate in f32 in different orders
#: and round once to bf16, so they may differ by one bf16 ulp (<= 2^-7 of
#: the value) where a rounding flips; allow two
KERNEL_RTOL = 2.0 ** -6
#: per-sample BN sums of the rounded output: f32 sums over <= 50k pixels in
#: another order, plus the rare one-ulp flips above
STATS_RTOL = 1e-3
#: conv-block stages: the kernel path's distance to f32 may be at most this
#: factor times the plain bf16 path's (two independent bf16 roundings of the
#: same computation), plus STAGE_ATOL of the largest value
STAGE_FACTOR = 2.0
STAGE_ATOL = 1e-2
#: C1 / C2 weight gradients against their plain versions, in units of the
#: largest |dk|: both f32, sums of up to 4.8M exact bf16 products in other
#: orders (the kernel's ~10^5 serial in one accumulator per block)
DK_RTOL = 1e-3
WARMUP_STEPS = 3
TIMED_STEPS = 10
PRETRAIN_WARMUP, PRETRAIN_TIMED, ENCODER_STEPS = 2, 5, 3
PROSTATE_WARMUP, PROSTATE_TIMED, PROSTATE_ENCODER_STEPS = 1, 3, 3
#: SupCon kernels against their plain versions (both f32, sums in another order)
SUPCON_LOSS_RTOL = 1e-5
SUPCON_DZ_TOL = 1e-4
#: the card's peaks (H100 SXM data sheet): HBM bytes/s, bf16 tensor and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
#: E1's raw joints against the plain version, in units of the largest |raw|:
#: both are f32 sums over 250,880 pixel pairs per displacement in other
#: orders, of softmaxes whose exp may differ from torch's by an ulp
IIC_RAW_RTOL = 1e-4
#: the dense hook's loss through E1 against the plain version: the min-shift
#: normalization divides the joints' distances from their minimum, which
#: magnifies the raw joints' relative error
IIC_LOSS_RTOL = 1e-3
#: E1/E2 shapes: the Up_conv2 taps of semi's 5 unlabeled slices, 5 subheads
#: of 20 clusters (config/hooks/udaiic.yaml), the udaiic padding first
IIC_SHAPE, IIC_S, IIC_K, IIC_PADDINGS = (5, 224, 224, 32), 5, 20, (1, 0, 2)
UDAIIC_WARMUP, UDAIIC_TIMED = 3, 5


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _add_bound(rec: dict, ms: float, by: str) -> None:
    """Sum a shape's bound into a kernel's record; ``bound_by`` names the
    kind (bytes or operations) that contributes most to the sum."""
    parts = rec.setdefault("_bound_parts", {"bytes": 0.0, "operations": 0.0})
    parts[by] += ms
    rec["bound_ms"] = sum(parts.values())
    rec["bound_by"] = max(parts, key=parts.get)


def _rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


# (name, cin, cskip, cout, H, stats) of every K1 call on the main paths at 224x224
K1_SHAPES = [
    ("Conv1.conv0", 1, 0, 32, 224, True), ("Conv1.conv1", 32, 0, 32, 224, True),
    ("Conv2.conv0", 32, 0, 64, 112, True), ("Conv2.conv1", 64, 0, 64, 112, True),
    ("Up_conv3.conv0", 64, 64, 64, 112, True), ("Up_conv3.conv1", 64, 0, 64, 112, True),
    ("Up_conv2.conv0", 32, 32, 32, 224, True), ("Up_conv2.conv1", 32, 0, 32, 224, True),
    # dx passes: cotangent channels -> input channels, no statistics
    ("dx 32->32", 32, 0, 32, 224, False), ("dx 64->32", 64, 0, 32, 112, False),
    ("dx 64->64", 64, 0, 64, 112, False),
]
#: batches of the conv kernels: semi (5 labeled, 10 unlabeled + transformed),
#: pretraining (two views of 18 slices; prostate: of 48)
CONV_BATCHES = (5, 10, 36, 96)
#: (name, cin, cskip, cout, H) of every C2 conv of the prostate decoder path
#: at 224x224 (C1 takes Conv1.conv0, 1 -> 32 at 224^2, and the Up2 taps,
#: 64 -> 32 at 112^2 -> 224^2)
C2_SHAPES = [
    ("Conv1.conv1", 32, 0, 32, 224), ("Conv2.conv0", 32, 0, 64, 112),
    ("Conv2.conv1", 64, 0, 64, 112), ("Up_conv3.conv0", 64, 64, 64, 112),
    ("Up_conv3.conv1", 64, 0, 64, 112), ("Up_conv2.conv0", 32, 32, 32, 224),
    ("Up_conv2.conv1", 32, 0, 32, 224),
]
#: the batch of the prostate path (C1 / C2 records) and the batches where
#: C1 / C2 are set beside the einsum form (semi's 5 and 10, ACDC's 36)
BWD_BATCH, EINSUM_BATCHES = 96, (5, 10, 36)


def transpose_kernel(taps):
    """Parity taps [4, 4, Cin, Cout] of K2 -> the [Cin, Cout, 4, 4] kernel of
    the stride-2, padding-1 transposed convolution that computes the same
    function (K3's adjoint is the stride-2 convolution with it): output
    parity a, tap r sits at kernel row 3 - a - 2r (columns alike)."""
    import torch
    cin, cout = taps.shape[2:]
    w = torch.empty(cin, cout, 4, 4, dtype=taps.dtype, device=taps.device)
    for p in range(4):
        a, b = divmod(p, 2)
        for t in range(4):
            r, c = divmod(t, 2)
            w[:, :, 3 - a - 2 * r, 3 - b - 2 * c] = taps[p, t]
    return w


def library_calls(x, w, skip=None, w_skip=None, taps=None, g=None):
    """The one cuDNN call (bf16, channels-last) computing each kernel's
    function, as the yardstick of its time: K1 a 3x3 convolution (over the
    pre-built channel concat when there is a skip), K2 the stride-2 transposed
    convolution, K3 the stride-2 convolution. -> (fn, result as NHWC)."""
    import torch
    import torch.nn.functional as F

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    if taps is not None:
        k = transpose_kernel(taps).contiguous(memory_format=torch.channels_last)
        if g is None:
            fn = lambda: F.conv_transpose2d(nchw(x), k, stride=2, padding=1)  # noqa: E731
        else:
            fn = lambda: F.conv2d(nchw(g), k, stride=2, padding=1)  # noqa: E731
    else:
        if skip is not None:
            x, w = torch.cat([skip, x], -1), torch.cat([w_skip, w], 2)
        k = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        fn = lambda: F.conv2d(nchw(x), k, padding=1)  # noqa: E731
    return fn, fn().permute(0, 2, 3, 1)


def check_kernels(device) -> dict:
    """Phase 3: each conv kernel vs its plain version at the main-path
    shapes. Returns one record per kernel (errors maxed, times summed over
    the shapes) and prints one line per shape."""
    import torch
    from contrastyou_tpu_torch.ops import convblock as cb

    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bound_by="") for k in CONV_KERNELS}

    def record(kernel, label, got, ref, fns, work, stats=None, library=None):
        """``fns``: (kernel, plain, library) callables; ``work``: (bytes, flops)."""
        err, rel = _rel_err(got, ref)
        torch.cuda.synchronize()
        ms, pms, lms = (_time_ms(f) for f in fns)
        bms, by = _bound(*work, BF16_FLOPS)
        line = (f"  {kernel:16s} {label:26s} max_abs_err {err:.3e} (rel {rel:.2e}) "
                f"kernel {ms:.4f} ms plain {pms:.4f} ms cudnn {lms:.4f} ms bound {bms:.4f} ms")
        ok = rel <= KERNEL_RTOL and got.shape == ref.shape
        lib_rel = _rel_err(library, ref)[1]
        line += f" cudnn rel {lib_rel:.2e}"
        ok = ok and lib_rel <= KERNEL_RTOL
        if stats is not None:
            for s_got, s_ref in stats:
                srel = _rel_err(s_got, s_ref)[1]
                line += f" stats rel {srel:.2e}"
                ok = ok and srel <= STATS_RTOL
        print(line)
        if not ok:
            raise AssertionError(f"{kernel} {label}: kernel (or its cuDNN yardstick) "
                                 "disagrees with its plain version")
        r = recs[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        _add_bound(r, bms, by)

    for B in CONV_BATCHES:
        for name, cin, cs, cout, H, stats in K1_SHAPES:
            x = randn(B, H, H, cin)
            w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * (cin + cs)))
            skip = randn(B, H, H, cs) if cs else None
            ws = randn(3, 3, cs, cout, scale=1 / math.sqrt(9 * (cin + cs))) if cs else None
            got = cb.conv3x3_stats(x, w, skip, ws, stats=stats)
            ref = cb.conv3x3_stats_plain(x, w, skip, ws, stats=stats)
            lib_fn, lib = library_calls(x, w, skip, ws)
            px = B * H * H
            work = (2 * (px * (cin + cs + cout) + 9 * (cin + cs) * cout)
                    + (8 * B * cout if stats else 0), 2 * px * 9 * (cin + cs) * cout)
            record("conv3x3_stats", f"{name} B={B}", got[0], ref[0],
                   (lambda: cb.conv3x3_stats(x, w, skip, ws, stats=stats),
                    lambda: cb.conv3x3_stats_plain(x, w, skip, ws, stats=stats), lib_fn),
                   work, list(zip(got[1:], ref[1:])) if stats else None, lib)
        # Up2: 64 -> 32 channels, 112^2 -> 224^2
        x = randn(B, 112, 112, 64)
        taps = cb.parity_taps(randn(3, 3, 64, 32, scale=1 / math.sqrt(9 * 64)))
        px = B * 224 * 224
        work = (2 * (px // 4 * 64 + 16 * 64 * 32 + px * 32) + 8 * B * 32,
                2 * px * 4 * 64 * 32)
        got = cb.upconv3x3_stats(x, taps)
        ref = cb.upconv3x3_stats_plain(x, taps)
        lib_fn, lib = library_calls(x, None, taps=taps)
        record("upconv3x3_stats", f"Up2 B={B}", got[0], ref[0],
               (lambda: cb.upconv3x3_stats(x, taps), lambda: cb.upconv3x3_stats_plain(x, taps),
                lib_fn), work, list(zip(got[1:], ref[1:])), lib)
        gy = randn(B, 224, 224, 32)
        got = cb.upconv3x3_dx(gy, taps)
        ref = cb.upconv3x3_dx_plain(gy, taps)
        lib_fn, lib = library_calls(None, None, taps=taps, g=gy)
        record("upconv3x3_dx", f"Up2 dx B={B}", got, ref,
               (lambda: cb.upconv3x3_dx(gy, taps), lambda: cb.upconv3x3_dx_plain(gy, taps),
                lib_fn), (work[0] - 8 * B * 32, work[1]), library=lib)
    return recs


def library_bwd_calls(x, g, w=None, skip=None, w_skip=None, up2=False):
    """The one cuDNN call (``aten.convolution_backward``, bf16, channels-last)
    computing C1's or C2's function, as the yardstick of its time: C1 asks it
    for the weight gradient only (Up2: of the stride-2 transposed convolution
    whose 4x4 kernel holds the parity taps), C2 for the input and weight
    gradients of the conv (over the channel concat for a skip conv). -> (fn,
    result in the kernel's layout: C1 dk [T, Cin, Cout]; C2 (dx NHWC, dk
    HWIO), skip channels first)."""
    import torch

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    cout = g.shape[-1]
    cl = torch.channels_last
    if up2:
        cin = x.shape[-1]
        k = torch.zeros(cin, cout, 4, 4, dtype=x.dtype, device=x.device).contiguous(memory_format=cl)
        fn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            nchw(g), nchw(x), k, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [False, True, False])
        gk = fn()[1]
        return fn, torch.stack([gk[:, :, 3 - a - 2 * r, 3 - b - 2 * c]
                                for a in (0, 1) for b in (0, 1) for r in (0, 1) for c in (0, 1)])
    fused = w is not None
    if skip is not None:
        x, w = torch.cat([skip, x], -1), torch.cat([w_skip, w], 2)
    if not fused:
        w = torch.zeros(3, 3, x.shape[-1], cout, dtype=x.dtype, device=x.device)
    k = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    fn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        nchw(g), nchw(x), k, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [fused, True, False])
    gx, gk, _ = fn()
    dk = gk.permute(2, 3, 1, 0)
    return fn, (dk.reshape(9, *dk.shape[2:]) if gx is None else (gx.permute(0, 2, 3, 1), dk))


def check_bwd_kernels(device) -> dict:
    """Phase 5: C1 and C2 vs their plain versions at the shapes of the paths'
    backward, each launched twice (bitwise equal). Records: errors maxed
    over every batch, times of the batch-96 shapes summed (one step of the
    prostate decoder path); ``by_batch`` holds each batch's sums (kernel,
    cuDNN and bound; plain at 96, the einsum form below it; for C2 the split
    form on the port's own kernels). Prints one line per shape."""
    import torch
    from contrastyou_tpu_torch.ops import convblock as cb

    g = torch.Generator(device=device).manual_seed(4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bound_by="", by_batch={}) for k in BWD_KERNELS}

    def dk_rel(got, ref):
        err, rel = _rel_err(got, ref)
        if not rel <= DK_RTOL or got.shape != ref.shape:
            raise AssertionError(f"dk rel {rel:.2e} > {DK_RTOL}")
        return err, rel

    def twice(label, fn):
        first, second = fn(), fn()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{label}: two launches on the same inputs differ")
        return first

    def c1(B, label, x, gy, up2, einsum):
        (got,) = twice(f"C1 {label}", lambda: (cb.conv_dw_taps(x, gy, up2),))
        ref = cb.conv_dw_taps_plain(x, gy, up2)
        err, rel = dk_rel(got, ref)
        ms = _time_ms(lambda: cb.conv_dw_taps(x, gy, up2))
        px = x.numel() // x.shape[-1]
        T = 16 if up2 else 9
        work = (2 * (x.numel() + gy.numel()) + 4 * got.numel(), 2 * px * T * x.shape[-1] * gy.shape[-1])
        lib_fn, lib = library_bwd_calls(x, gy, up2=up2)
        lrel = _rel_err(lib, ref)[1]
        lms = _time_ms(lib_fn)
        if lrel > KERNEL_RTOL:
            raise AssertionError(f"C1 {label}: the cuDNN yardstick disagrees with plain")
        bms, by = _bound(*work, BF16_FLOPS)
        t = dict(ms=ms, library_ms=lms, bound_ms=bms, bound_by=by, err=err)
        if B == BWD_BATCH:
            t["plain_ms"] = _time_ms(lambda: cb.conv_dw_taps_plain(x, gy, up2), iters=5)
        else:
            t["einsum_ms"] = _time_ms(einsum)
        print(f"  conv_dw_taps     {label:26s} max_abs_err {err:.3e} (rel {rel:.2e}) kernel "
              f"{ms:.4f} ms cudnn {lms:.4f} ms bound {bms:.4f} ms ({by}) cudnn rel {lrel:.2e} "
              + (f"plain {t['plain_ms']:.4f}" if B == BWD_BATCH else f"einsum {t['einsum_ms']:.4f}")
              + " ms")
        return t

    def c2(B, label, x, w, gy, skip, ws, einsum):
        ms = split = plain = err = rel = xrel = 0.0
        fused = [(x, w)] + ([(skip, ws)] if skip is not None else [])
        refs = []
        for xi, wi in fused:
            dx, dk = twice(f"C2 {label}", lambda: cb.conv3x3_bwd_fused(xi, wi, gy))
            pdx, pdk = cb.conv3x3_bwd_fused_plain(xi, wi, gy)
            e, r = dk_rel(dk, pdk)
            ex, xr = _rel_err(dx, pdx)
            if xr > KERNEL_RTOL:
                raise AssertionError(f"C2 {label}: dx rel {xr:.2e} > {KERNEL_RTOL}")
            err, rel, xrel = max(err, e, ex), max(rel, r), max(xrel, xr)
            refs.append((pdx, pdk))
            ms += _time_ms(lambda: cb.conv3x3_bwd_fused(xi, wi, gy))
            wt = cb.flip_transpose(wi)
            split += _time_ms(lambda: (cb.conv3x3_stats(gy, wt, stats=False), cb.conv_dw_taps(xi, gy)))
            if B == BWD_BATCH:
                plain += _time_ms(lambda: cb.conv3x3_bwd_fused_plain(xi, wi, gy), iters=5)
        lib_fn, (ldx, ldk) = library_bwd_calls(x, gy, w, skip, ws)
        pdx = torch.cat([r[0] for r in refs[::-1]], -1)
        pdk = torch.cat([r[1] for r in refs[::-1]], 2)
        lrel = max(_rel_err(ldx, pdx)[1], _rel_err(ldk, pdk)[1])
        lms = _time_ms(lib_fn)
        if lrel > KERNEL_RTOL:
            raise AssertionError(f"C2 {label}: the cuDNN yardstick disagrees with plain")
        cin = sum(xi.shape[-1] for xi, _ in fused)
        px = x.numel() // x.shape[-1]
        work = (2 * (2 * px * cin + px * gy.shape[-1] + 9 * cin * gy.shape[-1])
                + 4 * 9 * cin * gy.shape[-1], 2 * 2 * px * 9 * cin * gy.shape[-1])
        bms, by = _bound(*work, BF16_FLOPS)
        t = dict(ms=ms, library_ms=lms, bound_ms=bms, bound_by=by, err=err, split_ms=split)
        if B == BWD_BATCH:
            t["plain_ms"] = plain
        else:
            t["einsum_ms"] = _time_ms(einsum)
        print(f"  conv3x3_bwd_fused {label:25s} max_abs_err {err:.3e} (dk rel {rel:.2e}, dx "
              f"rel {xrel:.2e}) kernel {ms:.4f} ms cudnn {lms:.4f} ms split (K1 dx + C1) "
              f"{split:.4f} ms bound {bms:.4f} ms ({by}) cudnn rel {lrel:.2e} "
              + (f"plain {plain:.4f} ms" if B == BWD_BATCH else
                 f"einsum+K1 dx {t['einsum_ms']:.4f} ms"))
        return t

    for B in (BWD_BATCH, *EINSUM_BATCHES):
        results = []
        x = randn(B, 224, 224, 1)
        gy = randn(B, 224, 224, 32, scale=1e-2)
        results.append(("conv_dw_taps", c1(B, f"Conv1.conv0 B={B}", x, gy, False,
                                           lambda: cb.conv3x3_dw(x, gy))))
        xu = randn(B, 112, 112, 64)
        results.append(("conv_dw_taps", c1(B, f"Up2 taps B={B}", xu, gy, True,
                                           lambda: cb.upconv3x3_dtaps(xu, gy))))
        for name, cin, cs, cout, H in C2_SHAPES:
            x, gy = randn(B, H, H, cin), randn(B, H, H, cout, scale=1e-2)
            w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * (cin + cs)))
            skip = randn(B, H, H, cs) if cs else None
            ws = randn(3, 3, cs, cout, scale=1 / math.sqrt(9 * (cin + cs))) if cs else None

            def einsum(x=x, w=w, gy=gy, skip=skip, ws=ws):
                for xi, wi in [(x, w)] + ([(skip, ws)] if skip is not None else []):
                    cb.conv3x3_stats(gy, cb.flip_transpose(wi), stats=False)
                    cb.conv3x3_dw(xi, gy)

            results.append(("conv3x3_bwd_fused", c2(B, f"{name} B={B}", x, w, gy, skip, ws,
                                                    einsum)))
            del x, gy, skip
        sums = {k: {} for k in recs}
        for k, t in results:
            r = recs[k]
            r["max_abs_err"] = max(r["max_abs_err"], t["err"])
            for key in ("ms", "library_ms", "bound_ms", "plain_ms", "einsum_ms", "split_ms"):
                if key in t:
                    sums[k][key] = sums[k].get(key, 0.0) + t[key]
            if B == BWD_BATCH:
                r["ms"] += t["ms"]
                r["plain_ms"] += t["plain_ms"]
                r["library_ms"] += t["library_ms"]
                _add_bound(r, t["bound_ms"], t["bound_by"])
        for k, agg in sums.items():
            recs[k]["by_batch"][f"B={B}"] = agg
            print(f"  {k} B={B} over the path's shapes: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in agg.items()))
        torch.cuda.empty_cache()
    return recs


def check_supcon(device) -> dict:
    """Phase 4: D1 and D2 vs their plain versions (f32, TF32 off) at the
    pretrain anchor counts (36: the encoder hook's 2 x 18; 180: the decoder
    hook's 2 x 18 x 5 points) and the gate's largest (256), d = 256, with
    partition labels and identity (self) masks."""
    import torch
    from contrastyou_tpu_torch.losses.contrastive import (_expand_masks,
                                                          pair_masks_from_target)
    from contrastyou_tpu_torch.ops import supcon

    g = torch.Generator(device=device).manual_seed(2)
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                    bound_by="") for k in supcon.LAUNCHES}
    tau, d = 0.07, 256
    for M in (36, 180, 256):
        for masks in ("partition", "self"):
            n = M // 2
            z = torch.nn.functional.normalize(
                torch.randn(M, d, generator=g, device=device), dim=1)
            target = torch.arange(n, device=device) % 3 if masks == "partition" else None
            code = supcon.pair_code(*_expand_masks(
                *pair_masks_from_target(target, n, device=device), n))
            got = supcon.supcon_loss(z, code, tau)
            ref = supcon.supcon_loss_plain(z, code, tau)
            loss_rel = abs(float(got[0].mean() - ref[0].mean())) / abs(float(ref[0].mean()))
            vec_err, vec_rel = _rel_err(got[0], ref[0])
            gs = torch.ones(1, device=device)
            dz = supcon.supcon_dz(z, code, got[1], got[2], gs, tau)
            dz_ref = supcon.supcon_dz_plain(z, code, ref[1], ref[2], gs, tau)
            dz_err, dz_rel = _rel_err(dz, dz_ref)
            torch.cuda.synchronize()
            times = {
                "supcon_loss": (_time_ms(lambda: supcon.supcon_loss(z, code, tau)),
                                _time_ms(lambda: supcon.supcon_loss_plain(z, code, tau)),
                                _bound(M * d * 4 + M * M + 12 * M, 2 * M * M * d, F32_FLOPS),
                                vec_err),
                "supcon_dz": (_time_ms(lambda: supcon.supcon_dz(z, code, got[1], got[2], gs, tau)),
                              _time_ms(lambda: supcon.supcon_dz_plain(z, code, ref[1], ref[2],
                                                                      gs, tau)),
                              _bound(8 * M * d + M * M + 8 * M + 4, 4 * M * M * d, F32_FLOPS),
                              dz_err)}
            print(f"  supcon M={M:3d} {masks:9s} loss rel {loss_rel:.2e} (per anchor "
                  f"{vec_rel:.2e}) dz max_abs_err {dz_err:.3e} (rel {dz_rel:.2e}); " + "; ".join(
                      f"{k} kernel {t[0]:.4f} ms plain {t[1]:.4f} ms bound {t[2][0]:.6f} ms"
                      for k, t in times.items()))
            if loss_rel > SUPCON_LOSS_RTOL or vec_rel > SUPCON_LOSS_RTOL or dz_rel > SUPCON_DZ_TOL:
                raise AssertionError(f"SupCon M={M} {masks}: kernel disagrees with plain")
            for k, (ms, pms, (bms, by), err) in times.items():
                r = recs[k]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += ms
                r["plain_ms"] += pms
                _add_bound(r, bms, by)
    return recs


def iic_work(f: "torch.Tensor", S: int, K: int, padding: int) -> dict:
    """(bytes, flops) of E1 and E2 on features ``f`` [B, H, W, C] (each input
    read once, each output written once; only the S diagonal K x K blocks of
    each displacement's joint): E1 projects both maps (2 * 2N * C * S * K)
    and forms the joints (2 * Td^2 * N * S * K^2); E2 recomputes the
    projections, forms dp for both views (twice the joints' work), then df
    and dW (2 * 2N * C * S * K each)."""
    B, H, W, C = f.shape
    N, SK, td2 = B * H * W, S * K, (2 * padding + 1) ** 2
    fbytes = 2 * f.numel() * f.element_size()
    params, joints = 4 * (C * SK + SK), 4 * S * td2 * K * K
    proj, pair = 2 * 2 * N * C * SK, 2 * td2 * N * S * K * K
    return {"iic_joints": (fbytes + params + joints, proj + pair),
            "iic_joints_bwd": (2 * fbytes + 2 * params + joints, 3 * proj + 2 * pair)}


def check_iic(device) -> dict:
    """Phase 9: E1 and E2 vs their plain versions (f32 math, TF32 off) on
    post-ReLU bf16 feature maps of the Up_conv2 taps' shape, at each padding
    of IIC_PADDINGS. Records: errors maxed over the paddings, times and bound
    of padding 1 (the udaiic hook's), every padding in ``by_padding``."""
    import torch
    from contrastyou_tpu_torch.ops import iic

    g = torch.Generator(device=device).manual_seed(5)
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                    bound_by="", by_padding={}) for k in iic.LAUNCHES}
    C, S, K = IIC_SHAPE[-1], IIC_S, IIC_K
    f1, f2 = (torch.relu(torch.randn(IIC_SHAPE, generator=g, device=device)).to(torch.bfloat16)
              for _ in range(2))
    w = torch.randn(C, S * K, generator=g, device=device) / math.sqrt(C)
    b = torch.randn(S * K, generator=g, device=device) * 0.1
    for pad in IIC_PADDINGS:
        kw = dict(num_subheads=S, num_clusters=K, padding=pad)
        raw, raw_ref = iic.iic_joints(f1, f2, w, b, **kw), iic.iic_joints_plain(f1, f2, w, b, **kw)
        err1, rel1 = _rel_err(raw, raw_ref)
        jbar = torch.randn(raw.shape, generator=g, device=device)
        got = iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)
        ref = iic.iic_joints_bwd_plain(f1, f2, w, b, jbar, **kw)
        rels = [_rel_err(a, r) for a, r in zip(got, ref)]
        err2 = max(e for e, _ in rels)
        torch.cuda.synchronize()
        times = {"iic_joints": (_time_ms(lambda: iic.iic_joints(f1, f2, w, b, **kw)),
                                _time_ms(lambda: iic.iic_joints_plain(f1, f2, w, b, **kw),
                                         iters=5), err1),
                 "iic_joints_bwd": (_time_ms(lambda: iic.iic_joints_bwd(f1, f2, w, b, jbar, **kw)),
                                    _time_ms(lambda: iic.iic_joints_bwd_plain(f1, f2, w, b, jbar,
                                                                              **kw), iters=5),
                                    err2)}
        work = iic_work(f1, S, K, pad)
        line = (f"  iic padding {pad}: E1 raw max_abs_err {err1:.3e} (rel {rel1:.2e}); E2 "
                + ", ".join(f"{n} rel {r:.2e}" for n, (_, r) in zip(("df1", "df2", "dW", "db"),
                                                                  rels)))
        for k, (ms, pms, err) in times.items():
            bms, by = _bound(*work[k], F32_FLOPS)
            line += f"; {k} kernel {ms:.4f} ms plain {pms:.4f} ms bound {bms:.4f} ms ({by})"
            r = recs[k]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["by_padding"][str(pad)] = {"ms": ms, "plain_ms": pms, "bound_ms": bms}
            if pad == IIC_PADDINGS[0]:
                r.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        print(line)
        if (rel1 > IIC_RAW_RTOL or any(r > KERNEL_RTOL for _, r in rels[:2])
                or any(r > DK_RTOL for _, r in rels[2:])
                or any(a.dtype != r.dtype or a.shape != r.shape for a, r in zip(got, ref))):
            raise AssertionError(f"IIC padding {pad}: a kernel disagrees with its plain version")
        del raw_ref, ref
        torch.cuda.empty_cache()
    return recs


@contextlib.contextmanager
def plain_iic():
    """Route the IIC wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import iic
    saved = iic.iic_joints, iic.iic_joints_bwd
    iic.iic_joints, iic.iic_joints_bwd = iic.iic_joints_plain, iic.iic_joints_bwd_plain
    try:
        yield
    finally:
        iic.iic_joints, iic.iic_joints_bwd = saved


def check_iic_hook(run) -> None:
    """Phase 10a: the dense IIC hook's loss on one unlabeled batch and its
    transformed copy (one forward, no statistics update) through E1 against
    the same loss through the plain version."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.engine.steps import sample_step_draws
    from contrastyou_tpu_torch.models.projectors import DenseClusterHead
    from contrastyou_tpu_torch.ops.affine import transform_image

    gen = torch.Generator(device=run.unlabeled_cache.device).manual_seed(3)
    n = run.batch_slices // 2
    x = run.unlabeled_cache.sample(gen, n)["image"]
    draws = sample_step_draws(gen, n)
    hooks = [h for h in run.hooks if isinstance(getattr(h, "projector", None), DenseClusterHead)]
    taps = tuple(h.taps[0] for h in hooks)
    with torch.no_grad():
        _, feats = run.state.model(torch.cat([x, transform_image(x, draws.geo, draws.gammas)]),
                                   taps=taps, update_stats=False)
        ctx = StepContext(unlabeled_taps={k: v[:n] for k, v in feats.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in feats.items()},
                          geo_params=draws.geo,
                          bundle=ModelBundle(run.state.model, tuple(x.shape[1:])))
        for h in hooks:
            got = float(h.loss(ctx, {})[0])
            with plain_iic():
                ref = float(h.loss(ctx, {})[0])
            rel = abs(got - ref) / abs(ref)
            print(f"  {h.name}: loss through E1 {got:.7f}, plain {ref:.7f} (rel {rel:.2e})")
            if not math.isfinite(got) or rel > IIC_LOSS_RTOL:
                raise AssertionError(f"{h.name}: E1 loss {got} vs plain {ref}")


def run_udaiic(device, card: str, semi: dict) -> dict:
    """Phase 10b: warm-up + timed full-width semi steps with the udaiic
    hooks; ``semi``: the launches of phase 6b's semi run."""
    import torch
    from contrastyou_tpu_torch.main import UDAIIC_CONFIG, build_semi_run

    run = build_semi_run(UDAIIC_CONFIG, device=device)
    print(f"semi/udaiic: hooks {[(h.name, h.weight) for h in run.hooks]}")
    check_iic_hook(run)
    tensors = dict(run.state.model.named_parameters())
    tensors.update({f"{h.name}/{k}": p for h in run.hooks if isinstance(h, torch.nn.Module)
                    for k, p in h.named_parameters()})
    before = {k: v.detach().clone() for k, v in tensors.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(UDAIIC_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(UDAIIC_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    keys = [f"{h.name}/loss" for h in run.hooks] + ["sup_loss", "total_loss"]
    losses = [{k: round(float(m[k]), 6) for k in keys} for m in metrics]
    moved = [k for k in tensors if not torch.equal(before[k], tensors[k].detach())]
    ms = dt / UDAIIC_TIMED * 1e3
    print(f"semi/udaiic: {UDAIIC_WARMUP}+{UDAIIC_TIMED} steps, losses {losses}")
    print(f"semi/udaiic: {len(moved)}/{len(tensors)} parameter tensors changed; "
          f"launches {launches}")
    print(f"semi/udaiic: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite loss: {losses}")
    for part in ["_"] + [f"{h.name}/" for h in run.hooks if isinstance(h, torch.nn.Module)]:
        if not any(k.startswith(part) for k in moved):
            raise AssertionError(f"no parameter of {part!r} changed")
    steps, semi_steps = UDAIIC_WARMUP + UDAIIC_TIMED, WARMUP_STEPS + TIMED_STEPS
    if (launches["iic_joints"] != steps or launches["iic_joints_bwd"] != steps
            or any(launches[k] * semi_steps != semi[k] * steps for k in CONV_KERNELS + BWD_KERNELS)
            or any(launches[k] for k in SUPCON_KERNELS)):
        raise AssertionError(f"launches {launches}: want E1/E2 {steps} each, K1-K3, C1 and C2 "
                             f"per step as on semi ({semi}), D1/D2 none")
    return launches


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import convblock as cb
    names = (*CONV_KERNELS, *BWD_KERNELS)
    saved = [getattr(cb, k) for k in names]
    for k in names:
        setattr(cb, k, getattr(cb, k + "_plain"))
    try:
        yield
    finally:
        for k, f in zip(names, saved):
            setattr(cb, k, f)


def check_stages(device, B: int) -> None:
    """Phase 6a: the kernel-path U-Net levels (Conv1; Up2 -> Up_conv2 with
    the Conv1 skip) at full width, batch ``B``, forward and backward, are as
    close to an f32 evaluation of the same modules as the plain bf16 path is
    (the backward runs C1 twice and C2 four times at every batch).
    bf16 itself moves these gradients by 10-25% from f32 (measured on the CPU:
    the BN backward cancels large terms), so a direct kernel-vs-plain bound
    would be noise; the kernel path must instead stay within
    ``STAGE_FACTOR`` times the plain path's own distance to f32."""
    import torch
    from contrastyou_tpu_torch.models.unet import UNet

    gen = torch.Generator(device=device).manual_seed(1)
    net = UNet(max_channel=512, momentum=0.01).to(device).init_weights(gen)
    net32 = UNet(max_channel=512, momentum=0.01, dtype=torch.float32).to(device)
    net32.load_state_dict(net.state_dict())
    x = torch.rand(B, 224, 224, 1, generator=gen, device=device)
    d3 = torch.randn(B, 112, 112, 64, generator=gen, device=device).to(torch.bfloat16)
    proj = torch.randn(B, 224, 224, 32, generator=gen, device=device)

    def run(model):
        model.zero_grad(set_to_none=True)
        d = d3.to(model.dtype).clone().requires_grad_()
        e1 = model._Conv1(x)
        out = model._Up_conv2(model._Up2(d), skip=e1)
        (out.float() * proj).mean().backward()
        res = {"out": out.detach(), "d Up2 input": d.grad}
        res.update({k: p.grad.clone() for k, p in model.named_parameters()
                    if p.grad is not None})
        return res

    _reset_counts()
    got = run(net)
    launches = _counts()
    with plain_kernels():
        plain, ref = run(net), run(net32)
    worst = 0.0
    for k in ref:
        ek, ep = _rel_err(got[k], ref[k])[1], _rel_err(plain[k], ref[k])[1]
        worst = max(worst, ek / (ep + STAGE_ATOL))
        if ek > STAGE_FACTOR * ep + STAGE_ATOL or not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"{k}: kernel path {ek:.3e} from f32, plain bf16 path {ep:.3e}")
    bwd = [launches[k] for k in BWD_KERNELS]
    if bwd != [2, 4]:
        raise AssertionError(f"stage check B={B}: C1/C2 launches {bwd}")
    print(f"stage check B={B} (Conv1, Up2, Up_conv2 fwd+bwd, {len(ref)} tensors; C1/C2 "
          f"launches {bwd}): kernel-path error vs f32 at most {worst:.2f}x the plain bf16 "
          f"path's (+{STAGE_ATOL})")


def _reset_counts() -> None:
    from contrastyou_tpu_torch.ops import convblock as cb, iic, supcon
    cb.reset_launch_counts()
    supcon.reset_launch_counts()
    iic.reset_launch_counts()


def _counts() -> dict:
    from contrastyou_tpu_torch.ops import convblock as cb, iic, supcon
    return {**cb.LAUNCHES, **supcon.LAUNCHES, **iic.LAUNCHES}


def run_train(device, card: str) -> dict:
    """Phase 6b: warm-up + timed full-width semi + consistency steps."""
    import torch
    from contrastyou_tpu_torch.main import MAIN_PATH_CONFIG, build_semi_run

    run = build_semi_run(MAIN_PATH_CONFIG, device=device)
    before = {k: v.detach().clone() for k, v in run.state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    losses = [float(m["total_loss"]) for m in metrics]
    changed = sum(int(not torch.equal(before[k], v.detach()))
                  for k, v in run.state.model.named_parameters())
    ms = dt / TIMED_STEPS * 1e3
    print(f"train: {WARMUP_STEPS}+{TIMED_STEPS} steps, losses {losses}")
    print(f"train: {changed}/{len(before)} parameter tensors changed; launches {launches}")
    print(f"train: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if changed == 0:
        raise AssertionError("no parameter changed")
    steps = WARMUP_STEPS + TIMED_STEPS
    expect = {k: steps * n for k, n in SEMI_LAUNCHES.items()}
    if (any(launches[k] != v for k, v in expect.items())
            or min(launches[k] for k in CONV_KERNELS) <= 0):
        raise AssertionError(f"launches {launches}: want {expect} and K2, K3 > 0")
    if any(launches[k] for k in IIC_KERNELS):
        raise AssertionError(f"E1/E2 launched without an IIC hook: {launches}")
    return launches


@contextlib.contextmanager
def plain_supcon():
    """Route the SupCon wrappers to their plain versions (on the card too)."""
    from contrastyou_tpu_torch.ops import supcon
    saved = supcon.supcon_loss, supcon.supcon_dz
    supcon.supcon_loss, supcon.supcon_dz = supcon.supcon_loss_plain, supcon.supcon_dz_plain
    try:
        yield
    finally:
        supcon.supcon_loss, supcon.supcon_dz = saved


def check_hook_losses(run) -> None:
    """Phase 7a / 8: the hook losses of one contrastive batch through D1 against
    the same losses through the plain SupCon, on the same forward."""
    import torch
    from contrastyou_tpu_torch.engine.bundle import ModelBundle
    from contrastyou_tpu_torch.engine.hooks import StepContext
    from contrastyou_tpu_torch.trainers.pretrain import sample_pretrain_draws

    gen = torch.Generator(device=run.cache.device).manual_seed(3)
    n = run.batch_slices
    idx = torch.arange(n, device=run.cache.device) % len(run.cache)
    batch = run.cache.sample_at(idx, *run.cache.draw_offsets(gen, n))
    grids = sorted({h.grid for h in run.hooks if h.grid is not None})
    draws = sample_pretrain_draws(gen, n, point_grids=grids)
    taps = tuple(h.taps[0] for h in run.hooks)
    with torch.no_grad():
        x = torch.cat([batch["image"], batch["image"]], 0)
        _, feats = run.state.model(x, until=run.until, taps=taps, update_stats=False)
        ctx = StepContext(unlabeled_taps={k: v[:n] for k, v in feats.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in feats.items()},
                          partition_group=batch["partition"], geo_params=draws.geo,
                          point_draws=draws.points,
                          bundle=ModelBundle(run.state.model, tuple(x.shape[1:])))
        for h in run.hooks:
            got = float(h.loss(ctx, {})[0])
            with plain_supcon():
                ref = float(h.loss(ctx, {})[0])
            rel = abs(got - ref) / abs(ref)
            print(f"  {h.name}: loss through D1 {got:.6f}, plain {ref:.6f} (rel {rel:.2e})")
            if not math.isfinite(got) or rel > SUPCON_LOSS_RTOL * 10:
                raise AssertionError(f"{h.name}: D1 loss {got} vs plain {ref}")


#: launches per step of (D1 and D2 each, C1, C2) on each pretraining path:
#: one D1/D2 pair per hook of at most 256 anchors (the prostate dense hook's
#: 2 x 48 x 5 = 480 take the eager form); C1 for Conv1.conv0 (and Up2's
#: taps), C2 for every other narrow conv input the backward reaches
PRETRAIN_LAUNCHES = {
    ("pretrain_decoder", "acdc"): (2, 2, 9), ("pretrain", "acdc"): (1, 1, 3),
    ("pretrain_decoder", "prostate"): (1, 2, 9), ("pretrain", "prostate"): (1, 1, 3),
}


def run_pretrain(device, card: str, trainer: str, warmup: int, timed: int,
                 data: str = "acdc") -> dict:
    """Phases 7b / 8: full-width pretraining steps through ``build_pretrain_run``."""
    import torch
    from contrastyou_tpu_torch.main import parse_config, build_pretrain_run
    from contrastyou_tpu_torch.models.unet import UNet

    run = build_pretrain_run(parse_config(["-o", f"Trainer.name={trainer}", f"Data.name={data}"]),
                             device=device)
    model = run.state.model
    frozen_layers = UNet.arch_elements[UNet.arch_elements.index(run.until) + 1:]
    trainer = trainer if data == "acdc" else f"{trainer}/{data}"
    print(f"{trainer}: hooks {[h.name for h in run.hooks]}, forward cut at {run.until}, "
          f"frozen {list(frozen_layers)}, batch {run.batch_slices} slices x 2 views, "
          f"{model._Deconv_1x1.out_channels} classes")
    check_hook_losses(run)
    tensors = dict(model.named_parameters())
    tensors.update({f"{h.name}/{k}": p for h in run.hooks for k, p in h.named_parameters()})
    before = {k: v.detach().clone() for k, v in tensors.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run.run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics += run.run(timed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    losses = [{k: round(float(v), 5) for k, v in m.items()} for m in metrics]
    frozen = [k for k in tensors if k.split(".")[0].lstrip("_") in frozen_layers]
    moved = [k for k in tensors if not torch.equal(before[k], tensors[k].detach())]
    ms = dt / timed * 1e3
    print(f"{trainer}: {warmup}+{timed} steps, losses {losses}")
    print(f"{trainer}: {len(moved)}/{len(tensors)} parameter tensors changed "
          f"({len(frozen)} frozen); launches {launches}")
    print(f"{trainer}: {ms:.3f} ms/step, {run.batch_slices * 1e3 / ms:.2f} slices/s "
          f"on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite loss: {losses}")
    if set(moved) & set(frozen) or "_Deconv_1x1.weight" not in frozen:
        raise AssertionError(f"frozen tensors changed: {sorted(set(moved) & set(frozen))}")
    for part in ["_"] + [h.name for h in run.hooks]:
        if not any(k.startswith(part) for k in moved):
            raise AssertionError(f"no parameter of {part!r} changed")
    steps = warmup + timed
    d, c1, c2 = PRETRAIN_LAUNCHES[trainer.split("/")[0], data]
    expect = {"supcon_loss": steps * d, "supcon_dz": steps * d, "conv_dw_taps": steps * c1,
              "conv3x3_bwd_fused": steps * c2, "iic_joints": 0, "iic_joints_bwd": 0}
    if any(launches[k] != v for k, v in expect.items()) or launches["conv3x3_stats"] <= 0:
        raise AssertionError(f"launches {launches}, expected {expect} and K1 > 0")
    if trainer.startswith("pretrain_decoder") and min(launches[k] for k in CONV_KERNELS) <= 0:
        raise AssertionError(f"a conv kernel of the decoder path never launched: {launches}")
    return launches


CONV_KERNELS = ("conv3x3_stats", "upconv3x3_stats", "upconv3x3_dx")
#: launches per semi step (a batch-5 and a batch-10 forward, each with its
#: backward): K1 the 8 forward convs of each pass (the backward's dx is C2's);
#: C1 Conv1.conv0 and Up2's taps, C2 the 9 other narrow conv inputs, per pass
SEMI_LAUNCHES = {"conv3x3_stats": 16, "conv_dw_taps": 4, "conv3x3_bwd_fused": 18}
BWD_KERNELS = ("conv_dw_taps", "conv3x3_bwd_fused")
SUPCON_KERNELS = ("supcon_loss", "supcon_dz")
IIC_KERNELS = ("iic_joints", "iic_joints_bwd")
SOURCES = {
    "conv3x3_stats": "contrastyou_tpu/ops/pallas/convblock.py:230",
    "upconv3x3_stats": "contrastyou_tpu/ops/pallas/convblock.py:341",
    "upconv3x3_dx": "contrastyou_tpu/ops/pallas/convblock.py:341",
    "supcon_loss": "contrastyou_tpu/ops/pallas/infonce.py:36",
    "supcon_dz": "contrastyou_tpu/ops/pallas/infonce.py:100",
    "conv_dw_taps": "contrastyou_tpu/ops/pallas/convblock.py:628",
    "conv3x3_bwd_fused": "contrastyou_tpu/ops/pallas/convblock.py:768",
    "iic_joints": "contrastyou_tpu/ops/pallas/iic.py:153",
    "iic_joints_bwd": "contrastyou_tpu/ops/pallas/iic.py:183",
}
#: each kernel's source and main path (its ``launches``)
ROUTES = {**{k: ("tapconv.cu", "semi") for k in CONV_KERNELS},
          "supcon_loss": ("supcon.cu", "pretrain_decoder"),
          "supcon_dz": ("supcon.cu", "pretrain_decoder"),
          **{k: ("convbwd.cu", "semi") for k in BWD_KERNELS},
          **{k: ("iic.cu", "semi/udaiic") for k in IIC_KERNELS}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from contrastyou_tpu_torch.ops import _build     # fails outside a checkout
    card = _card()
    print(card)
    torch.backends.cudnn.allow_tf32 = False        # plain versions: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    print(f"built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s")

    print("kernel vs plain (times per launch, CUDA events):")
    recs = check_kernels(device)
    recs.update(check_supcon(device))
    print("dense-IIC kernels vs plain (f1, f2 [5, 224, 224, 32] bf16, S = 5, K = 20):")
    recs.update(check_iic(device))
    print("backward kernels vs plain (batch 96) and vs the einsum form (batches 5, 10, 36):")
    recs.update(check_bwd_kernels(device))
    for B in (5, BWD_BATCH):
        check_stages(device, B)
    by_path = {"semi": run_train(device, card)}
    by_path["semi/udaiic"] = run_udaiic(device, card, by_path["semi"])
    torch.cuda.empty_cache()
    for trainer, data, warmup, timed in (
            ("pretrain_decoder", "acdc", PRETRAIN_WARMUP, PRETRAIN_TIMED),
            ("pretrain", "acdc", 1, ENCODER_STEPS - 1),
            ("pretrain_decoder", "prostate", PROSTATE_WARMUP, PROSTATE_TIMED),
            ("pretrain", "prostate", 1, PROSTATE_ENCODER_STEPS - 1)):
        path = trainer if data == "acdc" else f"{trainer}/{data}"
        by_path[path] = run_pretrain(device, card, trainer, warmup, timed, data)
        torch.cuda.empty_cache()

    out = []
    for k, r in recs.items():
        src, main_path = ROUTES[k]
        out.append(dict(name=k, route="cuda", source=f"contrastyou_tpu_torch/ops/csrc/{src}",
                        replaces=SOURCES[k], launches=by_path[main_path][k],
                        launches_by_path={p: c[k] for p, c in by_path.items()},
                        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["library_ms"],
                        **{k: r[k] for k in ("by_batch", "by_padding") if k in r}))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
