"""Operations and bytes of the U-Net step, from shapes alone.

:func:`unet_convs` lists every conv of one image's forward; the model FLOPs
of an update (:func:`model_flops`) count the forward, the weight gradient
and the input gradient (where the input needs one) of each conv and matrix
product once, whatever kernel runs it. :func:`kernel_sites` routes the
convs to the port's hand-written conv kernels by the port's rule (levels of
at most 64 channels) and gives each launch its least time on the H100:
``max(bytes / HBM, FLOPs / bf16 peak)``, each input byte read once and each
output byte written once. The launch counts it implies are held against the
port's counters before a roofline share is reported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .reference import DECODER, ENCODER, channel_dim

#: NVIDIA H100 SXM, dense bf16 tensor-core FLOP/s and HBM3 bytes/s (data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: widest level the port routes through its conv kernels
KERNEL_MAX_CHANNELS = 64
#: input channels from which a kernel-routed conv's backward is fused (C2)
FUSED_BWD_MIN_CIN = 8
BF16, F32 = 2, 4
#: the port's launch counter of each kernel -> its family
KERNELS = {"conv3x3_stats": "K1", "upconv3x3_stats": "K2", "upconv3x3_dx": "K3",
           "conv_dw_taps": "C1", "conv3x3_bwd_fused": "C2"}
FORWARD, BACKWARD = ("K1", "K2"), ("K3", "C1", "C2")


@dataclass(frozen=True)
class Conv:
    """One conv of an image's forward: ``x`` of ``cin`` channels (plus a
    skip of ``cskip`` concatenated before it), ``cout`` out, at output
    resolution ``h`` x ``w``; ``up``: a 3x3 conv of the 2x nearest
    upsampled input; ``taps`` 9 or 1 (the 1x1 head)."""
    layer: str
    cin: int
    cskip: int
    cout: int
    h: int
    w: int
    taps: int = 9
    up: bool = False
    input_grad: bool = True
    width: int = 0        # the conv block's or upconv's width that routes it

    def macs(self) -> int:
        return self.h * self.w * self.taps * (self.cin + self.cskip) * self.cout


def unet_convs(max_channel: int, num_classes: int, crop: int, *, input_dim: int = 1,
               until: Optional[str] = None) -> List[Conv]:
    """Every conv of one image's U-Net forward, in order, up to ``until``."""
    cd = lambda n: channel_dim(n, max_channel)  # noqa: E731
    out: List[Conv] = []
    cin, res = input_dim, crop
    for i, name in enumerate(ENCODER):
        res = crop >> i
        f = cd(name)
        out += [Conv(f"{name}.conv0", cin, 0, f, res, res, input_grad=i > 0, width=f),
                Conv(f"{name}.conv1", f, 0, f, res, res, width=f)]
        cin = f
        if name == until:
            return out
    for up, conv, skip in DECODER:
        res *= 2
        f = cd(conv)
        out += [Conv(up, cin, 0, f, res, res, up=True, width=cin),
                Conv(f"{conv}.conv0", f, cd(skip), f, res, res, width=f),
                Conv(f"{conv}.conv1", f, 0, f, res, res, width=f)]
        cin = f
        if conv == until:
            return out
    return out + [Conv("Deconv_1x1", cin, 0, num_classes, crop, crop, taps=1)]


def conv_flops(convs: Sequence[Conv], batch: int) -> float:
    """Forward + weight gradient + input gradient (where needed) FLOPs."""
    return sum(2.0 * batch * c.macs() * (3 if c.input_grad else 2) for c in convs)


def matmul_flops(m: int, k: int, n: int, *, input_grad: bool = True) -> float:
    """An [m, k] x [k, n] product, its weight and (where needed) input gradient."""
    return 2.0 * m * k * n * (3 if input_grad else 2)


@dataclass(frozen=True)
class Site:
    """One launch of a hand-written conv kernel in an update."""
    kernel: str           # K1, K2, K3, C1 or C2
    layer: str
    batch: int
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.bytes / PEAK_HBM_BYTES, self.flops / PEAK_BF16_FLOPS)


def kernel_sites(convs: Sequence[Conv], batch: int) -> List[Site]:
    """The kernel launches of one forward and backward over ``batch``
    images: K1 for each 3x3 conv of a block of at most 64 channels (a skip
    in the same launch), K2 for an upconv of at most 64 input channels; in
    the backward C2 for each kernel-routed input of at least 8 channels
    (dx and dW), else C1 for dW (and K1 for a dx that is needed), K3 and C1
    (the 16 parity taps) for K2's."""
    sites: List[Site] = []
    B = batch
    for c in convs:
        if c.taps != 9 or c.width > KERNEL_MAX_CHANNELS:
            continue
        if c.up:
            h, w = c.h // 2, c.w // 2        # K2/K3 run at the input's resolution, 16 taps
            macs = B * h * w * 16 * c.cin * c.cout
            x, y, k = B * h * w * c.cin * BF16, B * c.h * c.w * c.cout * BF16, 16 * c.cin * c.cout
            sites += [Site("K2", c.layer, B, 2.0 * macs, x + k * BF16 + y + B * 2 * c.cout * F32),
                      Site("K3", c.layer, B, 2.0 * macs, y + k * BF16 + x),
                      Site("C1", c.layer, B, 2.0 * macs, x + y + k * F32)]
            continue
        y = B * c.h * c.w * c.cout * BF16
        hw = B * c.h * c.w
        cin = c.cin + c.cskip
        sites.append(Site("K1", c.layer, B, 2.0 * hw * 9 * cin * c.cout,
                          hw * cin * BF16 + 9 * cin * c.cout * BF16 + y + B * 2 * c.cout * F32))
        for part, ch, grad in (("x", c.cin, c.input_grad), ("skip", c.cskip, True)):
            if not ch:
                continue
            x, k = hw * ch * BF16, 9 * ch * c.cout
            layer = f"{c.layer}.{part}"
            if ch >= FUSED_BWD_MIN_CIN:
                sites.append(Site("C2", layer, B, 4.0 * hw * 9 * ch * c.cout,
                                  x + k * BF16 + y + x + k * F32))
                continue
            sites.append(Site("C1", layer, B, 2.0 * hw * 9 * ch * c.cout, x + y + k * F32))
            if grad:
                sites.append(Site("K1", f"{layer}.dx", B, 2.0 * hw * 9 * ch * c.cout,
                                  y + k * BF16 + x))
    return sites


def launches(sites: Sequence[Site]) -> Dict[str, int]:
    """Launches of each kernel family the sites make."""
    out: Dict[str, int] = {}
    for s in sites:
        out[s.kernel] = out.get(s.kernel, 0) + 1
    return out


def counted_launches(counters: Dict[str, int]) -> Dict[str, int]:
    """The port's launch counters (by kernel function) -> by family."""
    return {KERNELS[k]: v for k, v in counters.items() if k in KERNELS and v}
