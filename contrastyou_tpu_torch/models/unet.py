"""Named-layer U-Net on NHWC tensors (counterpart of
contrastyou_tpu/models/unet.py).

Parameters follow the original Contrast-You torch U-Net (``_Conv1.conv.0``
etc., OIHW conv weights), so ``utils/torch_convert.py`` maps them to the JAX
package's flax tree with the same key map the JAX package uses for reference
checkpoints. The forward takes and returns NHWC tensors like the JAX model:
``forward(x [B,H,W,Cin]) -> (out f32, taps dict)``.

Routing: the levels at most 64 channels wide (Conv1, Conv2, Up_conv3, Up2,
Up_conv2 at the reference widths) run through the hand-written kernels of
``ops/convblock.py``; the levels from 128 channels up use ``F.conv2d``, as the
JAX package leaves them to XLA.

BatchNorm follows JAX ``unet.py:185-206``: train mode normalizes with the
batch mean and BIASED variance and updates the running statistics as
``new = (1 - m) * old + m * batch`` with the biased variance (stock
``nn.BatchNorm2d`` would store the unbiased one); eval mode uses the running
statistics.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convblock import (bn_affine, bn_relu, convblock_stage,
                             upconv3x3_bn_stats)

__all__ = ["UNet", "ConvBlock", "UpConv", "BatchNorm", "KERNEL_MAX_CHANNELS"]

#: widest level routed through the hand-written kernels
KERNEL_MAX_CHANNELS = 64


def _hwio(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0).to(dtype)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class BatchNorm(nn.Module):
    """BatchNorm parameters and running statistics under the stock names
    (weight, bias, running_mean, running_var); the math is in :meth:`affine`."""

    def __init__(self, features: int, momentum: float, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def affine(self, p: torch.Tensor, ssum: Optional[torch.Tensor] = None,
               ssq: Optional[torch.Tensor] = None, *, train: bool,
               update: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (a, b) [C] f32 of ``a*p + b``. Train mode takes the batch
        statistics of the NHWC pre-activation ``p`` — from its per-sample
        sums [B, C] when given — and updates the running statistics when
        ``update``."""
        if not train:
            a = self.weight * torch.rsqrt(self.running_var + self.eps)
            return a, self.bias - a * self.running_mean
        if ssum is None:
            pf = p.float()
            ssum, ssq = pf.sum((1, 2)), (pf * pf).sum((1, 2))
        count = p.numel() // p.shape[-1]
        a, b, mean, var = bn_affine(ssum.sum(0), ssq.sum(0), count,
                                    self.weight, self.bias, self.eps)
        if update:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return a, b


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """Two 3x3 conv + BN + ReLU (ref arch/unet.py ``_ConvBlock``; parameter
    names ``conv.0`` / ``conv.1`` / ``conv.3`` / ``conv.4``). ``skip``
    behaves as ``cat([skip, x], -1)``."""

    def __init__(self, cin: int, features: int, momentum: float,
                 dtype: torch.dtype):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.conv = nn.Sequential(_conv(cin, features),
                                  BatchNorm(features, momentum), nn.ReLU(),
                                  _conv(features, features),
                                  BatchNorm(features, momentum), nn.ReLU())

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None, *,
                train: bool = True, update_stats: bool = True) -> torch.Tensor:
        c0, bn0, _, c1, bn1, _ = self.conv
        if self.features <= KERNEL_MAX_CHANNELS:
            return convblock_stage(x.to(self.dtype), skip, _hwio(c0.weight, self.dtype),
                                   _hwio(c1.weight, self.dtype), bn0, bn1,
                                   train=train, update_stats=update_stats)
        h = x.to(self.dtype)
        if skip is not None:
            h = torch.cat([skip.to(self.dtype), h], -1)
        for conv, bn in ((c0, bn0), (c1, bn1)):
            p = _nhwc(F.conv2d(_nchw(h), conv.weight.to(self.dtype), padding=1))
            h = bn_relu(p, *bn.affine(p, train=train, update=update_stats))
        return h


class UpConv(nn.Module):
    """Nearest 2x upsample + 3x3 conv + BN + ReLU (ref arch/unet.py
    ``up_conv``; parameter names ``up.1`` / ``up.2``). With at most 64 input
    channels the upsample+conv is K2 (four parity convs, never building the
    upsampled input)."""

    def __init__(self, cin: int, features: int, momentum: float,
                 dtype: torch.dtype):
        super().__init__()
        self.cin, self.dtype = cin, dtype
        self.up = nn.Sequential(nn.Upsample(scale_factor=2), _conv(cin, features),
                                BatchNorm(features, momentum), nn.ReLU())

    def forward(self, x: torch.Tensor, *, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        _, conv, bn, _ = self.up
        x = x.to(self.dtype)
        if self.cin <= KERNEL_MAX_CHANNELS:
            p, s, q = upconv3x3_bn_stats(x, _hwio(conv.weight, self.dtype))
            return bn_relu(p, *bn.affine(p, s, q, train=train, update=update_stats))
        up = F.interpolate(_nchw(x), scale_factor=2, mode="nearest")
        p = _nhwc(F.conv2d(up, conv.weight.to(self.dtype), padding=1))
        return bn_relu(p, *bn.affine(p, train=train, update=update_stats))


class UNet(nn.Module):
    """5-level U-Net with the JAX model's named-layer registry, partial
    forward ``until`` and feature ``taps``."""

    layer_dimension = {"Conv1": 1, "Conv2": 2, "Conv3": 4, "Conv4": 8,
                       "Conv5": 16, "Up_conv5": 8, "Up_conv4": 4,
                       "Up_conv3": 2, "Up_conv2": 1, "Deconv_1x1": None}
    encoder_names = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
    decoder_names = ("Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3",
                     "Up2", "Up_conv2", "Deconv_1x1")
    arch_elements = encoder_names + decoder_names

    def __init__(self, input_dim: int = 1, num_classes: int = 4,
                 max_channel: int = 256, momentum: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if max_channel % 16 or max_channel < 128:
            raise ValueError(f"max_channel must be a multiple of 16 >= 128, got {max_channel}")
        self.input_dim, self.num_classes = input_dim, num_classes
        self.max_channel, self.dtype = max_channel, dtype
        cd = self.get_channel_dim
        kw = dict(momentum=momentum, dtype=dtype)
        self._Conv1 = ConvBlock(input_dim, cd("Conv1"), **kw)
        self._Conv2 = ConvBlock(cd("Conv1"), cd("Conv2"), **kw)
        self._Conv3 = ConvBlock(cd("Conv2"), cd("Conv3"), **kw)
        self._Conv4 = ConvBlock(cd("Conv3"), cd("Conv4"), **kw)
        self._Conv5 = ConvBlock(cd("Conv4"), cd("Conv5"), **kw)
        self._Up5 = UpConv(cd("Conv5"), cd("Up_conv5"), **kw)
        self._Up_conv5 = ConvBlock(2 * cd("Up_conv5"), cd("Up_conv5"), **kw)
        self._Up4 = UpConv(cd("Up_conv5"), cd("Up_conv4"), **kw)
        self._Up_conv4 = ConvBlock(2 * cd("Up_conv4"), cd("Up_conv4"), **kw)
        self._Up3 = UpConv(cd("Up_conv4"), cd("Up_conv3"), **kw)
        self._Up_conv3 = ConvBlock(2 * cd("Up_conv3"), cd("Up_conv3"), **kw)
        self._Up2 = UpConv(cd("Up_conv3"), cd("Up_conv2"), **kw)
        self._Up_conv2 = ConvBlock(2 * cd("Up_conv2"), cd("Up_conv2"), **kw)
        self._Deconv_1x1 = nn.Conv2d(cd("Up_conv2"), num_classes, 1)

    def get_channel_dim(self, name: str) -> int:
        if name == "Deconv_1x1":
            return self.num_classes
        if name in self.layer_dimension:
            return int(self.layer_dimension[name] / 16 * self.max_channel)
        raise KeyError(name)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNet":
        """Random weights from ``generator``: conv kernels normal with std
        1/sqrt(fan_in) (LeCun), BN scale 1 and bias 0, zero head bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator,
                                device=generator.device)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, *, until: Optional[str] = None,
                taps: Sequence[str] = (), train: bool = True,
                update_stats: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """NHWC forward -> ``(out, taps)``: ``out`` is the activation at
        ``until`` (or the logits) as f32, ``taps`` maps each requested layer
        name to its f32 activation. ``update_stats=False`` leaves the running
        statistics untouched (the ``disable_bn`` two-stage pass)."""
        for t in tuple(taps) + ((until,) if until else ()):
            if t not in self.layer_dimension:
                raise KeyError(f"'{t}' not in {tuple(self.layer_dimension)}")
        collected: Dict[str, torch.Tensor] = {}

        def emit(name, value):
            if name in taps:
                collected[name] = value.float()
            return until == name

        kw = dict(train=train, update_stats=update_stats)

        def pool(h):
            return _nhwc(F.max_pool2d(_nchw(h), 2))

        e1 = self._Conv1(x.to(self.dtype), **kw)
        if emit("Conv1", e1):
            return e1.float(), collected
        e2 = self._Conv2(pool(e1), **kw)
        if emit("Conv2", e2):
            return e2.float(), collected
        e3 = self._Conv3(pool(e2), **kw)
        if emit("Conv3", e3):
            return e3.float(), collected
        e4 = self._Conv4(pool(e3), **kw)
        if emit("Conv4", e4):
            return e4.float(), collected
        e5 = self._Conv5(pool(e4), **kw)
        if emit("Conv5", e5):
            return e5.float(), collected
        d = e5
        for up, upc, skip, name in ((self._Up5, self._Up_conv5, e4, "Up_conv5"),
                                    (self._Up4, self._Up_conv4, e3, "Up_conv4"),
                                    (self._Up3, self._Up_conv3, e2, "Up_conv3"),
                                    (self._Up2, self._Up_conv2, e1, "Up_conv2")):
            d = upc(up(d, **kw), skip=skip, **kw)
            if emit(name, d):
                return d.float(), collected
        head = self._Deconv_1x1
        logits = F.linear(d, head.weight[:, :, 0, 0].to(self.dtype),
                          head.bias.to(self.dtype)).float()
        emit("Deconv_1x1", logits)
        return logits, collected
