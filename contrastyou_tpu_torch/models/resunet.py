"""ResNet-encoder U-Net (counterpart of contrastyou_tpu/models/resunet.py):
encoder stages ``Conv1`` ... ``Conv5`` of residual blocks, the U-Net's
decoder. It has the U-Net's named-layer surface (``until``, ``taps``,
``get_channel_dim``, ``update_stats``, ``_Deconv_1x1``, stage names for the
pretraining freeze), so every hook and trainer runs on it.

The encoder runs on cuDNN (``F.conv2d``), as it runs on XLA in JAX; the
decoder is the U-Net's ``UpConv`` / ``ConvBlock``, so its levels of at most
64 channels (Up_conv3, Up2, Up_conv2) run on the hand-written kernels.

Each residual block's BatchNorm is flax's ``nn.BatchNorm(momentum=1 - m)``:
f32 batch statistics with the biased variance, eps 1e-5, running statistics
``(1 - m) * old + m * batch``. A stride-2 3x3 conv pads as flax's
``padding="SAME"``: (0, 1) on an even size, not (1, 1) (:func:`same_pad`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convblock import bn_relu
from .unet import BatchNorm, NamedLayerNet, _nchw, _nhwc

__all__ = ["ResUNet", "ResidualBlock", "same_pad"]


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA ``padding="SAME"`` along one axis: the
    total ``max((ceil(size/stride) - 1)*stride + kernel - size, 0)``, its
    extra pixel at the end (a 3x3 stride-2 conv on an even size pads (0, 1))."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` of NHWC ``x`` in
    ``dtype``, on NHWC -> NHWC. A 1x1 conv reads every ``stride``-th pixel
    (SAME pads it by nothing) and is a matmul over the channels (the CPU's
    oneDNN 1x1 stride-2 backward on channels-last input corrupts the heap in
    torch 2.13)."""
    k, s = conv.kernel_size[0], conv.stride[0]
    if k == 1:
        return F.linear(x[:, ::s, ::s].to(dtype), conv.weight[:, :, 0, 0].to(dtype))
    h = _nchw(x.to(dtype))
    (pt, pb), (pl, pr) = same_pad(h.shape[2], k, s), same_pad(h.shape[3], k, s)
    if pt or pb or pl or pr:
        h = F.pad(h, (pl, pr, pt, pb))
    return _nhwc(F.conv2d(h, conv.weight.to(dtype), stride=s))


class ResidualBlock(nn.Module):
    """conv3x3(stride) -> BN -> ReLU -> conv3x3 -> BN, plus the input (a 1x1
    strided projection when the shape changes), then ReLU. Parameter names
    are flax's: ``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1``,
    ``Conv_2``."""

    def __init__(self, cin: int, features: int, stride: int, momentum: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride=stride, bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum)
        self.Conv_1 = nn.Conv2d(features, features, 3, bias=False)
        self.BatchNorm_1 = BatchNorm(features, momentum)
        if stride != 1 or cin != features:
            self.Conv_2 = nn.Conv2d(cin, features, 1, stride=stride, bias=False)

    def forward(self, x: torch.Tensor, *, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        kw = dict(train=train, update=update_stats)
        p = _conv_same(x, self.Conv_0, self.dtype)
        h = bn_relu(p, *self.BatchNorm_0.affine(p, **kw))
        p = _conv_same(h, self.Conv_1, self.dtype)
        a, b = self.BatchNorm_1.affine(p, **kw)
        y = (p.float() * a + b).to(self.dtype)
        residual = _conv_same(x, self.Conv_2, self.dtype) if hasattr(self, "Conv_2") else x
        return torch.relu(y + residual.to(self.dtype))


class _ResStage(nn.Module):
    def __init__(self, cin: int, features: int, blocks: int, downsample: bool,
                 momentum: float, dtype: torch.dtype):
        super().__init__()
        for i in range(blocks):
            stride = 2 if (i == 0 and downsample) else 1
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(
                cin if i == 0 else features, features, stride, momentum, dtype))

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        for block in self.children():
            x = block(x, **kw)
        return x


class ResUNet(NamedLayerNet):
    """ResNet-encoder U-Net, ``blocks_per_stage`` residual blocks a stage
    (the first of Conv2 ... Conv5 downsampling by 2)."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4,
                 max_channel: int = 256, blocks_per_stage: int = 2,
                 momentum: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__(input_dim, num_classes, max_channel, dtype)
        cd = self.get_channel_dim
        cin = input_dim
        for i, name in enumerate(self.encoder_names):
            setattr(self, f"_{name}", _ResStage(cin, cd(name), blocks_per_stage, i > 0,
                                                momentum, dtype))
            cin = cd(name)
        self._build_decoder(momentum=momentum, dtype=dtype)

    def encode(self, x, emit, kw):
        out, h = [], x
        for name in self.encoder_names:
            h = getattr(self, f"_{name}")(h, **kw)
            if emit(name, h):
                return None
            out.append(h)
        return out
