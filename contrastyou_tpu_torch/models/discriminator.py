"""DCGAN-style discriminator of the adversarial trainer (counterpart of
contrastyou_tpu/models/discriminator.py, flax layer names kept as module
names): four 4x4 stride-2 convs (padding 1, no bias) in the compute dtype,
BatchNorm after all but the first, LeakyReLU 0.2, a global mean, a dense
layer to one logit and a sigmoid in f32.

BatchNorm follows flax's ``BatchNorm(momentum=0.9)`` on bf16 inputs: the
batch mean and biased variance are taken in f32, the running statistics
move as ``0.9 * old + 0.1 * batch`` (torch's momentum 0.1), the normalized
output is in the compute dtype. The convs are XLA convs in JAX, outside any
Pallas kernel, so they run on ``F.conv2d`` (cuDNN on the card)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Discriminator"]


class _BatchNorm(nn.Module):
    """flax ``BatchNorm`` (epsilon 1e-5, momentum 0.9) over the last axis."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, *, train: bool, update_stats: bool = True) -> torch.Tensor:
        if train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        if train and update_stats:
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        if not train:
            mean, var = self.mean, self.var
        mul = self.scale * torch.rsqrt(var + self.eps)
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


class Discriminator(nn.Module):
    def __init__(self, input_dim: int = 4, ndf: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_dim, self.dtype = input_dim, dtype
        widths = (ndf, ndf * 2, ndf * 4, ndf * 8)
        cin = input_dim
        for i, w in enumerate(widths):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, w, 4, stride=2, padding=1, bias=False))
            if i > 0:
                setattr(self, f"BatchNorm_{i - 1}", _BatchNorm(w))
            cin = w
        self.Dense_0 = nn.Linear(cin, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Discriminator":
        """flax's defaults from ``generator``: conv and dense kernels LeCun
        normal (std 1/sqrt(fan_in); flax truncates it, this does not), zero
        bias, BN scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           device=generator.device) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, *, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """NHWC ``x`` -> [B] probabilities in f32; a train-mode forward
        normalizes with batch statistics and, with ``update_stats``, moves
        the running ones."""
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"Conv_{i}")
            h = F.conv2d(h, conv.weight.to(self.dtype), stride=2, padding=1)
            if i > 0:
                bn = getattr(self, f"BatchNorm_{i - 1}")
                h = bn(h.permute(0, 2, 3, 1), train=train,
                       update_stats=update_stats).permute(0, 3, 1, 2)
            h = F.leaky_relu(h, 0.2)
        h = h.float().mean((2, 3)).to(self.dtype)
        out = F.linear(h, self.Dense_0.weight.to(self.dtype), self.Dense_0.bias.to(self.dtype))
        return torch.sigmoid(out.float()).squeeze(-1)
