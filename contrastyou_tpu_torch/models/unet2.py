"""UNet2: a ResNet-block U-Net with linear attention and an optional
sinusoidal time embedding (counterpart of contrastyou_tpu/models/unet2.py).

It computes in f32, as JAX's (which has no ``dtype`` field): cuDNN convs and
``torch.einsum`` attention, as JAX leaves its einsums to XLA (there is no
Pallas kernel in it, so no hand-written one here). Modules carry flax's
names (``Conv_0``, ``ResnetBlock_3``, ``LinearAttention_1``,
``_PreNormResidual_2`` ...), numbered per type in the order the flax module
creates them, so the bridge maps them by path. As in flax: ``gelu`` is the
tanh approximation, GroupNorm's epsilon is 1e-6 (also in the 1-group
pre-norm), every conv has a bias but the attention's qkv projection, the
4x4 stride-2 conv pads (1, 1), the linear attention's softmax of k runs over
the tokens, and the decoder's ``is_last`` is never true (it always
upsamples, and the first skip is never read). ``until`` and ``taps`` raise:
UNet2 has no named-layer registry.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["UNet2"]


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


def _gn(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6)


class _Counter:
    """flax's automatic names: ``<Type>_<n>`` per type, in creation order."""

    def __init__(self, owner: nn.Module):
        self.owner, self.counts = owner, {}

    def add(self, kind: str, module: nn.Module) -> nn.Module:
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        self.owner.add_module(f"{kind}_{n}", module)
        return module


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, dim_out: int, groups: int = 8,
                 time_emb_dim: Optional[int] = None):
        super().__init__()
        g = min(groups, dim_out)
        self.Conv_0 = nn.Conv2d(cin, dim_out, 3, padding=1)
        self.GroupNorm_0 = _gn(g, dim_out)
        if time_emb_dim is not None:
            self.Dense_0 = nn.Linear(time_emb_dim, dim_out)
        self.Conv_1 = nn.Conv2d(dim_out, dim_out, 3, padding=1)
        self.GroupNorm_1 = _gn(g, dim_out)
        if cin != dim_out:
            self.Conv_2 = nn.Conv2d(cin, dim_out, 1)

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = _group_norm(self.Conv_0(x), self.GroupNorm_0)
        if time_emb is not None:
            h = h + self.Dense_0(F.silu(time_emb))[:, :, None, None]
        h = F.silu(h)
        h = F.silu(_group_norm(self.Conv_1(h), self.GroupNorm_1))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class _Attention(nn.Module):
    """qkv 1x1 projection (no bias) and output 1x1 projection; the channels
    of the qkv output are (q|k|v, head, dim_head), as flax's reshape splits
    them."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.Conv_0 = nn.Conv2d(dim, inner * 3, 1, bias=False)
        self.Conv_1 = nn.Conv2d(inner, dim, 1)

    def qkv(self, x: torch.Tensor):
        B, _, H, W = x.shape
        t = self.Conv_0(x).reshape(B, 3, self.heads, self.dim_head, H * W)
        return t.permute(1, 0, 4, 2, 3).unbind(0)       # each [B, N, heads, d]

    def project(self, out: torch.Tensor, shape) -> torch.Tensor:
        B, _, H, W = shape
        out = out.reshape(B, H, W, -1).permute(0, 3, 1, 2)
        return self.Conv_1(out)


class LinearAttention(_Attention):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        q = torch.softmax(q, -1) * self.dim_head ** -0.5
        k = torch.softmax(k, 1)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return self.project(out, x.shape)


class Attention(_Attention):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x)
        attn = torch.einsum("bnhd,bmhd->bhnm", q * self.dim_head ** -0.5, k)
        out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(attn, -1), v)
        return self.project(out, x.shape)


class _PreNormResidual(nn.Module):
    """``x + inner(GroupNorm(1 group)(x))``; ``inner`` is registered on the
    net (flax names the attention in the net's scope), the norm here."""

    def __init__(self, dim: int, inner: nn.Module):
        super().__init__()
        self.GroupNorm_0 = _gn(1, dim)
        self.inner = [inner]                             # not a child module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.inner[0](_group_norm(x, self.GroupNorm_0))


class UNet2(nn.Module):
    """UNet2 of ``dim`` base channels; ``forward(x [B,H,W,Cin], time=None)
    -> (logits [B,H,W,num_classes] f32, {})``."""

    def __init__(self, input_dim: int = 1, num_classes: int = 4, dim: int = 16,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), with_time_emb: bool = False,
                 resnet_block_groups: int = 8):
        super().__init__()
        self.input_dim, self.num_classes, self.dim = input_dim, num_classes, dim
        self.with_time_emb = with_time_emb
        name = _Counter(self)
        groups = resnet_block_groups
        init_dim = dim // 3 * 2
        dims = [init_dim] + [dim * m for m in dim_mults]
        tdim = dim * 4 if with_time_emb else None
        if with_time_emb:
            name.add("Dense", nn.Linear(dim, dim * 4))
            name.add("Dense", nn.Linear(dim * 4, dim * 4))
        # the stages hold the modules in plain lists: each is registered once,
        # under its flax name
        self.stem = [name.add("Conv", nn.Conv2d(input_dim, init_dim, 7, padding=3))]

        def block(cin, cout, t=tdim):
            return name.add("ResnetBlock", ResnetBlock(cin, cout, groups, t))

        def prenorm(d, kind, cls):
            return name.add("_PreNormResidual", _PreNormResidual(d, name.add(kind, cls(d))))

        pairs = list(zip(dims[:-1], dims[1:]))
        self.downs = []
        for i, (din, dout) in enumerate(pairs):
            stage = [block(din, dout), block(dout, dout), prenorm(dout, "LinearAttention",
                                                                  LinearAttention)]
            if i < len(pairs) - 1:
                stage.append(name.add("Conv", nn.Conv2d(dout, dout, 4, stride=2, padding=1)))
            self.downs.append(stage)
        mid = dims[-1]
        self.mid = [block(mid, mid), prenorm(mid, "Attention", Attention), block(mid, mid)]
        self.ups = []
        cur = mid
        for din, dout in reversed(pairs[1:]):
            self.ups.append([block(cur + dout, din), block(din, din),
                             prenorm(din, "LinearAttention", LinearAttention),
                             name.add("Conv", nn.Conv2d(din, din, 3, padding=1))])
            cur = din
        self.final = [block(cur, dim, None), name.add("Conv", nn.Conv2d(dim, num_classes, 1))]

    def time_embedding(self, time: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=time.device, dtype=torch.float32)
                          * (-math.log(10000.0) / (half - 1)))
        args = time.float()[:, None] * freqs[None, :]
        t = torch.cat([torch.sin(args), torch.cos(args)], -1)
        t = F.gelu(self.Dense_0(t), approximate="tanh")
        return self.Dense_1(t)

    def forward(self, x: torch.Tensor, *, time: Optional[torch.Tensor] = None,
                train: bool = True, until: Optional[str] = None,
                taps: Sequence[str] = ()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del train
        if until is not None or tuple(taps):
            raise ValueError("UNet2 has no named-layer registry: no until / taps")
        t = None
        if self.with_time_emb:
            if time is None:
                raise ValueError("UNet2(with_time_emb=True) needs time")
            t = self.time_embedding(time)
        h = self.stem[0](x.float().permute(0, 3, 1, 2))
        skips = []
        for b1, b2, attn, *down in self.downs:
            h = attn(b2(b1(h, t), t))
            skips.append(h)
            if down:
                h = down[0](h)
        b1, attn, b2 = self.mid
        h = b2(attn(b1(h, t)), t)
        for b1, b2, attn, conv in self.ups:
            h = torch.cat([h, skips.pop()], 1)
            h = attn(b2(b1(h, t), t))
            h = conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        block, head = self.final
        logits = head(block(h))
        return logits.permute(0, 2, 3, 1).float(), {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UNet2":
        """Random weights from ``generator``: kernels normal with std
        1/sqrt(fan_in) (LeCun), zero biases, GroupNorm scale 1 and bias 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.randn(m.weight.shape, generator=generator, device=generator.device)
                m.weight.copy_(w / math.sqrt(m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
        return self
