"""Projection heads of the contrastive hooks and cluster heads of the
discrete-MI and cross-correlation hooks (counterpart of the
``ProjectionHead`` / ``DenseProjectionHead`` / ``ClusterHead`` /
``DenseClusterHead`` / ``CrossCorrelationProjector`` of
contrastyou_tpu/models/projectors.py), on NHWC tensors.

Projection-head parameters carry the flax names (``Dense_0``, ``Dense_1``;
``Conv_0``, ``Conv_1``) so ``utils/torch_convert.py`` maps them one to one.
Dense layers are ``nn.Linear`` ([out, in] weights), the 1x1 convs
``nn.Conv2d`` ([out, in, 1, 1]); both run as matrix products over the channel
axis. A cluster head keeps its S subheads as one stacked ``weight`` [S, C, K]
and ``bias`` [S, K], the layout of flax's vmapped subheads; the ``mlp`` form
puts ``hidden_weight`` [S, C, D] and ``hidden_bias`` [S, D] before it (then
``weight`` is [S, D, K]).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .pooling import adaptive_avg_pool2d

__all__ = ["l2_normalize", "ProjectionHead", "DenseProjectionHead", "ClusterHead",
           "DenseClusterHead", "CrossCorrelationProjector"]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(max(sum(x^2), eps^2))``: unlike ``x / max(norm, eps)`` its
    gradient at x == 0 is finite."""
    sq = (x * x).sum(dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def _avg_pool(x: torch.Tensor, spatial_size: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool; bf16 maps accumulate their means in f32."""
    accum = torch.float32 if x.dtype == torch.bfloat16 else None
    return adaptive_avg_pool2d(x, spatial_size, accum_dtype=accum)


@torch.no_grad()
def _init(module: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal kernels (std 1/sqrt(fan_in)) and zero biases, the flax
    defaults' scale."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = torch.randn(m.weight.shape, generator=generator, device=generator.device)
            m.weight.copy_(w / math.sqrt(m.weight[0].numel()))
            m.bias.zero_()
        elif isinstance(m, _ClusterHeadBase):
            for w, b in m.layers():
                w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
                        / math.sqrt(w.shape[1]))
                b.zero_()


def _leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax ``leaky_relu``: slope 1 at x == 0 (``F.leaky_relu`` takes the
    negative slope there, and a zero-padded or dead pixel sits exactly at 0)."""
    return torch.where(x >= 0, x, slope * x)


def _dense(x: torch.Tensor, layer: nn.Module, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ W + b`` over the last axis, in ``dtype`` (None: the promotion of
    the input and parameter dtypes); the product is rounded before the bias
    is added, as flax does."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.t().to(dt)) + layer.bias.to(dt)


class ProjectionHead(nn.Module):
    """Global projector: average pool, Dense(hidden), leaky ReLU 0.01,
    Dense(out), L2 normalize."""

    def __init__(self, in_dim: int, output_dim: int = 256, hidden_dim: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, output_dim)

    def init_weights(self, generator: torch.Generator) -> "ProjectionHead":
        _init(self, generator)
        return self

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = _avg_pool(features, (1, 1)).reshape(features.shape[0], -1)
        x = _dense(_leaky_relu(_dense(x, self.Dense_0, None)), self.Dense_1, None)
        return l2_normalize(x)


class DenseProjectionHead(nn.Module):
    """Pixel-wise projector: 1x1 conv(hidden), leaky ReLU 0.01, 1x1
    conv(out), average pool to ``spatial_size``, L2 normalize over channels.

    ``bf16``: a bf16 input runs both 1x1 convs in bf16 (f32 parameters cast,
    products rounded to bf16) and pools before the output conv, as the JAX
    head does on an accelerator (``PROJ_BF16``, ``POOL_EARLY``): the average
    pool commutes with the 1x1 conv in real arithmetic, and pooling first
    removes the full-resolution output conv. Pooling and the normalization
    stay f32."""

    def __init__(self, in_dim: int, output_dim: int = 256, hidden_dim: int = 256,
                 spatial_size: Tuple[int, int] = (16, 16), *, bf16: bool = False):
        super().__init__()
        self.spatial_size, self.bf16 = tuple(spatial_size), bf16
        self.Conv_0 = nn.Conv2d(in_dim, hidden_dim, 1)
        self.Conv_1 = nn.Conv2d(hidden_dim, output_dim, 1)

    def init_weights(self, generator: torch.Generator) -> "DenseProjectionHead":
        _init(self, generator)
        return self

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        bf16 = self.bf16 and features.dtype == torch.bfloat16
        cdt = torch.bfloat16 if bf16 else None
        x = _leaky_relu(_dense(features, self.Conv_0, cdt))
        if bf16:
            x = _dense(_avg_pool(x, self.spatial_size), self.Conv_1, cdt)
        else:
            x = _avg_pool(_dense(x, self.Conv_1, cdt), self.spatial_size)
        return l2_normalize(x.float())


#: hidden width of the dense heads' ``mlp`` form (the cross-correlation
#: block's, JAX hooks/ccblock.py)
MLP_HIDDEN = 64


class _ClusterHeadBase(nn.Module):
    """S linear subheads of K clusters on C channels, stacked: ``weight`` [S,
    C, K], ``bias`` [S, K]; softmax over K with temperature ``T``. The
    normalized form is not ported."""

    def __init__(self, in_dim: int, num_clusters: int, num_subheads: int, T: float = 1.0):
        super().__init__()
        self.num_clusters, self.num_subheads, self.T = num_clusters, num_subheads, float(T)
        self.weight = nn.Parameter(torch.empty(num_subheads, in_dim, num_clusters))
        self.bias = nn.Parameter(torch.zeros(num_subheads, num_clusters))

    def layers(self):
        """(weight, bias) of each layer, input first."""
        return [(self.weight, self.bias)]

    def init_weights(self, generator: torch.Generator):
        _init(self, generator)
        return self


class ClusterHead(_ClusterHeadBase):
    """Global cluster distributions: average pool, then per subhead ``x @
    W_s + b_s`` and the softmax -> [S, B, K]."""

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool2d(features, (1, 1)).reshape(features.shape[0], -1)
        z = torch.einsum("bc,sck->sbk", x, self.weight) + self.bias[:, None]
        return torch.softmax(z / self.T, -1)


class DenseClusterHead(_ClusterHeadBase):
    """Per-pixel cluster distributions: a 1x1 projection per subhead and the
    softmax -> [S, B, H, W, K]. ``head_type`` ``linear``, or ``mlp``: a
    hidden layer of :data:`MLP_HIDDEN` (``hidden_weight`` [S, C, D],
    ``hidden_bias`` [S, D]) and leaky ReLU 0.01 first, ``weight`` then [S,
    D, K]. The mlp form computes in the promotion of the input's and the
    parameters' dtypes (f32 for bf16 taps), as flax's ``nn.Conv`` does
    without a ``dtype``."""

    def __init__(self, in_dim: int, num_clusters: int, num_subheads: int, T: float = 1.0,
                 head_type: str = "linear"):
        if head_type not in ("linear", "mlp"):
            raise ValueError(f"head_type {head_type!r}: linear or mlp")
        mlp = head_type == "mlp"
        super().__init__(MLP_HIDDEN if mlp else in_dim, num_clusters, num_subheads, T=T)
        self.head_type = head_type
        if mlp:
            self.hidden_weight = nn.Parameter(torch.empty(num_subheads, in_dim, MLP_HIDDEN))
            self.hidden_bias = nn.Parameter(torch.zeros(num_subheads, MLP_HIDDEN))

    def layers(self):
        hidden = [(self.hidden_weight, self.hidden_bias)] if self.head_type == "mlp" else []
        return hidden + super().layers()

    def merged_params(self):
        """(w [C, S*K] subhead-major, b [S*K]): every subhead of the linear
        form in one product."""
        if self.head_type != "linear":
            raise ValueError("merged_params: the linear form only")
        S, C, K = self.weight.shape
        return self.weight.permute(1, 0, 2).reshape(C, S * K), self.bias.reshape(S * K)

    def _mlp_logits(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [S, B, H, W, K] logits of the mlp form."""
        def layer(h, w, b, pattern):
            dt = torch.promote_types(h.dtype, w.dtype)
            return torch.einsum(pattern, h.to(dt), w.to(dt)) + b.to(dt)[:, None, None, None]

        h = _leaky_relu(layer(x, self.hidden_weight, self.hidden_bias, "bhwc,scd->sbhwd"))
        return layer(h, self.weight, self.bias, "sbhwd,sdk->sbhwk")

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if self.head_type == "mlp":
            return torch.softmax(self._mlp_logits(features) / self.T, -1)
        z = torch.einsum("bhwc,sck->sbhwk", features, self.weight)
        return torch.softmax((z + self.bias[:, None, None, None]) / self.T, -1)


class CrossCorrelationProjector(DenseClusterHead):
    """The cross-correlation block's head: a :class:`DenseClusterHead` of
    the ``mlp`` form by default, 20 clusters, one subhead."""

    def __init__(self, in_dim: int, num_clusters: int = 20, num_subheads: int = 1,
                 head_type: str = "mlp"):
        super().__init__(in_dim, num_clusters, num_subheads, head_type=head_type)
