"""Batched geometric + gamma augmentation with exact transform replay
(counterpart of contrastyou_tpu/ops/affine.py, its default gather path).

A transform is explicit data: a :class:`GeoParams` batch applied to the input
image and, with the same parameters, to the logits, so ``T(f(x))`` and
``f(T(x))`` share one geometry. Ranges mirror the reference: scale U(0.8,
1.3), rotation U(-45, 45) degrees, translation U(-0.1, 0.1) of the image
size, mirror with p=0.9 over a random axis, gamma U(0.5, 2). All tensors are
NHWC; sampling is over normalized [-1, 1] pixel-center coordinates with zeros
padding (``grid_sample`` semantics).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["GeoParams", "sample_geo_params", "sample_gammas",
           "affine_matrices", "grid_sample", "apply_flips", "apply_geometric",
           "apply_gamma", "transform_image", "transform_logits"]


class GeoParams(NamedTuple):
    """Per-sample geometric transform parameters (all [B]-shaped)."""
    scale: torch.Tensor
    angle: torch.Tensor      # radians
    tx: torch.Tensor         # translation in [-1, 1] coordinates
    ty: torch.Tensor
    flip_h: torch.Tensor     # bool
    flip_w: torch.Tensor     # bool


def _uniform(generator, batch, lo, hi):
    return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                       device=generator.device)


def sample_geo_params(generator: torch.Generator, batch: int) -> GeoParams:
    """Draw a GeoParams batch on the generator's device (same distribution
    as the JAX ``sample_geo_params``; the draws themselves differ)."""
    scale = _uniform(generator, batch, 0.8, 1.3)
    angle = _uniform(generator, batch, -45.0, 45.0) * (math.pi / 180.0)
    tx = _uniform(generator, batch, -0.1, 0.1) * 2.0
    ty = _uniform(generator, batch, -0.1, 0.1) * 2.0
    do_mirror = _uniform(generator, batch, 0.0, 1.0) < 0.9
    axis = _uniform(generator, batch, 0.0, 1.0) < 0.5
    return GeoParams(scale=scale, angle=angle, tx=tx, ty=ty,
                     flip_h=do_mirror & axis, flip_w=do_mirror & ~axis)


def sample_gammas(generator: torch.Generator, batch: int) -> torch.Tensor:
    return _uniform(generator, batch, 0.5, 2.0)


def affine_matrices(params: GeoParams) -> torch.Tensor:
    """[B, 2, 3] output->input sampling matrices in normalized coords:
    q = (1/s) R(-theta) (p - t)."""
    inv_s = 1.0 / params.scale
    c, s = torch.cos(params.angle), torch.sin(params.angle)
    a00, a01 = inv_s * c, inv_s * s
    a10, a11 = -inv_s * s, inv_s * c
    b0 = -(a00 * params.tx + a01 * params.ty)
    b1 = -(a10 * params.tx + a11 * params.ty)
    return torch.stack([torch.stack([a00, a01, b0], -1),
                        torch.stack([a10, a11, b1], -1)], -2)


def _grid(H: int, W: int, device) -> torch.Tensor:
    """[H, W, 2] normalized (x, y) pixel-center coordinates."""
    ys = (torch.arange(H, device=device) + 0.5) / H * 2.0 - 1.0
    xs = (torch.arange(W, device=device) + 0.5) / W * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def grid_sample(images: torch.Tensor, coords: torch.Tensor, *, order: int) -> torch.Tensor:
    """Sample NHWC ``images`` at normalized (x, y) ``coords`` [B, H', W', 2]
    with zeros padding; order 0 = nearest (round half to even), 1 =
    bilinear."""
    B, H, W, C = images.shape
    x = (coords[..., 0] + 1.0) * 0.5 * W - 0.5
    y = (coords[..., 1] + 1.0) * 0.5 * H - 0.5
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(*yi.shape, C)
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return vals * valid[..., None].to(images.dtype)

    if order == 0:
        return gather(torch.round(y).long(), torch.round(x).long())
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    wx = (x - x0).to(images.dtype)[..., None]
    wy = (y - y0).to(images.dtype)[..., None]
    return (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy + gather(y0 + 1, x0 + 1) * wx * wy)


def apply_flips(images: torch.Tensor, params: GeoParams) -> torch.Tensor:
    out = torch.where(params.flip_h[:, None, None, None], images.flip(1), images)
    return torch.where(params.flip_w[:, None, None, None], out.flip(2), out)


def apply_geometric(images: torch.Tensor, params: GeoParams, *,
                    order: int = 1) -> torch.Tensor:
    """Affine warp then mirror, NHWC, as ONE gather: the mirror is folded
    into the sampling matrix (normalized pixel-center coordinates flip
    exactly)."""
    B, H, W, _ = images.shape
    sign_x = torch.where(params.flip_w, -1.0, 1.0)
    sign_y = torch.where(params.flip_h, -1.0, 1.0)
    col_signs = torch.stack([sign_x, sign_y, torch.ones_like(sign_x)], -1)
    mats = affine_matrices(params) * col_signs[:, None, :]
    grid = _grid(H, W, images.device).to(mats.dtype)
    hom = torch.cat([grid, torch.ones(H, W, 1, device=images.device, dtype=mats.dtype)], -1)
    coords = torch.einsum("bij,hwj->bhwi", mats, hom)
    return grid_sample(images, coords, order=order)


def apply_gamma(images: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """Per-sample gamma correction on [0, 1] images; ``gammas`` is [B]."""
    return images.clamp(0.0, 1.0) ** gammas.reshape(-1, 1, 1, 1)


def transform_image(images: torch.Tensor, params: GeoParams,
                    gammas: torch.Tensor) -> torch.Tensor:
    """Gamma then geometry (the reference RisingWrapper's image mode), with
    nearest interpolation like the reference BaseAffine."""
    return apply_geometric(apply_gamma(images, gammas), params, order=0)


def transform_logits(logits: torch.Tensor, params: GeoParams, *,
                     order: int = 0) -> torch.Tensor:
    """Geometry only: aligns f(x) with f(T(x))."""
    return apply_geometric(logits, params, order=order)
