"""RAdam with coupled weight decay and the per-step warmup-cosine schedule
(counterpart of contrastyou_tpu/engine/optim.py, which chains
``optax.add_decayed_weights`` before ``optax.radam``).

Written out by hand to reproduce optax's arithmetic, which differs from
``torch.optim.RAdam``: eps is added outside the square root of the
bias-corrected second moment, the rectification threshold is ro >= 5 (torch
uses > 5), an unrectified step applies the bias-corrected first moment with
no other scaling, and the learning rate of update ``t`` is the schedule at
``t - 1`` (optax counts from 0).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["warmup_schedule", "RAdam", "create_optimizer"]


def warmup_schedule(*, base_lr: float, multiplier: float, warmup_max_epoch: int,
                    max_epoch: int, steps_per_epoch: int, eta_min: float = 1e-7,
                    name: str = "cosine") -> Callable[[int], float]:
    """lr ramps linearly base_lr -> base_lr*multiplier over the warmup
    epochs, then cosine-anneals to eta_min over the rest (the reference
    GradualWarmupScheduler), counted in steps."""
    if name != "cosine":
        raise KeyError(f"scheduler '{name}' is not ported (cosine only)")
    peak = base_lr * multiplier
    warm = max(warmup_max_epoch * steps_per_epoch, 1)
    rest = max((max_epoch - warmup_max_epoch) * steps_per_epoch, 1)
    alpha = eta_min / max(peak, 1e-30)

    def schedule(count: int) -> float:
        if count < warm:
            return base_lr + (peak - base_lr) * count / warm
        t = min(count - warm, rest)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / rest)) + alpha)

    return schedule


def _radam_scalars(b1: float, b2: float, t: int):
    """(ro, r, 1/(1-b1^t), 1/(1-b2^t)) of update ``t``. ``ro`` and ``r`` are
    formed in float32 in optax's order (``scale_by_radam``): at the first
    rectified steps ro - 4 ~ 1 is a difference of ~2000-sized terms, so the
    rounding of each f32 operation decides r to ~1%, and the port must round
    where optax does (b2^t correctly rounded, as XLA's pow is: taken in f64
    from the f32 base, then rounded once)."""
    f32 = np.float32
    b2t = f32(np.float64(f32(b2)) ** t)
    ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
    ro = ro_inf - f32(2 * t) * b2t / (f32(1.0) - b2t)
    r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * ro_inf
                / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)) if ro > 4.0 else f32(0.0)
    return float(ro), float(r), 1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)


class RAdam(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), radam(schedule))``: per update
    g += wd * p, then the rectified Adam step scaled by ``-schedule(t-1)``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(params, dict(weight_decay=weight_decay, betas=betas,
                                      eps=eps, threshold=threshold))
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            grads = [p.grad for p in ps]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, ps, alpha=group["weight_decay"])
            torch._foreach_lerp_(mus, grads, 1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            ro, r, mu_scale, nu_scale = _radam_scalars(b1, b2, t)
            if ro >= group["threshold"]:
                denom = torch._foreach_mul(nus, nu_scale)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_addcdiv_(ps, mus, denom, value=-lr * r * mu_scale)
            else:
                torch._foreach_add_(ps, mus, alpha=-lr * mu_scale)


def create_optimizer(params: Iterable[torch.Tensor], optim_params: Mapping,
                     scheduler_params: Optional[Mapping], *, max_epoch: int,
                     steps_per_epoch: int) -> Tuple[RAdam, Callable[[int], float]]:
    """(optimizer, schedule) from reference config sections
    ``Optim: {name, lr, weight_decay}`` and ``Scheduler: {multiplier,
    warmup_max}``; without a ``Scheduler`` a constant learning rate
    (optax's ``constant_schedule``, as the adversarial trainer's
    discriminator takes); RAdam only."""
    name = str(optim_params.get("name", "RAdam")).lower()
    if name != "radam":
        raise KeyError(f"optimizer '{name}' is not ported (radam only)")
    lr = float(optim_params.get("lr", 1e-7))
    if scheduler_params:
        schedule = warmup_schedule(
            base_lr=lr, multiplier=float(scheduler_params.get("multiplier", 300)),
            warmup_max_epoch=int(scheduler_params.get("warmup_max", 10)),
            max_epoch=max_epoch, steps_per_epoch=steps_per_epoch,
            name=str(scheduler_params.get("name", "cosine")).lower())
    else:
        def schedule(count: int) -> float:
            return lr
    opt = RAdam(params, schedule,
                weight_decay=float(optim_params.get("weight_decay", 0.0)))
    return opt, schedule
