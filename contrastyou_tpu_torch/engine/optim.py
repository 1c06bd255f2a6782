"""Optimizers and learning-rate schedules (counterpart of
contrastyou_tpu/engine/optim.py, which builds them from optax).

Written out by hand to reproduce optax's arithmetic, with explicit
``torch._foreach_*`` updates and host scalars:

- ``radam`` (the default) differs from ``torch.optim.RAdam``: eps is added
  outside the square root of the bias-corrected second moment, the
  rectification threshold is ro >= 5 (torch uses > 5), and an unrectified
  step applies the bias-corrected first moment with no other scaling;
- ``adam`` (eps 1e-8, ``eps_root`` 0) and ``sgd`` (no momentum) take a
  coupled L2 term ``g += wd * p`` before the update when ``weight_decay`` is
  set (``optax.add_decayed_weights`` chained before them), ``adamw`` the
  decoupled one inside (``-lr * (adam + wd * p)``) and no coupled term;
- the learning rate of update ``t`` is the schedule at ``t - 1`` (optax
  counts from 0): a linear warmup into ``cosine``, ``poly`` or ``step``;
- ``accumulate_iter = k > 1`` is ``optax.MultiSteps``: each call folds its
  gradients into their running mean, and every k-th call applies the inner
  update to that mean; the calls in between change no parameter. The inner
  count, and so the schedule, advances once per k calls, as in JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["warmup_schedule", "OptaxOptimizer", "RAdam", "Adam", "SGD", "OPTIMIZERS",
           "create_optimizer"]


def warmup_schedule(*, base_lr: float, multiplier: float, warmup_max_epoch: int,
                    max_epoch: int, steps_per_epoch: int, eta_min: float = 1e-7,
                    name: str = "cosine", power: float = 0.9,
                    milestones: Sequence = (), gamma: float = 0.1) -> Callable[[int], float]:
    """lr ramps linearly base_lr -> base_lr*multiplier over the warmup
    epochs (the reference GradualWarmupScheduler), then, counted in steps
    from the end of the warmup:

    - ``cosine``: anneals to eta_min over the rest;
    - ``poly``: ``optax.polynomial_schedule`` from the peak to eta_min over
      the rest, ``(peak - eta_min) * (1 - t/T)^power + eta_min``;
    - ``step``: ``optax.piecewise_constant_schedule``: the peak times
      ``gamma`` for each milestone passed, milestones in epochs from the
      start of training, one clamped to the warmup join multiplying in its
      gamma there too."""
    peak = base_lr * multiplier
    warm = max(warmup_max_epoch * steps_per_epoch, 1)
    rest = max((max_epoch - warmup_max_epoch) * steps_per_epoch, 1)
    if name == "cosine":
        alpha = eta_min / max(peak, 1e-30)

        def after(t: int) -> float:
            t = min(t, rest)
            return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / rest)) + alpha)
    elif name == "poly":
        def after(t: int) -> float:
            frac = 1.0 - min(max(t, 0), rest) / rest
            return (peak - eta_min) * frac ** power + eta_min
    elif name == "step":
        bounds: dict = {}
        for m in milestones:
            k = max(int(m) - warmup_max_epoch, 0) * steps_per_epoch
            bounds[k] = bounds.get(k, 1.0) * gamma

        def after(t: int) -> float:
            v = peak
            for k in sorted(bounds):
                if t >= k:
                    v *= bounds[k]
            return v
    else:
        raise KeyError(f"scheduler '{name}' not in (cosine, poly, step)")

    def schedule(count: int) -> float:
        if count < warm:
            return base_lr + (peak - base_lr) * count / warm
        return after(count - warm)

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


def _eager(method):
    """``torch.optim.Optimizer``'s ``method`` without its
    ``torch._dynamo.disable`` wrapper, whose first call imports
    ``torch._dynamo`` (11.45 s a process on the H100 machine, measured by
    ``python -c "import torch._dynamo"`` there); the port compiles nothing,
    so in eager mode the wrapper changes nothing else."""
    return getattr(method, "__wrapped__", method)


class OptaxOptimizer(torch.optim.Optimizer):
    """An optax-style optimizer: :meth:`step` runs ``_update(lr, t, group,
    params, grads)`` with ``lr = schedule(t - 1)`` on update ``t``, after
    the MultiSteps accumulation when ``accumulate > 1``. ``count`` (the
    inner updates made) and ``mini_step`` (the calls folded since the last
    one) travel with :meth:`state_dict`."""

    add_param_group = _eager(torch.optim.Optimizer.add_param_group)
    zero_grad = _eager(torch.optim.Optimizer.zero_grad)

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 defaults: dict, accumulate: int = 1):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.accumulate = int(accumulate)
        if self.accumulate < 1:
            raise ValueError(f"accumulate_iter={accumulate}: at least 1")
        self.count = 0
        self.mini_step = 0

    def _moments(self, ps, *names):
        for p in ps:
            for n in names:
                if n not in self.state[p]:
                    self.state[p][n] = torch.zeros_like(p)
        return [[self.state[p][n] for p in ps] for n in names]

    @torch.no_grad()
    def step(self, closure=None):
        groups = []
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                groups.append((group, ps, [p.grad for p in ps]))
        if self.accumulate > 1:
            # optax.MultiSteps: acc += (g - acc) / (mini_step + 1)
            for group, ps, grads in groups:
                for p in ps:
                    self.state[p].setdefault("acc", torch.zeros_like(p))
                accs = [self.state[p]["acc"] for p in ps]
                torch._foreach_add_(accs, torch._foreach_sub(grads, accs),
                                    alpha=1.0 / (self.mini_step + 1))
            if self.mini_step < self.accumulate - 1:
                self.mini_step += 1
                return
            self.mini_step = 0
        lr = self.schedule(self.count)
        self.count += 1
        for group, ps, grads in groups:
            if self.accumulate > 1:
                grads = [self.state[p]["acc"] for p in ps]
            self._update(lr, self.count, group, ps, grads)
            if self.accumulate > 1:
                torch._foreach_zero_(grads)

    def _update(self, lr: float, t: int, group: dict, ps, grads) -> None:
        raise NotImplementedError

    def state_dict(self):
        sd = _eager(torch.optim.Optimizer.state_dict)(self)
        sd["count"], sd["mini_step"] = self.count, self.mini_step
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", self.count))
        self.mini_step = int(state_dict.pop("mini_step", 0))
        _eager(torch.optim.Optimizer.load_state_dict)(self, state_dict)


def _coupled_decay(group: dict, ps, grads):
    """``optax.add_decayed_weights`` before the update: g + wd * p."""
    wd = group["weight_decay"]
    return torch._foreach_add(grads, ps, alpha=wd) if wd else grads


class RAdam(OptaxOptimizer):
    """``optax.chain(add_decayed_weights(wd), radam(schedule))``: per update
    g += wd * p, then the rectified Adam step scaled by ``-schedule(t-1)``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0, accumulate: int = 1):
        super().__init__(params, schedule, dict(weight_decay=weight_decay, betas=betas,
                                                eps=eps, threshold=threshold), accumulate)

    def _update(self, lr, t, group, ps, grads):
        b1, b2 = group["betas"]
        mus, nus = self._moments(ps, "mu", "nu")
        grads = _coupled_decay(group, ps, grads)
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


class Adam(OptaxOptimizer):
    """``optax.adam`` (eps 1e-8, ``eps_root`` 0): ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)``. ``decoupled`` (``optax.adamw``) adds ``wd * p``
    to that update before the learning rate scales it; otherwise
    ``weight_decay`` is the coupled L2 term ``g += wd * p``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                 decoupled: bool = False, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, accumulate: int = 1):
        super().__init__(params, schedule, dict(weight_decay=weight_decay, betas=betas,
                                                eps=eps, decoupled=decoupled), accumulate)

    def _update(self, lr, t, group, ps, grads):
        b1, b2 = group["betas"]
        mus, nus = self._moments(ps, "mu", "nu")
        if not group["decoupled"]:
            grads = _coupled_decay(group, ps, grads)
        torch._foreach_lerp_(mus, grads, 1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_mul(nus, 1.0 / (1.0 - b2 ** t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(torch._foreach_mul(mus, 1.0 / (1.0 - b1 ** t)), denom)
        if group["decoupled"] and group["weight_decay"]:
            torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
        torch._foreach_add_(ps, upd, alpha=-lr)


class SGD(OptaxOptimizer):
    """``optax.sgd`` without momentum: ``p -= lr * g`` (after the coupled
    L2 term when ``weight_decay`` is set)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], *, weight_decay: float = 0.0,
                 accumulate: int = 1):
        super().__init__(params, schedule, dict(weight_decay=weight_decay), accumulate)

    def _update(self, lr, t, group, ps, grads):
        torch._foreach_add_(ps, _coupled_decay(group, ps, grads), alpha=-lr)


#: ``Optim.name`` (lower-cased) -> (class, its keyword arguments)
OPTIMIZERS = {"radam": (RAdam, {}), "adam": (Adam, {}), "adamw": (Adam, {"decoupled": True}),
              "sgd": (SGD, {})}


def create_optimizer(params: Iterable[torch.Tensor], optim_params: Mapping,
                     scheduler_params: Optional[Mapping], *, max_epoch: int,
                     steps_per_epoch: int, accumulate_iter: int = 1
                     ) -> Tuple[OptaxOptimizer, Callable[[int], float]]:
    """(optimizer, schedule) from reference config sections
    ``Optim: {name, lr, weight_decay}`` and ``Scheduler: {name, multiplier,
    warmup_max, power, milestones, gamma}``; without a ``Scheduler`` a
    constant learning rate (optax's ``constant_schedule``, as the
    adversarial trainer's discriminator takes). ``accumulate_iter``: see the
    module docstring."""
    name = str(optim_params.get("name", "RAdam")).lower()
    if name not in OPTIMIZERS:
        raise KeyError(f"optimizer '{name}' not in {tuple(OPTIMIZERS)}")
    lr = float(optim_params.get("lr", 1e-7))
    if scheduler_params:
        schedule = warmup_schedule(
            base_lr=lr, multiplier=float(scheduler_params.get("multiplier", 300)),
            warmup_max_epoch=int(scheduler_params.get("warmup_max", 10)),
            max_epoch=max_epoch, steps_per_epoch=steps_per_epoch,
            name=str(scheduler_params.get("name", "cosine")).lower(),
            power=float(scheduler_params.get("power", 0.9)),
            milestones=tuple(scheduler_params.get("milestones", ())),
            gamma=float(scheduler_params.get("gamma", 0.1)))
    else:
        def schedule(count: int) -> float:
            return lr
    cls, kw = OPTIMIZERS[name]
    opt = cls(params, schedule, weight_decay=float(optim_params.get("weight_decay", 0.0)),
              accumulate=accumulate_iter, **kw)
    return opt, schedule
