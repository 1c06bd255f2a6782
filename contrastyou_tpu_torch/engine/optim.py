"""Optimizers and learning-rate schedules (counterpart of
contrastyou_tpu/engine/optim.py, which builds them from optax).

Written out by hand to reproduce optax's arithmetic, with explicit
``torch._foreach_*`` updates. Every per-update scalar (the learning rate,
RAdam's ro and r, the bias corrections, MultiSteps' accumulation weight)
is a device tensor computed from the device update count, and every branch
(RAdam's rectification, MultiSteps' accumulate-or-apply) a device select,
as in optax: a step reads nothing back to the host, so a CUDA graph of
several steps replays each update's own scalars
(``engine/graph.py``):

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

The host forms (a schedule called with an int, :func:`_radam_scalars`)
stay for the host's readers (the epoch's ``lr`` statistic) and as the
reference the device forms are held to, bit for bit in f32.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Schedule", "ConstantSchedule", "WarmupSchedule", "warmup_schedule", "OptaxOptimizer", "RAdam", "Adam", "SGD", "OPTIMIZERS",
           "create_optimizer"]


class Schedule:
    """A learning-rate schedule: ``schedule(count)`` on the host (Python
    floats), ``schedule.tensor(count)`` on the device (``count`` an int64
    tensor, the result float64), the same arithmetic in the same order."""

    def __call__(self, count: int) -> float:
        raise NotImplementedError

    def tensor(self, count: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ConstantSchedule(Schedule):
    """optax's ``constant_schedule``."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def __call__(self, count: int) -> float:
        return self.lr

    def tensor(self, count: torch.Tensor) -> torch.Tensor:
        return torch.full_like(count, self.lr, dtype=torch.float64)


class WarmupSchedule(Schedule):
    """:func:`warmup_schedule`'s schedule."""

    def __init__(self, *, base_lr: float, multiplier: float, warmup_max_epoch: int,
                 max_epoch: int, steps_per_epoch: int, eta_min: float, name: str,
                 power: float, milestones: Sequence, gamma: float):
        if name not in ("cosine", "poly", "step"):
            raise KeyError(f"scheduler '{name}' not in (cosine, poly, step)")
        self.name, self.base_lr, self.eta_min, self.power = name, base_lr, eta_min, power
        self.peak = base_lr * multiplier
        self.warm = max(warmup_max_epoch * steps_per_epoch, 1)
        self.rest = max((max_epoch - warmup_max_epoch) * steps_per_epoch, 1)
        self.alpha = eta_min / max(self.peak, 1e-30)
        self.bounds: dict = {}
        for m in milestones:
            k = max(int(m) - warmup_max_epoch, 0) * steps_per_epoch
            self.bounds[k] = self.bounds.get(k, 1.0) * gamma

    def _after(self, t: int) -> float:
        peak, rest = self.peak, self.rest
        if self.name == "cosine":
            t = min(t, rest)
            return peak * ((1 - self.alpha) * 0.5 * (1 + math.cos(math.pi * t / rest))
                           + self.alpha)
        if self.name == "poly":
            frac = 1.0 - min(max(t, 0), rest) / rest
            return (peak - self.eta_min) * frac ** self.power + self.eta_min
        v = peak
        for k in sorted(self.bounds):
            if t >= k:
                v *= self.bounds[k]
        return v

    def __call__(self, count: int) -> float:
        if count < self.warm:
            return self.base_lr + (self.peak - self.base_lr) * count / self.warm
        return self._after(count - self.warm)

    def tensor(self, count: torch.Tensor) -> torch.Tensor:
        c = count.double()
        peak, rest = self.peak, self.rest
        t = c - self.warm
        if self.name == "cosine":
            t = t.clamp(max=rest)
            after = peak * ((1 - self.alpha) * 0.5 * (1 + torch.cos(math.pi * t / rest))
                            + self.alpha)
        elif self.name == "poly":
            frac = 1.0 - t.clamp(0, rest) / rest
            after = (peak - self.eta_min) * frac ** self.power + self.eta_min
        else:
            after = torch.full_like(c, peak)
            for k in sorted(self.bounds):
                after = torch.where(t >= k, after * self.bounds[k], after)
        warm = self.base_lr + (self.peak - self.base_lr) * c / self.warm
        return torch.where(c < self.warm, warm, after)


def warmup_schedule(*, base_lr: float, multiplier: float, warmup_max_epoch: int,
                    max_epoch: int, steps_per_epoch: int, eta_min: float = 1e-7,
                    name: str = "cosine", power: float = 0.9,
                    milestones: Sequence = (), gamma: float = 0.1) -> WarmupSchedule:
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
    return WarmupSchedule(base_lr=base_lr, multiplier=multiplier,
                          warmup_max_epoch=warmup_max_epoch, max_epoch=max_epoch,
                          steps_per_epoch=steps_per_epoch, eta_min=eta_min, name=name,
                          power=power, milestones=milestones, gamma=gamma)


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


def _radam_tensors(b1: float, b2: float, t: torch.Tensor):
    """:func:`_radam_scalars` on the device, from the update index ``t``
    (int64): ro and r in the same f32 operations and order, each taken in
    f64 and rounded to f32 (for + - * / and sqrt that is the correctly
    rounded f32 result, which a backend's own f32 sqrt need not give); the
    bias corrections f64."""
    def f32(x: torch.Tensor) -> torch.Tensor:
        return x.float().double()

    tf = t.double()
    b2t = f32(torch.pow(float(np.float32(b2)), tf))
    ro_inf = float(np.float32(2.0 / (1.0 - b2) - 1.0))
    den = float(np.float32((np.float32(ro_inf) - 4.0) * (np.float32(ro_inf) - 2.0)))
    ro = f32(ro_inf - f32(f32(2.0 * tf * b2t) / f32(1.0 - b2t)))
    q = f32(f32(f32(f32(ro - 4.0) * f32(ro - 2.0)) * ro_inf) / f32(den * ro))
    r = torch.where(ro > 4.0, f32(torch.sqrt(q)), 0.0)
    return ro.float(), r.float(), 1.0 / (1.0 - torch.pow(b1, tf)), 1.0 / (1.0 - torch.pow(b2, tf))


def _eager(method):
    """``torch.optim.Optimizer``'s ``method`` without its
    ``torch._dynamo.disable`` wrapper, whose first call imports
    ``torch._dynamo`` (11.45 s a process on the H100 machine, measured by
    ``python -c "import torch._dynamo"`` there); the port compiles nothing,
    so in eager mode the wrapper changes nothing else."""
    return getattr(method, "__wrapped__", method)


class OptaxOptimizer(torch.optim.Optimizer):
    """An optax-style optimizer: :meth:`step` runs ``_update(lr, t, group,
    params, grads)`` with ``lr = schedule(t - 1)`` on update ``t`` (both
    device tensors), after the MultiSteps accumulation when ``accumulate >
    1``. ``count`` (the inner updates made) and ``mini_step`` (the calls
    folded since the last one) are int64 tensors on the parameters' device,
    read as ints, and travel with :meth:`state_dict` as ints. ``lr`` is the
    last update's learning rate (a float64 tensor)."""

    add_param_group = _eager(torch.optim.Optimizer.add_param_group)
    zero_grad = _eager(torch.optim.Optimizer.zero_grad)
    #: the per-parameter state an update changes
    moments: Tuple[str, ...] = ("mu", "nu")

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 defaults: dict, accumulate: int = 1):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.accumulate = int(accumulate)
        if self.accumulate < 1:
            raise ValueError(f"accumulate_iter={accumulate}: at least 1")
        self._counters = {"count": 0, "mini_step": 0}
        self.lr: Optional[torch.Tensor] = None

    def _counter(self, name: str, device) -> torch.Tensor:
        """The counter ``name`` as an int64 tensor on ``device`` (made, or
        moved, there at the first update)."""
        c = self._counters[name]
        if not isinstance(c, torch.Tensor) or c.device != torch.device(device):
            c = self._counters[name] = torch.tensor(int(c), dtype=torch.int64, device=device)
        return c

    def _set_counter(self, name: str, value: int) -> None:
        c = self._counters[name]
        if isinstance(c, torch.Tensor):
            c.fill_(int(value))
        else:
            self._counters[name] = int(value)

    count = property(lambda self: int(self._counters["count"]),
                     lambda self, v: self._set_counter("count", v))
    mini_step = property(lambda self: int(self._counters["mini_step"]),
                         lambda self, v: self._set_counter("mini_step", v))

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
        if not groups:
            return
        device = groups[0][1][0].device
        count = self._counter("count", device)
        apply = None
        if self.accumulate > 1:
            # optax.MultiSteps: acc += (g - acc) / (mini_step + 1); the inner
            # update on the k-th call, selected on the device
            mini = self._counter("mini_step", device)
            weight = (1.0 / (mini.double() + 1.0)).float()
            for group, ps, grads in groups:
                accs = self._moments(ps, "acc")[0]
                diff = torch._foreach_sub(grads, accs)
                torch._foreach_mul_(diff, weight)
                torch._foreach_add_(accs, diff)
            apply = mini == self.accumulate - 1
        lr = self.schedule.tensor(count)
        t = count + 1
        for group, ps, grads in groups:
            if apply is None:
                self._update(lr, t, group, ps, grads)
                continue
            accs = self._moments(ps, "acc")[0]
            self._moments(ps, *self.moments)
            kept = [v for p in ps for v in self.state[p].values()] + list(ps)
            before = [v.clone() for v in kept]
            self._update(lr, t, group, ps, accs)
            for v, b in zip(kept, before):
                v.copy_(torch.where(apply, v, b))
            torch._foreach_mul_(accs, (~apply).to(accs[0].dtype))
        self.lr = lr
        if apply is None:
            count.add_(1)
        else:
            count.add_(apply.long())
            mini.copy_(torch.where(apply, 0, mini + 1))

    def _update(self, lr: torch.Tensor, t: torch.Tensor, group: dict, ps, grads) -> None:
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


def _scaled_add_(ps, upd, scale: torch.Tensor) -> None:
    """``p += scale * u`` with a device scalar, rounded after the product."""
    torch._foreach_mul_(upd, scale.to(ps[0].dtype))
    torch._foreach_add_(ps, upd)


class RAdam(OptaxOptimizer):
    """``optax.chain(add_decayed_weights(wd), radam(schedule))``: per update
    g += wd * p, then the rectified Adam step scaled by ``-schedule(t-1)``.
    Both branches of the rectification are formed and one is selected on
    the device: the denominator is ``sqrt(nu_hat) + eps`` or exactly 1, the
    scale ``-lr * r * mu_scale`` or ``-lr * mu_scale``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Schedule, *, weight_decay: float = 0.0,
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
        ro, r, mu_scale, nu_scale = _radam_tensors(b1, b2, t)
        rect = ro >= group["threshold"]
        dtype = ps[0].dtype
        denom = torch._foreach_mul(nus, nu_scale.to(dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        # rectified: denom * 1 + 0; not: denom * 0 + 1 (exact either way); a
        # device scalar is added as a list (the Tensor overload reads it back)
        torch._foreach_mul_(denom, rect.to(dtype))
        torch._foreach_add_(denom, [(~rect).to(dtype)] * len(denom))
        upd = torch._foreach_div(mus, denom)
        _scaled_add_(ps, upd, torch.where(rect, -lr * r.double() * mu_scale, -lr * mu_scale))


class Adam(OptaxOptimizer):
    """``optax.adam`` (eps 1e-8, ``eps_root`` 0): ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)``. ``decoupled`` (``optax.adamw``) adds ``wd * p``
    to that update before the learning rate scales it; otherwise
    ``weight_decay`` is the coupled L2 term ``g += wd * p``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Schedule, *, weight_decay: float = 0.0,
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
        tf, dtype = t.double(), ps[0].dtype
        denom = torch._foreach_mul(nus, (1.0 / (1.0 - torch.pow(b2, tf))).to(dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(
            torch._foreach_mul(mus, (1.0 / (1.0 - torch.pow(b1, tf))).to(dtype)), denom)
        if group["decoupled"] and group["weight_decay"]:
            torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
        _scaled_add_(ps, upd, -lr)


class SGD(OptaxOptimizer):
    """``optax.sgd`` without momentum: ``p -= lr * g`` (after the coupled
    L2 term when ``weight_decay`` is set)."""

    moments = ()

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Schedule, *, weight_decay: float = 0.0,
                 accumulate: int = 1):
        super().__init__(params, schedule, dict(weight_decay=weight_decay), accumulate)

    def _update(self, lr, t, group, ps, grads):
        wd = group["weight_decay"]
        upd = torch._foreach_add(grads, ps, alpha=wd) if wd else [g.clone() for g in grads]
        _scaled_add_(ps, upd, -lr)


#: ``Optim.name`` (lower-cased) -> (class, its keyword arguments)
OPTIMIZERS = {"radam": (RAdam, {}), "adam": (Adam, {}), "adamw": (Adam, {"decoupled": True}),
              "sgd": (SGD, {})}


def create_optimizer(params: Iterable[torch.Tensor], optim_params: Mapping,
                     scheduler_params: Optional[Mapping], *, max_epoch: int,
                     steps_per_epoch: int, accumulate_iter: int = 1
                     ) -> Tuple[OptaxOptimizer, Schedule]:
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
        schedule = ConstantSchedule(lr)
    cls, kw = OPTIMIZERS[name]
    opt = cls(params, schedule, weight_decay=float(optim_params.get("weight_decay", 0.0)),
              accumulate=accumulate_iter, **kw)
    return opt, schedule
