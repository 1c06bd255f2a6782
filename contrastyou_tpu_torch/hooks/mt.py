"""Mean-teacher family: MT, uncertainty-aware MT (UAMT), interpolation
consistency (ICT), and the loss-free EMA eval model (counterpart of
contrastyou_tpu/hooks/mt.py).

The teacher is hook state, as in JAX: ``teacher_params`` and
``teacher_batch_stats`` (tensors keyed as the model's ``state_dict``, copies
made at init) and ``ema_step`` (an int64 tensor on the model's device,
advanced in place, so the EMA weight of each step is computed on the
device and a CUDA graph of several steps replays it; a state restored with
an int ``ema_step`` takes a tensor at its first EMA step). A teacher forward runs the
student's module on those tensors (``torch.func.functional_call``) under
``torch.no_grad``, so the teacher is never an optimizer parameter and a
resumed run's forward reads the restored tensors. The EMA update runs in
``post_step`` with ``torch._foreach_*`` ops over the tensor lists.

BN semantics (JAX ``_teacher_forward``):
- ``update_bn=False`` (default): the teacher normalizes with its own batch
  statistics (train-mode BN) and updates its own running statistics;
- ``update_bn=True``: the teacher runs eval-mode BN on its running
  statistics, which ``post_step`` EMAs from the student's.

Random draws are explicit: UAMT's noise and ICT's ``lam`` and permutation
come from :meth:`draw` (the step's generator, or the host generator, its
draws handed over as tensors) and reach ``loss`` through ``ctx.hook_draws``.

Data parallelism (``ctx.data_group`` of W > 1 ranks): every teacher forward
runs inside the step's data-parallel context, so its BatchNorm sums are the
global batch's and its running statistics move identically on every rank;
the EMA is of replicated parameters. MT's loss is a per-rank mean. UAMT's
noise is drawn at the global batch and cut along its batch axis (axis 1),
and its masked loss, a ratio of global means, is taken from sums
all-reduced over the ranks. ICT's permutation spans the global batch of
both views and stays whole on every rank: the mixed images and targets
take rows of other ranks (gathered), and each rank's student forward runs
on its own rows of the mixed global batch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..engine.hooks import StepContext, TrainerHook
from ..parallel.collectives import all_reduce_sum, gather_rows, num_ranks
from .utils import mixup_data, mixup_draw_tensors

__all__ = ["ema_update", "justified_alpha", "ema_step_tensor", "MeanTeacherTrainerHook", "EMAEvalTrainerHook",
           "UAMeanTeacherTrainerHook", "ICTMeanTeacherTrainerHook"]


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor], alpha,
               weight_decay: float = 0.0) -> None:
    """In place, JAX's order: ``e = e * alpha + (1 - alpha) * n``, then
    ``e *= 1 - weight_decay`` when it is positive; ``1 - alpha`` in f32.
    ``alpha`` is a float or an f32 scalar tensor (:func:`justified_alpha`
    of a tensor step)."""
    ema, new = list(ema), [n.detach() for n in new]
    if not ema:                      # a GroupNorm net has no running statistics
        return
    torch._foreach_mul_(ema, alpha)
    if isinstance(alpha, torch.Tensor):
        torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - alpha))
    else:
        torch._foreach_add_(ema, new, alpha=float(np.float32(1.0) - np.float32(alpha)))
    if weight_decay > 0:
        torch._foreach_mul_(ema, float(np.float32(1.0) - np.float32(weight_decay)))


def justified_alpha(step, alpha: float, justify: bool = True):
    """``min(1 - 1/(step + 1), alpha)`` in f32 (JAX's), or ``alpha``: a
    float of an int ``step``, an f32 scalar tensor of a tensor one (the
    same f32 operations)."""
    if not justify:
        return float(np.float32(alpha))
    if isinstance(step, torch.Tensor):
        # each f32 operation taken in f64 and rounded: the correctly rounded f32
        inv = (1.0 / (step.double() + 1.0).float().double()).float().double()
        return (1.0 - inv).float().clamp(max=float(np.float32(alpha)))
    one = np.float32(1.0)
    return float(min(one - one / (np.float32(step) + one), np.float32(alpha)))


def ema_step_tensor(state: dict, device) -> torch.Tensor:
    """The state's ``ema_step`` as an int64 tensor on ``device`` (an int one,
    from a restored checkpoint, becomes one)."""
    step = state["ema_step"]
    if not isinstance(step, torch.Tensor):
        step = state["ema_step"] = torch.tensor(int(step), dtype=torch.int64, device=device)
    return step


def _copies(model: torch.nn.Module):
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def _zero_step(model: torch.nn.Module) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=next(model.parameters()).device)


def _track(state: dict, model: torch.nn.Module, keys, alpha: float, weight_decay: float,
           stats_decay: Optional[float]) -> dict:
    """One EMA step of the hook state's ``keys`` = (parameters, statistics)
    towards ``model``'s; the statistics only when ``stats_decay`` is not
    None, with that weight decay."""
    params, stats = (state[k] for k in keys)
    current = dict(model.named_parameters())
    ema_update(params.values(), [current[k] for k in params], alpha, weight_decay)
    if stats_decay is not None:
        buffers = dict(model.named_buffers())
        ema_update(stats.values(), [buffers[k] for k in stats], alpha, stats_decay)
    state["ema_step"] += 1
    return state


class MeanTeacherTrainerHook(TrainerHook):
    data_parallel = True

    def __init__(self, *, name: str = "mt", weight: float = 1.0, alpha: float = 0.999,
                 weight_decay: float = 1e-5, update_bn: bool = False,
                 hard_clip: bool = False, justify_alpha: bool = True):
        super().__init__(hook_name=name, weight=weight)
        self._alpha = float(alpha)
        self._weight_decay = float(weight_decay)
        self._update_bn = bool(update_bn)
        self._hard_clip = bool(hard_clip)
        self._justify_alpha = bool(justify_alpha)

    def init_state(self, bundle) -> dict:
        params, stats = _copies(bundle.model)
        return {"teacher_params": params, "teacher_batch_stats": stats,
                "ema_step": _zero_step(bundle.model)}

    # --- teacher forward ----------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def _teacher_apply(ctx: StepContext, state, image: torch.Tensor, **kwargs) -> torch.Tensor:
        """Logits of the student's module on the teacher's tensors; train-mode
        BN updates the teacher's running statistics in place."""
        tensors = (state["teacher_params"], state["teacher_batch_stats"])
        return functional_call(ctx.bundle.model, tensors, (image,), kwargs)[0]

    def _teacher_forward(self, ctx: StepContext, state, image: torch.Tensor, *,
                         update_stats: bool = True) -> torch.Tensor:
        """Eval-mode BN with ``update_bn``, else train-mode BN that updates
        the teacher's running statistics unless ``update_stats`` is False."""
        if self._update_bn:
            return self._teacher_apply(ctx, state, image, train=False)
        return self._teacher_apply(ctx, state, image, train=True, update_stats=update_stats)

    def _teacher_target(self, ctx: StepContext, state) -> torch.Tensor:
        """The teacher's probabilities aligned to the transformed view."""
        logits = self._teacher_forward(ctx, state, ctx.unlabeled_image)
        prob_tf = torch.softmax(ctx.affine_transformer(logits), -1)
        if self._hard_clip:
            prob_tf = F.one_hot(prob_tf.argmax(-1), prob_tf.shape[-1]).float()
        return prob_tf

    def loss(self, ctx: StepContext, state):
        student_prob = torch.softmax(ctx.unlabeled_tf_logits, -1)
        teacher_prob_tf = self._teacher_target(ctx, state)
        return torch.mean((teacher_prob_tf - student_prob) ** 2), state, {}

    def post_step(self, ctx: StepContext, model: torch.nn.Module, state):
        """The teacher's EMA step: the statistics with ``update_bn``, with
        the weight decay as JAX's."""
        step = ema_step_tensor(state, next(model.parameters()).device)
        alpha = justified_alpha(step, self._alpha, self._justify_alpha)
        return _track(state, model, ("teacher_params", "teacher_batch_stats"), alpha,
                      self._weight_decay, self._weight_decay if self._update_bn else None)

    def eval_params(self, state) -> Optional[Dict[str, torch.Tensor]]:
        """The teacher evaluates (JAX ``MTTrainer``)."""
        return state["teacher_params"]

    def eval_batch_stats(self, state) -> Optional[Dict[str, torch.Tensor]]:
        return state["teacher_batch_stats"]


class EMAEvalTrainerHook(TrainerHook):
    """Loss-free EMA of the student, evaluated in its place
    (``EvalEMAParameters``). ``always_active``: it runs under trainers that
    drop the regularizer hooks (``ft``). The running statistics are EMA'd
    without weight decay with ``update_bn``; without it the eval model takes
    the student's."""

    requires_unlabeled = False
    always_active = True
    data_parallel = True

    def __init__(self, *, name: str = "ema_eval", alpha: float = 0.999,
                 weight_decay: float = 0.0, update_bn: bool = True, justify_alpha: bool = True):
        super().__init__(hook_name=name, weight=0.0)
        self._alpha = float(alpha)
        self._weight_decay = float(weight_decay)
        self._update_bn = bool(update_bn)
        self._justify_alpha = bool(justify_alpha)

    def init_state(self, bundle) -> dict:
        params, stats = _copies(bundle.model)
        return {"ema_params": params, "ema_batch_stats": stats,
                "ema_step": _zero_step(bundle.model)}

    def post_step(self, ctx: StepContext, model: torch.nn.Module, state):
        step = ema_step_tensor(state, next(model.parameters()).device)
        alpha = justified_alpha(step, self._alpha, self._justify_alpha)
        return _track(state, model, ("ema_params", "ema_batch_stats"), alpha,
                      self._weight_decay, 0.0 if self._update_bn else None)

    def eval_params(self, state) -> Optional[Dict[str, torch.Tensor]]:
        return state["ema_params"]

    def eval_batch_stats(self, state) -> Optional[Dict[str, torch.Tensor]]:
        return state["ema_batch_stats"] if self._update_bn else None


class UAMeanTeacherTrainerHook(MeanTeacherTrainerHook):
    """Uncertainty-aware MT: the teacher target is the mean of one clean and
    ``num_noise`` noisy passes; the per-pixel loss is masked where the
    target's entropy exceeds a threshold ramped with ``ctx.epoch /
    max_epoch``. The clean pass updates the teacher's running statistics,
    the noisy ones do not; each noisy pass normalizes over its own batch
    (JAX's per-pass loop, numerically its ``bn_groups`` forward)."""

    #: the noise [num_noise, B, H, W, 1]: its batch axis is the second
    draw_batch_dim = 1

    def __init__(self, *, name: str = "uamt", weight: float = 1.0, alpha: float = 0.999,
                 weight_decay: float = 1e-5, update_bn: bool = False, hard_clip: bool = False,
                 num_noise: int = 4, noise_std: float = 0.05, max_epoch: int = 100):
        super().__init__(name=name, weight=weight, alpha=alpha, weight_decay=weight_decay,
                         update_bn=update_bn, hard_clip=hard_clip)
        self._num_noise = int(num_noise)
        self._noise_std = float(noise_std)
        self._max_epoch = int(max_epoch)

    def draw(self, generator: torch.Generator, host_rng, shape) -> torch.Tensor:
        """The noise [num_noise, *shape] of the unlabeled batch's shape."""
        return torch.randn((self._num_noise, *shape), generator=generator,
                           device=generator.device)

    def loss(self, ctx: StepContext, state):
        image = ctx.unlabeled_image
        noise = ctx.hook_draws[self.name]
        C = ctx.unlabeled_tf_logits.shape[-1]
        clean = self._teacher_forward(ctx, state, image)
        # train-mode BN whatever update_bn, as JAX's noisy passes
        noisy = [self._teacher_apply(ctx, state, image + self._noise_std * noise[i],
                                     train=True, update_stats=False)
                 for i in range(self._num_noise)]
        mean_logits = (clean + torch.stack(noisy).sum(0)) / (self._num_noise + 1)
        prob_tf = torch.softmax(ctx.affine_transformer(mean_logits), -1)
        entropy_tf = -(prob_tf * torch.log(prob_tf + 1e-16)).sum(-1)
        if self._hard_clip:
            prob_tf = F.one_hot(prob_tf.argmax(-1), C).float()
        student_prob = torch.softmax(ctx.unlabeled_tf_logits, -1)
        per_px = ((prob_tf - student_prob) ** 2).mean(-1)
        # f32 as JAX: ramp = f32(epoch) / max_epoch, threshold in f32
        ramp = np.float32(ctx.epoch) / np.float32(self._max_epoch)
        threshold = np.float32(0.75 * math.log(C)) + np.float32(0.25 * math.log(C)) * ramp
        mask = (entropy_tf < float(threshold)).float()
        # a ratio of the global batch's means, from the numerator's and the
        # denominator's sums over the ranks: under a data-parallel group every
        # rank computes the global ratio and the step back-propagates 1/W
        group = ctx.data_group
        num, den = (all_reduce_sum(torch.stack([(per_px * mask).sum(), mask.sum()]), group)
                    / (per_px.numel() * num_ranks(group))).unbind(0)
        return num / (den + 1e-2), state, {"mask": den}


class ICTMeanTeacherTrainerHook(MeanTeacherTrainerHook):
    """Interpolation consistency: the teacher's probabilities of both
    unlabeled views and the views themselves mixed with one ``lam`` and
    permutation; the student's forward of the mixed images (with gradient,
    its BN running statistics left alone) matches the mixed target. The
    teacher's second pass does not update its statistics (JAX discards
    them)."""

    #: ``lam`` and a permutation of the global batch's 2B images: whole on
    #: every rank
    draw_batch_dim = None

    def __init__(self, *, name: str = "ict", weight: float = 1.0, alpha: float = 0.999,
                 weight_decay: float = 1e-5, update_bn: bool = False, mix_alpha: float = 0.2):
        super().__init__(name=name, weight=weight, alpha=alpha, weight_decay=weight_decay,
                         update_bn=update_bn)
        self._mix_alpha = float(mix_alpha)

    def draw(self, generator: torch.Generator, host_rng: np.random.Generator, shape):
        """``(lam, perm)`` over the 2B images of both views, drawn on the
        host, as tensors on the generator's device."""
        if host_rng is None:
            raise ValueError(f"{self.name}: the mixup draws need a host generator")
        return mixup_draw_tensors(host_rng, 2 * int(shape[0]), self._mix_alpha,
                                  generator.device)

    def loss(self, ctx: StepContext, state):
        lam, perm = ctx.hook_draws[self.name]
        t_logits_1 = self._teacher_forward(ctx, state, ctx.unlabeled_image)
        t_logits_2 = self._teacher_forward(ctx, state, ctx.unlabeled_image_tf,
                                           update_stats=False)
        views = (ctx.unlabeled_image, ctx.unlabeled_image_tf)
        group, rows = ctx.data_group, None
        if group is not None:
            # the global batch of both views in the one-process order (every
            # first view, then every second) and this rank's rows of it
            b = ctx.unlabeled_image.shape[0]
            B, r = b * group.size, group.rank
            rows = [*range(r * b, (r + 1) * b), *range(B + r * b, B + (r + 1) * b)]
            views = tuple(gather_rows(v.detach(), group) for v in views)
            t_logits_1, t_logits_2 = (gather_rows(v, group) for v in (t_logits_1, t_logits_2))
        t_prob = torch.softmax(torch.cat([t_logits_1, t_logits_2], 0), -1)
        images = torch.cat(views, 0)
        mixed_x, mixed_y = mixup_data(images.detach(), t_prob, lam, perm, rows=rows)
        s_logits = ctx.bundle.apply_train(mixed_x, update_stats=False)[0]
        loss = torch.mean((torch.softmax(s_logits, -1) - mixed_y) ** 2)
        return loss, state, {}
