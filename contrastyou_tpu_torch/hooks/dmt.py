"""Differentiable mean teacher (DMT; counterpart of
contrastyou_tpu/hooks/dmt.py): a mean teacher that is also optimized on the
labeled meta objective, by one of six update rules (``method_name``):

- ``mt``: the plain EMA teacher;
- ``method1``: consistency against teacher_t; after the step the teacher
  takes an Adam step from teacher_t along the meta gradient at
  EMA(teacher_t, student_t+1);
- ``method2``: the consistency target comes from the teacher moved by
  ``-meta_weight`` x its meta gradient (eval mode); EMA after the step;
- ``method3``: the teacher is EMA(teacher, student) plus an Adam step along
  the meta gradient taken there;
- ``method4``: the teacher's forward at t updates its statistics, an Adam
  step along the meta gradient (eval mode) gives the t+1 teacher that makes
  this batch's target; the kept teacher stays at t and is EMA'd;
- ``second_order``: the meta loss of the teacher EMA'd towards the
  student's virtual SGD step is differentiated back through that step, so
  the student's gradient carries a Hessian-vector term.

The teacher is hook state as in hooks/mt.py (``teacher_params``,
``teacher_batch_stats``, ``ema_step``); its forwards run the student's
module on those tensors (``torch.func.functional_call``), and train-mode
forwards that update statistics write the teacher's in place. The teacher's
optimizer is optax's ``chain(add_decayed_weights(1e-5), adam(meta_weight))``
written out by hand (:func:`adam_step`): its moments and update count are
the state's ``teacher_opt`` (``mu``, ``nu``: dicts keyed as the parameters;
``count``: an int64 tensor, as ``ema_step``), so checkpoints carry them.
Every update of the state is in place and its scalars are computed on the
device, so a CUDA graph of several steps replays them.

``second_order`` takes the inner gradient with ``create_graph=True`` over
the student's parameters (those of ``ctx.bundle.model``): on the card it goes through the
conv-block kernels' differentiable backward (ops/convblock.py), and the
hook raises if a gradient comes back without a graph (a backward that
dropped the second-order term).

On W > 1 ranks (``ctx.data_group``; the step runs the hook, ``post_step``
too, inside ``parallel.data_parallel``) every gradient the hook takes is
the global batch's: the teacher's meta gradients and ``second_order``'s
inner gradient are gradients of this rank's 1/W share of the loss, summed
over the ranks (``parallel.sum_over_ranks``; the inner one through its
differentiable all-reduce, so the Hessian-vector term spans the ranks),
and the teachers' train-mode forwards take global BatchNorm sums. So the
teacher, its statistics and ``teacher_opt`` stay bitwise equal on the
ranks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..engine.hooks import StepContext, TrainerHook
from ..losses.dice import dice_loss
from ..losses.kl import kl_div
from ..parallel.collectives import num_ranks, sum_over_ranks
from .mt import _copies, _zero_step, ema_step_tensor, ema_update, justified_alpha

__all__ = ["DifferentiableMeanTeacherTrainerHook", "METHODS", "adam_init", "adam_step"]

METHODS = ("mt", "method1", "method2", "method3", "method4", "second_order")
#: the teacher optimizer's weight decay (JAX hard-codes it, whatever ``weight_decay``)
TEACHER_DECAY = 1e-5

Tensors = Dict[str, torch.Tensor]


def adam_init(params: Mapping[str, torch.Tensor]) -> dict:
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int64, device=device)}


@torch.no_grad()
def adam_step(grads: Mapping[str, torch.Tensor], opt: dict, params: Mapping[str, torch.Tensor],
              lr: float, *, decay: float = TEACHER_DECAY, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> Tensors:
    """One update of ``optax.chain(add_decayed_weights(decay), adam(lr))``
    in optax's order: g += decay * params; mu = (1 - b1) g + b1 mu; nu =
    (1 - b2) g^2 + b2 nu; the step -lr * mu_hat / (sqrt(nu_hat) + eps) with
    the bias corrections of the incremented count (in f32, as JAX; of a
    tensor count on the device, b^count taken in f64 from the f32 base and
    rounded once). ``opt`` is updated in place; -> ``params`` plus the step,
    new tensors."""
    keys = list(params)
    g = torch._foreach_add([grads[k] for k in keys], [params[k] for k in keys], alpha=decay)
    mus, nus = [opt["mu"][k] for k in keys], [opt["nu"][k] for k in keys]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, g, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, g, g, value=1.0 - b2)
    opt["count"] += 1
    f32, count = np.float32, opt["count"]
    if isinstance(count, torch.Tensor):
        # device scalars go in as lists (the Tensor overload reads one back)
        bc1, bc2 = ([1.0 - torch.pow(float(f32(b)), count.double()).float()] * len(keys)
                    for b in (b1, b2))
    else:
        bc1 = float(f32(1.0) - f32(b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(count))
    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mus, bc1)
    torch._foreach_div_(step, denom)
    out = torch._foreach_add([params[k] for k in keys], step, alpha=-lr)
    return dict(zip(keys, out))


class DifferentiableMeanTeacherTrainerHook(TrainerHook):
    data_parallel = True

    def __init__(self, *, name: str = "dmt", weight: float = 1.0, alpha: float = 0.999,
                 weight_decay: float = 1e-5, meta_weight: float = 1e-3,
                 meta_criterion: str = "ce", method_name: str = "method1"):
        super().__init__(hook_name=name, weight=weight)
        if method_name not in METHODS:
            raise ValueError(f"method_name {method_name!r}: one of {METHODS}")
        if meta_criterion not in ("ce", "dice"):
            raise ValueError(f"meta_criterion {meta_criterion!r}: ce or dice")
        self._alpha = float(alpha)
        self._weight_decay = float(weight_decay)
        self._meta_weight = float(meta_weight)
        self._meta_criterion = meta_criterion
        self._method = method_name

    def init_state(self, bundle) -> dict:
        params, stats = _copies(bundle.model)
        state = {"teacher_params": params, "teacher_batch_stats": stats,
                 "ema_step": _zero_step(bundle.model)}
        if self._method in ("method1", "method3", "method4"):
            state["teacher_opt"] = adam_init(params)
        return state

    # --- pieces -------------------------------------------------------------
    @staticmethod
    def _apply(ctx: StepContext, params: Mapping, stats: Mapping, image: torch.Tensor, *,
               train: bool, update_stats: bool = True) -> torch.Tensor:
        """Logits of the student's module on ``params`` and ``stats``; a
        train-mode forward with ``update_stats`` updates ``stats`` in place."""
        kwargs = {"train": train, "update_stats": update_stats} if train else {"train": False}
        return functional_call(ctx.bundle.model, (dict(params), dict(stats)), (image,),
                               kwargs)[0]

    def _meta_loss(self, ctx: StepContext, params: Mapping, stats: Mapping, *,
                   train: bool) -> torch.Tensor:
        """The labeled meta loss at ``params`` (train mode: batch statistics,
        none updated; else the running ``stats``)."""
        logits = self._apply(ctx, params, stats, ctx.labeled_image, train=train,
                             update_stats=False)
        probs = torch.softmax(logits, -1)
        onehot = F.one_hot(ctx.labeled_target.long(), probs.shape[-1]).float()
        if self._meta_criterion == "ce":
            return kl_div(probs, onehot)
        return dice_loss(probs, onehot, ignore_index=0)

    def _meta_grad(self, ctx: StepContext, params: Mapping, stats: Mapping, *,
                   train: bool) -> Tuple[torch.Tensor, Tensors]:
        """(meta loss, its gradient in ``params``), both detached."""
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = self._meta_loss(ctx, leaves, stats, train=train)
            # this rank's share of the global meta loss, summed over ranks
            grads = sum_over_ranks(torch.autograd.grad(
                loss / num_ranks(ctx.data_group), list(leaves.values())), ctx.data_group)
        return loss.detach(), dict(zip(leaves, grads))

    def _consistency(self, ctx: StepContext, params: Mapping, stats: Mapping
                     ) -> torch.Tensor:
        """MSE of the teacher's aligned probabilities (its forward updating
        ``stats``) and the student's on the transformed view."""
        with torch.no_grad():
            t_logits = self._apply(ctx, {k: p.detach() for k, p in params.items()}, stats,
                                   ctx.unlabeled_image, train=True)
            target = torch.softmax(ctx.affine_transformer(t_logits), -1)
        student = torch.softmax(ctx.unlabeled_tf_logits, -1)
        return torch.mean((target - student) ** 2)

    # --- hook protocol ------------------------------------------------------
    def loss(self, ctx: StepContext, state):
        metrics = {}
        params, stats = state["teacher_params"], state["teacher_batch_stats"]
        if self._method == "method2":
            meta_loss, g = self._meta_grad(ctx, params, stats, train=False)
            perturbed = {k: p - self._meta_weight * g[k] for k, p in params.items()}
            cons = self._consistency(ctx, perturbed, stats)
            metrics["teacher_loss"] = meta_loss
        elif self._method == "method4":
            with torch.no_grad():       # the teacher at t updates its statistics
                self._apply(ctx, params, stats, ctx.unlabeled_image, train=True)
            meta_loss, g = self._meta_grad(ctx, params, stats, train=False)
            t1 = adam_step(g, state["teacher_opt"], params, self._meta_weight)
            cons = self._consistency(ctx, t1, stats)
            metrics["teacher_loss"] = meta_loss
        elif self._method == "second_order":
            cons = self._consistency(ctx, params, stats)
            meta_loss = self._second_order_meta(ctx, state)
            metrics.update(meta_loss=meta_loss, consistency_loss=cons)
            return cons + meta_loss, state, metrics
        else:
            cons = self._consistency(ctx, params, stats)
        metrics["consistency_loss"] = cons
        return cons, state, metrics

    def _second_order_meta(self, ctx: StepContext, state) -> torch.Tensor:
        """Meta loss of :meth:`virtual_teacher` in train mode against the
        teacher's statistics."""
        return self._meta_loss(ctx, self.virtual_teacher(ctx, state),
                               state["teacher_batch_stats"], train=True)

    def virtual_teacher(self, ctx: StepContext, state) -> Tensors:
        """The teacher EMA'd towards the student's virtual step,
        differentiable back to the student:
        s1 = p - meta_weight * d(sup + 0.1 mse)/dp (create_graph),
        t1 = alpha * teacher + (1 - alpha) * s1."""
        num_classes = ctx.labeled_logits.shape[-1]
        onehot = F.one_hot(ctx.labeled_target.long(), num_classes).float()
        teacher, stats = state["teacher_params"], state["teacher_batch_stats"]
        with torch.no_grad():
            t_logits = self._apply(ctx, teacher, stats, ctx.unlabeled_image, train=True,
                                   update_stats=False)
            t_target = torch.softmax(ctx.affine_transformer(t_logits), -1)
        params = dict(ctx.bundle.model.named_parameters())
        names = list(params)
        leaves = [params[k] for k in names]
        l_logits = ctx.bundle.apply_train(ctx.labeled_image, update_stats=False)[0]
        sup = kl_div(torch.softmax(l_logits, -1), onehot)
        u_logits = ctx.bundle.apply_train(ctx.unlabeled_image_tf, update_stats=False)[0]
        inner = sup + 0.1 * torch.mean((t_target - torch.softmax(u_logits, -1)) ** 2)
        first = torch.autograd.grad(inner / num_ranks(ctx.data_group), leaves,
                                    create_graph=True)
        flat = [k for k, g in zip(names, first) if not g.requires_grad]
        if flat:
            raise RuntimeError(f"{self.name}: the inner gradient of {flat[:3]} (and "
                               f"{max(len(flat) - 3, 0)} more) has no graph; the "
                               f"second-order term would be lost")
        first = sum_over_ranks(first, ctx.data_group)
        a = self._alpha
        return {k: a * teacher[k] + (1.0 - a) * (p - self._meta_weight * g)
                for k, p, g in zip(names, leaves, first)}

    def post_step(self, ctx: StepContext, model: torch.nn.Module, state):
        alpha = justified_alpha(ema_step_tensor(state, next(model.parameters()).device),
                                self._alpha)
        params = state["teacher_params"]
        current = dict(model.named_parameters())
        if self._method in ("method1", "method3"):
            ema = {k: p.clone() for k, p in params.items()}
            ema_update(ema.values(), [current[k] for k in ema], alpha, self._weight_decay)
            _, g = self._meta_grad(ctx, ema, state["teacher_batch_stats"], train=True)
            base = params if self._method == "method1" else ema
            new = adam_step(g, state["teacher_opt"], base, self._meta_weight)
            with torch.no_grad():
                torch._foreach_copy_([params[k] for k in new], list(new.values()))
        else:
            ema_update(params.values(), [current[k] for k in params], alpha,
                       self._weight_decay)
        state["ema_step"] += 1
        return state

    def eval_params(self, state):
        return state["teacher_params"]

    def eval_batch_stats(self, state):
        return state["teacher_batch_stats"]
