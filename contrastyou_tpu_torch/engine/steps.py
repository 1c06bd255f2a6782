"""Train-step builders (counterpart of contrastyou_tpu/engine/steps.py): the
``semi`` step — augmentation, two-stage forward, supervised KL, summed hook
losses, optimizer update, hook post-updates — and the device-cached step
that also samples its batch on the GPU.

Every random draw is explicit: the step takes a :class:`StepDraws` (the
unlabeled batch's GeoParams and gammas); the cached step draws those, the
sample indices and the crop offsets from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..losses.kl import kl_div
from ..meters.dice import slice_intersection_union
from ..ops.affine import (GeoParams, sample_gammas, sample_geo_params,
                          transform_image, transform_logits)
from .bundle import ModelBundle
from .hooks import StepContext, TrainerHook, check_hook_names, combined_taps
from .state import TrainState

__all__ = ["StepDraws", "sample_step_draws", "init_train_state",
           "build_train_step", "build_cached_train_step"]


class StepDraws(NamedTuple):
    geo: GeoParams          # transform of the unlabeled batch
    gammas: torch.Tensor    # [Bu] gamma of the unlabeled batch


def sample_step_draws(generator: torch.Generator, batch: int) -> StepDraws:
    return StepDraws(sample_geo_params(generator, batch),
                     sample_gammas(generator, batch))


def init_train_state(bundle: ModelBundle, hooks: Sequence[TrainerHook],
                     optimizer: torch.optim.Optimizer) -> TrainState:
    check_hook_names(hooks)
    return TrainState(model=bundle.model, optimizer=optimizer,
                      hook_states={h.name: h.init_state(bundle) for h in hooks})


def build_train_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                     disable_bn: bool = False) -> Callable:
    """-> ``step(state, batch, draws, epoch=0) -> metrics`` for the ``semi``
    mode.

    ``batch``: ``labeled_image`` [B,H,W,1], ``labeled_target`` [B,H,W] int,
    ``unlabeled_image`` [Bu,H,W,1], optional group ids. Two-stage BN (the
    reference config's ``Trainer.two_stage``; the one-pass form is not
    ported): one forward over the labeled batch, one over the unlabeled batch
    and its transformed copy (``disable_bn`` keeps the second from updating
    the BN running statistics). The metrics stay on the device."""
    hooks = tuple(hooks)
    taps = combined_taps(hooks)
    num_classes = bundle.num_classes

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws, epoch: int = 0) -> Dict[str, torch.Tensor]:
        state.model.train()
        labeled_image = batch["labeled_image"]
        labeled_target = batch["labeled_target"]
        unlabeled_image = batch["unlabeled_image"]
        nu = unlabeled_image.shape[0]
        unlabeled_image_tf = transform_image(unlabeled_image, draws.geo, draws.gammas)
        ctx = StepContext(labeled_image=labeled_image, labeled_target=labeled_target,
                          unlabeled_image=unlabeled_image,
                          unlabeled_image_tf=unlabeled_image_tf,
                          geo_params=draws.geo, epoch=epoch, bundle=bundle,
                          label_group=batch.get("unlabeled_scan_id"),
                          partition_group=batch.get("unlabeled_partition"),
                          patient_group=batch.get("unlabeled_patient"),
                          cycle_group=batch.get("unlabeled_cycle"))
        labeled_logits, labeled_taps = bundle.apply_train(labeled_image, taps=taps)
        u_logits, u_taps = bundle.apply_train(
            torch.cat([unlabeled_image, unlabeled_image_tf], 0), taps=taps,
            update_stats=not disable_bn)
        ctx.labeled_logits, ctx.labeled_taps = labeled_logits, labeled_taps
        ctx.unlabeled_logits, ctx.unlabeled_tf_logits = u_logits[:nu], u_logits[nu:]
        ctx.unlabeled_logits_tf = transform_logits(ctx.unlabeled_logits, draws.geo)
        ctx.unlabeled_taps = {k: v[:nu] for k, v in u_taps.items()}
        ctx.unlabeled_tf_taps = {k: v[nu:] for k, v in u_taps.items()}

        onehot = F.one_hot(labeled_target.long(), num_classes).float()
        probs = torch.softmax(labeled_logits, -1)
        sup_loss = kl_div(probs, onehot)
        reg_loss = sup_loss.new_zeros(())
        metrics: Dict[str, torch.Tensor] = {}
        for hook in hooks:
            h_loss, h_state, h_metrics = hook.loss(ctx, state.hook_states[hook.name])
            reg_loss = reg_loss + hook.weight * h_loss
            if h_state is not None:
                state.hook_states[hook.name] = h_state
            metrics[f"{hook.name}/loss"] = h_loss.detach()
            metrics.update({f"{hook.name}/{k}": v.detach() for k, v in h_metrics.items()})
        total = sup_loss + reg_loss

        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        for hook in hooks:
            state.hook_states[hook.name] = hook.post_step(
                ctx, state.model, state.hook_states[hook.name])
        state.step += 1

        inter, union = slice_intersection_union(probs.detach().argmax(-1), labeled_target,
                                                num_classes=num_classes)
        metrics.update(sup_loss=sup_loss.detach(), reg_loss=reg_loss.detach(),
                       total_loss=total.detach(), dice_inter=inter, dice_union=union)
        return metrics

    return step


def build_cached_train_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                            labeled_cache, unlabeled_cache,
                            labeled_batch: int = 5, unlabeled_batch: int = 5,
                            **kwargs) -> Callable:
    """-> ``cached_step(state, generator, epoch=0) -> metrics``: one ``semi`` step
    whose batch is sampled and cropped on the device from the two
    :class:`~contrastyou_tpu_torch.data.device_cache.DeviceDataCache` s; the
    metrics also carry ``labeled_scan_id`` [B]."""
    step = build_train_step(bundle, hooks, **kwargs)

    def cached_step(state: TrainState, generator: torch.Generator, epoch: int = 0):
        lab = labeled_cache.sample(generator, labeled_batch)
        unl = unlabeled_cache.sample(generator, unlabeled_batch)
        batch = {"labeled_image": lab["image"], "labeled_target": lab["target"],
                 "unlabeled_image": unl["image"],
                 "unlabeled_partition": unl["partition"],
                 "unlabeled_scan_id": unl["scan_id"],
                 "unlabeled_patient": unl["patient"],
                 "unlabeled_cycle": unl["cycle"]}
        metrics = step(state, batch, sample_step_draws(generator, unlabeled_batch), epoch)
        metrics["labeled_scan_id"] = lab["scan_id"]
        return metrics

    return cached_step
