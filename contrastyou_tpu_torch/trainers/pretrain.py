"""Contrastive pretraining step (counterpart of contrastyou_tpu/trainers/pretrain.py):
two independently augmented views of one contrastive batch, one forward over
both cut at the deepest tapped layer, a loss made only of hook terms, and the
RAdam update of the model layers up to that layer and of the hooks' heads.

Every random draw is explicit, in a :class:`PretrainDraws`:
:func:`sample_pretrain_draws` makes them from a ``torch.Generator``; a test
hands in the JAX step's.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..data.sampler import ContrastBatchSampler, InfiniteRandomSampler
from ..engine.bundle import ModelBundle
from ..engine.hooks import StepContext, TrainerHook, combined_taps
from ..engine.state import TrainState
from ..hooks.infonce import draw_points
from ..models._base import arch_order
from ..models.masks import trainable_mask
from ..models.unet import UNet
from ..ops.affine import (GeoParams, apply_gamma, apply_geometric, sample_gammas,
                          sample_geo_params, transform_image)
from ..ops.intensity import color_jitter as apply_jitter

__all__ = ["PRETRAIN_BATCH_SIZE_MAX", "feature_until_from_hooks", "frozen_after",
           "jitter_strength", "contrastive_batches", "PretrainDraws",
           "sample_pretrain_draws", "build_pretrain_step"]

PRETRAIN_BATCH_SIZE_MAX = 50


def contrastive_batches(data_name: str, slice_scans: Sequence[str],
                        partitions: Sequence[int], *, partition_num: int,
                        scan_sample_num: int = 6, partition_sample_num: int = 1,
                        seed: int = 0, batch_size_max: int = PRETRAIN_BATCH_SIZE_MAX
                        ) -> Tuple[Iterator[List[int]], int]:
    """Endless index batches of the contrastive loader and their size
    (trainers/pretrain.py ``get_contrastive_loader``). ACDC and spleen:
    ``scan_sample_num`` scans x every partition (:class:`ContrastBatchSampler`;
    a short batch is padded to the size by the caller). Otherwise
    consecutive runs of an :class:`InfiniteRandomSampler` over all slices, of
    ``min(scan_sample_num * partition_num * partition_sample_num,
    batch_size_max)``. Slice ``i`` lies in scan ``slice_scans[i]`` and
    partition ``partitions[i]``."""
    if data_name.startswith("acdc") or data_name == "spleen":
        sampler = ContrastBatchSampler(slice_scans, partitions,
                                       scan_sample_num=scan_sample_num,
                                       partition_sample_num=partition_sample_num, seed=seed)
        return iter(sampler), min(sampler.batch_size, batch_size_max)
    size = min(scan_sample_num * partition_num * partition_sample_num, batch_size_max)
    return InfiniteRandomSampler(len(partitions), seed=seed).batches(size), size


def feature_until_from_hooks(*hooks: TrainerHook,
                             elements: Sequence[str] = UNet.arch_elements) -> str:
    """The deepest tapped layer: the forward is cut there."""
    taps = [t for h in hooks for t in h.taps]
    if not taps:
        return elements[-1]
    return max(taps, key=lambda n: arch_order(n, elements=elements))


def frozen_after(until: str,
                 elements: Sequence[str] = UNet.arch_elements) -> Callable[[str], bool]:
    """-> ``trainable(param_name)``: every layer after ``until`` is frozen
    (trainers/pretrain.py ``_param_labels``)."""
    if until == elements[-1]:
        return lambda name: True
    return trainable_mask(elements=elements, enable=False, start=until, include_start=False)


def jitter_strength(data_name: str) -> float:
    """Per-dataset pretrain colour jitter: ACDC [0.5, 1.5], prostate [0.9,
    1.1], none elsewhere."""
    if data_name.startswith("acdc"):
        return 0.5
    if data_name.startswith("prostate"):
        return 0.1
    return 0.0


class PretrainDraws(NamedTuple):
    g1: GeoParams                        # view 1 geometry
    gammas1: torch.Tensor                # [B] view 1 gamma
    g2: GeoParams                        # view 2 base geometry
    gammas2: torch.Tensor                # [B]
    jitter1: Optional[Tuple[torch.Tensor, torch.Tensor]]   # (brightness, contrast) [B]
    jitter2: Optional[Tuple[torch.Tensor, torch.Tensor]]
    geo: GeoParams                       # view 2's extra transform, seen by the hooks
    gammas_int: torch.Tensor             # [B] gamma of that transform
    points: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]  # grid -> (ys, xs)


def sample_pretrain_draws(generator: torch.Generator, batch: int, *,
                          color_jitter: float = 0.0,
                          point_grids: Sequence[Tuple[int, int]] = ()) -> PretrainDraws:
    def jitter():
        if color_jitter <= 0:
            return None
        lo, hi = 1.0 - color_jitter, 1.0 + color_jitter
        return tuple(lo + (hi - lo) * torch.rand(batch, generator=generator,
                                                 device=generator.device)
                     for _ in range(2))

    return PretrainDraws(
        g1=sample_geo_params(generator, batch), gammas1=sample_gammas(generator, batch),
        g2=sample_geo_params(generator, batch), gammas2=sample_gammas(generator, batch),
        jitter1=jitter(), jitter2=jitter(),
        geo=sample_geo_params(generator, batch), gammas_int=sample_gammas(generator, batch),
        points={tuple(g): draw_points(generator, batch, tuple(g))
                for g in point_grids})


def build_pretrain_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                        until: str) -> Callable:
    """-> ``step(state, batch, draws, epoch=0) -> metrics``.

    ``batch``: ``image`` [B,H,W,1] and the group ids ``partition``,
    ``scan_id``, ``patient``, ``cycle`` [B]. View 1 is geometry then gamma
    (``g1``, ``gammas1``), view 2 the same with ``g2`` then the hooks'
    transform (``gammas_int`` then ``geo``); colour jitter follows each
    view's first gamma when drawn. One forward over the 2B images (BN
    statistics over both views together) cut at ``until``; the loss is the
    weighted sum of the hook losses. The metrics stay on the device."""
    hooks = tuple(hooks)
    taps = combined_taps(hooks)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: PretrainDraws,
             epoch: int = 0) -> Dict[str, torch.Tensor]:
        state.model.train()
        image = batch["image"]
        view1 = apply_gamma(apply_geometric(image, draws.g1, order=0), draws.gammas1)
        view2 = apply_gamma(apply_geometric(image, draws.g2, order=0), draws.gammas2)
        if draws.jitter1 is not None:
            view1 = apply_jitter(view1, *draws.jitter1)
            view2 = apply_jitter(view2, *draws.jitter2)
        view2 = transform_image(view2, draws.geo, draws.gammas_int)

        n = image.shape[0]
        out, taps_all = bundle.apply_train(torch.cat([view1, view2], 0), until=until,
                                           taps=taps)
        # logit-space hooks (consistency) are not ported for pretraining, so
        # the aligned T(f(x)) is not built
        ctx = StepContext(unlabeled_image=view1, unlabeled_image_tf=view2,
                          unlabeled_logits=out[:n], unlabeled_tf_logits=out[n:],
                          unlabeled_taps={k: v[:n] for k, v in taps_all.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in taps_all.items()},
                          label_group=batch.get("scan_id"),
                          partition_group=batch.get("partition"),
                          patient_group=batch.get("patient"),
                          cycle_group=batch.get("cycle"),
                          geo_params=draws.geo, point_draws=draws.points,
                          epoch=epoch, bundle=bundle)
        reg_loss = out.new_zeros(())
        metrics: Dict[str, torch.Tensor] = {}
        for hook in hooks:
            h_loss, h_state, h_metrics = hook.loss(ctx, state.hook_states[hook.name])
            reg_loss = reg_loss + hook.weight * h_loss
            if h_state is not None:
                state.hook_states[hook.name] = h_state
            metrics[f"{hook.name}/loss"] = h_loss.detach()
            metrics.update({f"{hook.name}/{k}": v.detach() for k, v in h_metrics.items()})

        state.optimizer.zero_grad(set_to_none=True)
        reg_loss.backward()
        state.optimizer.step()
        for hook in hooks:
            state.hook_states[hook.name] = hook.post_step(
                ctx, state.model, state.hook_states[hook.name])
        state.step += 1
        metrics["reg_loss"] = reg_loss.detach()
        return metrics

    return step
