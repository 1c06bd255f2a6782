"""Contrastive pretraining (counterpart of contrastyou_tpu/trainers/pretrain.py).

The step: two independently augmented views of one contrastive batch, one
forward over both cut at the deepest tapped layer, a loss made only of hook
terms, and the RAdam update of the model layers up to that layer and of the
hooks' heads (``CrossCorrelationParameters.train_encoder: false`` also
freezes the encoder, :func:`pretrain_trainable`). Every random draw is
explicit, in a :class:`PretrainDraws`: :func:`sample_pretrain_draws` makes
them from a ``torch.Generator``; a test hands in the JAX step's.

The trainers (:class:`PretrainEncoderTrainer`, :class:`PretrainDecoderTrainer`)
run it on the experiment loop: per epoch ``num_batches`` host-fed steps over
the contrastive loader (:func:`get_contrastive_loader`), one ``storage.csv``
row and the ``last`` checkpoint; no validation, no test, no ``best``;
``.success`` at the end. The step generator is reseeded at each epoch from
``(seed, 20_000 + epoch)``, as JAX folds ``20_000 + epoch`` into its key.
Given a ``monitor_loader``, each epoch ends with JAX's monitor pass
(:meth:`PretrainEncoderTrainer.monitor_epoch`): :data:`MONITOR_BATCHES`
batches through :func:`build_monitor_step`, which runs the step's forward
and hook losses without the view geometry and changes nothing, metered
under ``monitor``.

The step runs on W > 1 ranks (``build_pretrain_step(data_group=)``) as
JAX's does on a sharded batch: each rank holds 1/W of the contrastive batch
and of its draws (``parallel.shard_batch``: every part of a
:class:`PretrainDraws` is per row), the forward of both views takes global
BatchNorm sums, the InfoNCE anchors and their group ids are gathered in the
global order ``[view1_global; view2_global]``, each rank back-propagates
1/W of the loss and the gradients are summed over ranks. The trainers
refuse W > 1 ranks, as JAX's pretraining loop shards no batch.
"""
from __future__ import annotations

import logging
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

import contrastyou_tpu_torch as package
from ..data.loader import BatchLoader
from ..data.sampler import ContrastBatchSampler, InfiniteRandomSampler
from ..engine.bundle import ModelBundle
from ..engine.hooks import StepContext, TrainerHook, combined_taps
from ..engine.state import TrainState
from ..engine.steps import check_data_parallel, draw_points, point_grids, sample_hook_draws
from ..engine.trainer import HOOK_DRAW_SEED_OFFSET, Trainer, epoch_seed, hook_metrics
from ..hooks.ccblock import CrossCorrelationHook
from ..hooks.consistency import ConsistencyTrainerHook
from ..hooks.discretemi import DiscreteMITrainHook
from ..hooks.infonce import INFONCEHook, SelfPacedINFONCEHook, SuperPixelInfoNCEHook
from ..hooks.mt import EMAEvalTrainerHook
from ..indicator import Indicator
from ..meters.averages import AverageValueDictionaryMeter, AverageValueMeter
from ..meters.interface import MeterInterface
from ..models._base import arch_order
from ..models.masks import trainable_mask
from ..models.unet import UNet
from ..ops.affine import (GeoParams, apply_gamma, apply_geometric, sample_gammas,
                          sample_geo_params, transform_image, transform_logits)
from ..ops.intensity import color_jitter as apply_jitter
from ..parallel.collectives import mean_over_ranks, sum_gradients
from ..parallel.mesh import DataGroup, data_parallel, multi_rank
from ..tracing import hook_span_names, span

__all__ = ["PRETRAIN_BATCH_SIZE_MAX", "feature_until_from_hooks", "frozen_after",
           "frozen_encoder", "pretrain_trainable", "jitter_strength", "contrastive_sampler",
           "get_contrastive_loader", "PRETRAIN_HOOK_TYPES", "check_pretrain_hooks",
           "PretrainDraws", "sample_pretrain_draws", "build_pretrain_step",
           "build_monitor_step", "MONITOR_BATCHES", "PretrainEncoderTrainer",
           "PretrainDecoderTrainer"]

logger = logging.getLogger(__name__)

PRETRAIN_BATCH_SIZE_MAX = 50
#: JAX folds ``PRETRAIN_SEED_OFFSET + epoch`` into the pretrain step's key
PRETRAIN_SEED_OFFSET = 20_000
#: and ``MONITOR_SEED_OFFSET + epoch`` into the monitor pass's
MONITOR_SEED_OFFSET = 30_000
#: batches of a monitor pass (JAX ``monitor_epoch``'s ``num_batches``)
MONITOR_BATCHES = 10


def contrastive_sampler(data_name: str, slice_scans: Sequence[str],
                        partitions: Sequence[int], *, partition_num: int,
                        scan_sample_num: int = 6, partition_sample_num: int = 1,
                        seed: int = 0, batch_size_max: int = PRETRAIN_BATCH_SIZE_MAX
                        ) -> Tuple[Iterable[List[int]], int]:
    """The endless index batches of the contrastive loader and their size
    (JAX trainers/pretrain.py ``get_contrastive_loader``). ACDC and spleen:
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
        return sampler, min(sampler.batch_size, batch_size_max)
    size = min(scan_sample_num * partition_num * partition_sample_num, batch_size_max)
    return InfiniteRandomSampler(len(partitions), seed=seed).batches(size), size


def get_contrastive_loader(dataset, *, data_name: str, scan_sample_num: int = 6,
                           partition_sample_num: int = 1, seed: int = 0,
                           batch_size_max: int = PRETRAIN_BATCH_SIZE_MAX) -> BatchLoader:
    """The endless contrastive loader over ``dataset``
    (:func:`contrastive_sampler`'s batches, a short one padded to the size
    with ``mask`` False), item transforms seeded with ``seed``."""
    stems = dataset.get_stem_list()
    sampler, size = contrastive_sampler(
        data_name, [dataset.get_scan_name(s) for s in stems], dataset.get_partition_list(),
        partition_num=dataset.partition_num, scan_sample_num=scan_sample_num,
        partition_sample_num=partition_sample_num, seed=seed, batch_size_max=batch_size_max)
    return BatchLoader(dataset, batch_sampler=sampler, pad_to=size, seed=seed)


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


def frozen_encoder(config: Mapping) -> bool:
    """Whether ``CrossCorrelationParameters.train_encoder`` is false: the
    whole encoder then stays frozen during pretraining (JAX
    ``_frozen_encoder``; only that exact section is read)."""
    cc = config.get("CrossCorrelationParameters")
    return isinstance(cc, Mapping) and "train_encoder" in cc and not bool(cc["train_encoder"])


def pretrain_trainable(until: str, freeze_encoder: bool = False,
                       elements: Sequence[str] = UNet.arch_elements) -> Callable[[str], bool]:
    """-> ``trainable(param_name)``: :func:`frozen_after` ``until``, AND-merged
    with an encoder freeze (the layers before the first decoder layer) when
    ``freeze_encoder``."""
    after = frozen_after(until, elements)
    if not freeze_encoder:
        return after
    encoder = trainable_mask(elements=elements, enable=False, start=elements[0],
                             end=UNet.decoder_names[0], include_start=True, include_end=False)
    return lambda name: after(name) and encoder(name)


#: the hook types the pretraining trainers take, matched by exact type: the
#: InfoNCE hook and its self-paced and superpixel variants, the
#: cross-correlation block, the loss-free EMA of the student
#: (``EvalEMAParameters``, carried through the checkpoints as in JAX), and
#: the hooks of the cluster presets (config/hooks/udaiic.yaml's discrete-MI
#: and consistency hooks, which plot_pretrain_cluster.py pretrains with;
#: the hook factory refuses ``DiscreteMIConsistencyParams`` under
#: ``is_pretrain``, as JAX's)
PRETRAIN_HOOK_TYPES = (INFONCEHook, SelfPacedINFONCEHook, SuperPixelInfoNCEHook,
                       CrossCorrelationHook, EMAEvalTrainerHook, DiscreteMITrainHook,
                       ConsistencyTrainerHook)


def check_pretrain_hooks(hooks: Sequence[TrainerHook]) -> None:
    """Raise ``NotImplementedError`` naming the hooks that are not of
    :data:`PRETRAIN_HOOK_TYPES`, or when there is none."""
    others = [h.name for h in hooks if type(h) not in PRETRAIN_HOOK_TYPES]
    if others or not hooks:
        raise NotImplementedError(
            f"the port pretrains with {[t.__name__ for t in PRETRAIN_HOOK_TYPES]} hooks only; "
            f"got {others or 'no hook'}")


def jitter_strength(data_name: str) -> float:
    """Per-dataset pretrain colour jitter: ACDC [0.5, 1.5], prostate [0.9,
    1.1], none elsewhere."""
    if data_name.startswith("acdc"):
        return 0.5
    if data_name.startswith("prostate"):
        return 0.1
    return 0.0


class PretrainDraws(NamedTuple):
    g1: Optional[GeoParams]              # view 1 geometry (None: the monitor's plain views)
    gammas1: Optional[torch.Tensor]      # [B] view 1 gamma
    g2: Optional[GeoParams]              # view 2 base geometry
    gammas2: Optional[torch.Tensor]      # [B]
    jitter1: Optional[Tuple[torch.Tensor, torch.Tensor]]   # (brightness, contrast) [B]
    jitter2: Optional[Tuple[torch.Tensor, torch.Tensor]]
    geo: GeoParams                       # view 2's extra transform, seen by the hooks
    gammas_int: torch.Tensor             # [B] gamma of that transform
    points: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]  # grid -> (ys, xs)
    #: each drawing hook's draws, by hook name (``ctx.hook_draws``)
    hooks: Dict[str, Any] = {}


def sample_pretrain_draws(generator: torch.Generator, batch: int, *,
                          color_jitter: float = 0.0,
                          point_grids: Sequence[Tuple[int, int]] = (),
                          hooks: Sequence[TrainerHook] = (), host_rng=None,
                          shape: Optional[Tuple[int, ...]] = None,
                          total_freedom: bool = True) -> PretrainDraws:
    """The draws of a contrastive batch of ``batch`` slices: the two views'
    geometry and gammas (none without ``total_freedom``: the monitor pass),
    their colour jitter (with ``color_jitter`` > 0), the hooks' transform,
    then each drawing hook's draw (``engine.steps.sample_hook_draws``, for
    an image batch of ``shape``) and one point draw per grid."""
    def jitter():
        if color_jitter <= 0:
            return None
        lo, hi = 1.0 - color_jitter, 1.0 + color_jitter
        return tuple(lo + (hi - lo) * torch.rand(batch, generator=generator,
                                                 device=generator.device)
                     for _ in range(2))

    views = ((sample_geo_params(generator, batch), sample_gammas(generator, batch),
              sample_geo_params(generator, batch), sample_gammas(generator, batch))
             if total_freedom else (None,) * 4)
    return PretrainDraws(
        *views, jitter1=jitter(), jitter2=jitter(),
        geo=sample_geo_params(generator, batch), gammas_int=sample_gammas(generator, batch),
        points={tuple(g): draw_points(generator, batch, tuple(g))
                for g in point_grids},
        hooks=sample_hook_draws(generator, hooks, host_rng=host_rng,
                                shape=shape if shape is not None else (batch,)))


def _views(image: torch.Tensor, draws: PretrainDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two views of ``image``: each its own geometry and gamma (when
    drawn) and colour jitter (when drawn), the second then the hooks'
    transform."""
    if draws.g1 is None:
        view1 = view2 = image
    else:
        view1 = apply_gamma(apply_geometric(image, draws.g1, order=0), draws.gammas1)
        view2 = apply_gamma(apply_geometric(image, draws.g2, order=0), draws.gammas2)
    if draws.jitter1 is not None:
        view1 = apply_jitter(view1, *draws.jitter1)
        view2 = apply_jitter(view2, *draws.jitter2)
    return view1, transform_image(view2, draws.geo, draws.gammas_int)


def _hook_losses(bundle, hooks, state, batch, draws, epoch, *, until, taps, logits_tf,
                 hook_spans, group=None, update_stats: bool = True):
    """One forward over both views cut at ``until`` and the hook losses ->
    (reg_loss, metrics, ctx, each hook's new state); ``state`` is not
    written. ``hook_spans``: each hook's span name (``tracing.py``)."""
    with span("cy/step/forward"):
        image = batch["image"]
        view1, view2 = _views(image, draws)
        n = image.shape[0]
        out, taps_all = bundle.apply_train(torch.cat([view1, view2], 0), until=until,
                                           taps=taps, update_stats=update_stats)
        ctx = StepContext(unlabeled_image=view1, unlabeled_image_tf=view2,
                          unlabeled_logits=out[:n], unlabeled_tf_logits=out[n:],
                          unlabeled_taps={k: v[:n] for k, v in taps_all.items()},
                          unlabeled_tf_taps={k: v[n:] for k, v in taps_all.items()},
                          label_group=batch.get("scan_id"),
                          partition_group=batch.get("partition"),
                          patient_group=batch.get("patient"),
                          cycle_group=batch.get("cycle"),
                          superpixel=batch.get("superpixel"),
                          geo_params=draws.geo, point_draws=draws.points,
                          hook_draws=dict(draws.hooks),
                          epoch=epoch, bundle=bundle, data_group=group)
        if logits_tf:
            ctx.unlabeled_logits_tf = transform_logits(out[:n], draws.geo)
    reg_loss = out.new_zeros(())
    metrics: Dict[str, torch.Tensor] = {}
    new_states = {}
    with span("cy/step/hooks"):
        for hook in hooks:
            with span(hook_spans[hook.name]):
                h_loss, h_state, h_metrics = hook.loss(ctx, state.hook_states[hook.name])
            reg_loss = reg_loss + hook.weight * h_loss
            if h_state is not None:
                new_states[hook.name] = h_state
            metrics[f"{hook.name}/loss"] = h_loss.detach()
            metrics.update({f"{hook.name}/{k}": v.detach() for k, v in h_metrics.items()})
    return reg_loss, metrics, ctx, new_states


def build_monitor_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                       until: str) -> Callable:
    """-> ``monitor(state, batch, draws, epoch=0) -> metrics``: the pretrain
    step's forward and hook losses without its update (JAX's monitor step,
    ``build_pretrain_step(optax.set_to_zero(), total_freedom=False)`` on a
    copy of the state). ``draws`` come without view geometry
    (``sample_pretrain_draws(total_freedom=False)``); the forward takes
    batch statistics and leaves the running ones alone; the hooks' states,
    the parameters, the optimizer and its count are not touched. Metrics
    as the step's, ``reg_loss`` included."""
    hooks = tuple(hooks)
    taps = combined_taps(hooks)
    logits_tf = any(h.reads_logits_tf for h in hooks)
    hook_spans = hook_span_names(hooks)

    @torch.no_grad()
    def monitor(state: TrainState, batch: Dict[str, torch.Tensor], draws: PretrainDraws,
                epoch: int = 0) -> Dict[str, torch.Tensor]:
        state.model.train()
        reg_loss, metrics, _, _ = _hook_losses(bundle, hooks, state, batch, draws, epoch,
                                               until=until, taps=taps, logits_tf=logits_tf,
                                               hook_spans=hook_spans, update_stats=False)
        metrics["reg_loss"] = reg_loss
        return metrics

    return monitor


def build_pretrain_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                        until: str, data_group: Optional[DataGroup] = None) -> Callable:
    """-> ``step(state, batch, draws, epoch=0) -> metrics``.

    ``batch``: ``image`` [B,H,W,1], the group ids ``partition``,
    ``scan_id``, ``patient``, ``cycle`` [B] and, for the superpixel hook,
    ``superpixel`` [B,H,W]. View 1 is geometry then gamma
    (``g1``, ``gammas1``), view 2 the same with ``g2`` then the hooks'
    transform (``gammas_int`` then ``geo``); colour jitter follows each
    view's first gamma when drawn. One forward over the 2B images (BN
    statistics over both views together) cut at ``until``, its output the
    hooks' "logits", as in JAX; the aligned T(f(x)) is built only when a
    hook reads it (a cross-correlation block on ``Deconv_1x1``). The loss is
    the weighted sum of the hook losses. The metrics stay on the device.

    ``data_group`` of W > 1 ranks: ``batch`` and ``draws`` are this rank's
    rows of the global batch's (see the module docstring); the metrics are
    the global batch's."""
    hooks = tuple(hooks)
    group = multi_rank(data_group)
    check_data_parallel(hooks, group, mode="pretrain")
    taps = combined_taps(hooks)
    logits_tf = any(h.reads_logits_tf for h in hooks)
    hook_spans = hook_span_names(hooks)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: PretrainDraws,
             epoch: int = 0) -> Dict[str, torch.Tensor]:
        with data_parallel(group):
            return run(state, batch, draws, epoch)

    def run(state, batch, draws, epoch):
        state.model.train()
        reg_loss, metrics, ctx, new_states = _hook_losses(
            bundle, hooks, state, batch, draws, epoch, until=until, taps=taps,
            logits_tf=logits_tf, hook_spans=hook_spans, group=group)
        state.hook_states.update(new_states)

        with span("cy/step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            if group is None:
                reg_loss.backward()
            else:
                # this rank's share: the shares of the ranks sum to the global loss
                (reg_loss / group.size).backward()
                sum_gradients([p for g in state.optimizer.param_groups for p in g["params"]],
                              group)
        with span("cy/step/optimizer"):
            state.optimizer.step()
        with span("cy/step/commit"):
            for hook in hooks:
                state.hook_states[hook.name] = hook.post_step(
                    ctx, state.model, state.hook_states[hook.name])
            state.step += 1
            metrics["reg_loss"] = reg_loss.detach()
            return metrics if group is None else mean_over_ranks(metrics, group)

    return step


class PretrainEncoderTrainer(Trainer):
    """Contrastive pretraining on the experiment loop (JAX
    ``PretrainEncoderTrainer``): the hooks of :data:`PRETRAIN_HOOK_TYPES`,
    the forward cut at their deepest tap (:attr:`forward_until`) and every
    later layer frozen (the encoder too without
    ``CrossCorrelationParameters.train_encoder``).
    ``contrast_loader`` feeds the steps (by default the labeled loader); the
    optional ``monitor_loader`` (contrastive batches) adds the monitor pass
    to each epoch (:meth:`monitor_epoch`). The ``device_cache`` key is
    ignored, as in JAX: pretraining is host-fed."""

    train_mode = "pretrain"
    activate_hooks = True
    data_parallel_refusal = ("JAX's pretraining loop does not shard its batches "
                             "(contrastyou_tpu/trainers/pretrain.py tra_epoch); the pretrain "
                             "step does: build_pretrain_step(data_group=)")
    unroll_refusal = ("JAX's pretraining trainers build their own step and loop and run one "
                      "step a call whatever unroll_steps is "
                      "(contrastyou_tpu/trainers/pretrain.py)")

    def __init__(self, *, contrast_loader=None, monitor_loader=None, **kwargs):
        if contrast_loader is not None:
            kwargs.setdefault("labeled_loader", contrast_loader)
        super().__init__(**kwargs)
        self._contrast_loader = contrast_loader or self._labeled_loader
        self._monitor_loader = monitor_loader

    @property
    def forward_until(self) -> str:
        return feature_until_from_hooks(*self._hooks)

    def init(self) -> None:
        check_pretrain_hooks(self._hooks)
        super().init()

    def _trainable_parameters(self) -> List[torch.nn.Parameter]:
        trainable = pretrain_trainable(self.forward_until, frozen_encoder(self._config))
        return [p for name, p in self._model.named_parameters() if trainable(name)]

    def _build_steps(self) -> None:
        self._train_step = build_pretrain_step(self._bundle, self._active_hooks,
                                               until=self.forward_until)
        if self._monitor_loader is not None:
            self._monitor_step = build_monitor_step(self._bundle, self._active_hooks,
                                                    until=self.forward_until)

    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        with self._writer, self._closing_iterators():
            for epoch in range(self._cur_epoch, self._max_epoch):
                self._cur_epoch = epoch
                with self._epoch_profile(epoch), self._storage:
                    stages = {"tra": self.tra_epoch(epoch)}
                    if self._monitor_loader is not None:
                        stages["monitor"] = self.monitor_epoch(epoch)
                    self._storage.add_from_meter_interface(epoch=epoch, **stages)
                    self._write_events(epoch, stages)
                self.save_to("last")
                logger.info("pretrain epoch %d/%d: reg %.5f", epoch + 1, self._max_epoch,
                            stages["tra"]["pretrain"]["reg_loss"])
        package.success(self._save_dir)
        return 0.0

    def _device_contrast_batch(self, batch: dict) -> dict:
        dev = self._to_device
        out = {"image": dev(batch["image"]),
               **{k: dev(batch[k]).long() for k in ("partition", "scan_id", "patient", "cycle")}}
        if "superpixel" in batch:
            out["superpixel"] = dev(batch["superpixel"]).long()
        return out

    def _meters(self, focus: str) -> Tuple[MeterInterface, dict]:
        """``reg_loss`` under ``focus`` and each hook's metrics under its name."""
        meters = MeterInterface(default_focus=focus)
        meters.register_meter("reg_loss", AverageValueMeter())
        hook_meters = {}
        for hook in self._active_hooks:
            with meters.focus_on(hook.name):
                hook_meters[hook.name] = meters.register_meter(
                    "metrics", AverageValueDictionaryMeter())
        return meters, hook_meters

    def _draws(self, generator: torch.Generator, image: torch.Tensor, *,
               total_freedom: bool = True, color_jitter: float = 0.0) -> PretrainDraws:
        return sample_pretrain_draws(generator, image.shape[0], color_jitter=color_jitter,
                                     point_grids=point_grids(self._active_hooks),
                                     hooks=self._active_hooks, host_rng=self._host_rng,
                                     shape=tuple(image.shape), total_freedom=total_freedom)

    def tra_epoch(self, epoch: int) -> dict:
        meters, hook_meters = self._meters("pretrain")
        if not hasattr(self, "_contrast_iter"):
            self._contrast_iter = iter(self._contrast_loader)
        generator = torch.Generator(device=self.device).manual_seed(
            epoch_seed(self._seed, epoch, PRETRAIN_SEED_OFFSET))
        self._host_rng = np.random.default_rng(
            epoch_seed(self._seed, epoch, HOOK_DRAW_SEED_OFFSET))
        strength = jitter_strength(str(self._config.get("Data", {}).get("name", "")))
        indicator = Indicator(range(self._num_batches), desc=f"pretrain {epoch:03d}")
        last = self._num_batches - 1
        t0 = time.perf_counter()
        with meters:
            for it in indicator:
                with span("cy/data/host_batch"):
                    batch = self._device_contrast_batch(next(self._contrast_iter))
                    draws = self._draws(generator, batch["image"], color_jitter=strength)
                with span("cy/train/call"):
                    metrics = self._train_step(self._state, batch, draws, epoch)
                with span("cy/train/meters"):
                    meters.add("reg_loss", metrics["reg_loss"])
                    for hook in self._active_hooks:
                        hook_meters[hook.name].add(**hook_metrics(metrics, hook.name))
                    if it == 0:
                        self._log_figures(metrics, epoch)
                    if it % 10 == 9 or it == last:
                        indicator.set_postfix_statics(
                            {"pretrain": {"reg": meters["reg_loss"].summary()}},
                            force_update=it == last)
        self._pause_iterators()
        self._sync()
        seconds = time.perf_counter() - t0
        logger.info("pretrain epoch %d: %d steps in %.3f s (%.3f ms/step, host-fed%s)", epoch,
                    self._num_batches, seconds, seconds / self._num_batches * 1e3,
                    ", profiled" if self._profiling else "",
                    extra={"timing": {"phase": "train", "epoch": epoch,
                                      "steps": self._num_batches, "seconds": seconds,
                                      "device_cache": False, "profiled": self._profiling}})
        return dict(meters.statistics())

    def monitor_epoch(self, epoch: int, num_batches: int = MONITOR_BATCHES) -> dict:
        """JAX's monitor pass: ``num_batches`` batches of the monitor loader
        (one iterator across epochs) through :func:`build_monitor_step`, no
        view geometry and no colour jitter, the draws from ``(seed, 30_000 +
        epoch)``; ``reg_loss`` and the hook metrics metered under
        ``monitor``. The parameters, BN statistics, hook states and the
        optimizer are left as they were."""
        if self._monitor_loader is None:
            raise RuntimeError("monitor_epoch needs a monitor_loader")
        meters, hook_meters = self._meters("monitor")
        if not hasattr(self, "_monitor_iter"):
            self._monitor_iter = iter(self._monitor_loader)
        generator = torch.Generator(device=self.device).manual_seed(
            epoch_seed(self._seed, epoch, MONITOR_SEED_OFFSET))
        self._host_rng = np.random.default_rng(
            epoch_seed(self._seed, epoch, MONITOR_SEED_OFFSET + HOOK_DRAW_SEED_OFFSET))
        indicator = Indicator(range(num_batches), desc=f"monitor {epoch:03d}")
        last = num_batches - 1
        t0 = time.perf_counter()
        with meters:
            for it in indicator:
                batch = self._device_contrast_batch(next(self._monitor_iter))
                draws = self._draws(generator, batch["image"], total_freedom=False)
                metrics = self._monitor_step(self._state, batch, draws, epoch)
                meters.add("reg_loss", metrics["reg_loss"])
                for hook in self._active_hooks:
                    hook_meters[hook.name].add(**hook_metrics(metrics, hook.name))
                if it % 10 == 9 or it == last:
                    indicator.set_postfix_statics(
                        {"monitor": {"reg": meters["reg_loss"].summary()}},
                        force_update=it == last)
        self._pause_iterators()
        self._sync()
        seconds = time.perf_counter() - t0
        logger.info("monitor epoch %d: %d batches in %.3f s", epoch, num_batches, seconds,
                    extra={"timing": {"phase": "monitor", "epoch": epoch,
                                      "batches": num_batches, "seconds": seconds,
                                      "profiled": self._profiling}})
        return dict(meters.statistics())


class PretrainDecoderTrainer(PretrainEncoderTrainer):
    """Decoder hooks (JAX ``PretrainDecoderTrainer``): the same loop; the
    decoder taps set the cut."""
