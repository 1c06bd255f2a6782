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
from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

import contrastyou_tpu_torch as package
from ..data.loader import BatchLoader
from ..data.sampler import ContrastBatchSampler, InfiniteRandomSampler
from ..engine.bundle import ModelBundle
from ..engine.hooks import StepContext, TrainerHook, combined_taps
from ..engine.state import TrainState
from ..engine.steps import check_data_parallel, draw_points, point_grids
from ..engine.trainer import Trainer, epoch_seed, hook_metrics
from ..hooks.ccblock import CrossCorrelationHook
from ..hooks.infonce import INFONCEHook, SelfPacedINFONCEHook, SuperPixelInfoNCEHook
from ..hooks.mt import EMAEvalTrainerHook
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

__all__ = ["PRETRAIN_BATCH_SIZE_MAX", "feature_until_from_hooks", "frozen_after",
           "frozen_encoder", "pretrain_trainable", "jitter_strength", "contrastive_sampler",
           "get_contrastive_loader", "PRETRAIN_HOOK_TYPES", "check_pretrain_hooks",
           "PretrainDraws", "sample_pretrain_draws", "build_pretrain_step",
           "PretrainEncoderTrainer", "PretrainDecoderTrainer"]

logger = logging.getLogger(__name__)

PRETRAIN_BATCH_SIZE_MAX = 50
#: JAX folds ``PRETRAIN_SEED_OFFSET + epoch`` into the pretrain step's key
PRETRAIN_SEED_OFFSET = 20_000


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
#: cross-correlation block, and the loss-free EMA of the student
#: (``EvalEMAParameters``, carried through the checkpoints as in JAX)
PRETRAIN_HOOK_TYPES = (INFONCEHook, SelfPacedINFONCEHook, SuperPixelInfoNCEHook,
                       CrossCorrelationHook, EMAEvalTrainerHook)


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

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: PretrainDraws,
             epoch: int = 0) -> Dict[str, torch.Tensor]:
        with data_parallel(group):
            return run(state, batch, draws, epoch)

    def run(state, batch, draws, epoch):
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
                          epoch=epoch, bundle=bundle, data_group=group)
        if logits_tf:
            ctx.unlabeled_logits_tf = transform_logits(out[:n], draws.geo)
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
        if group is None:
            reg_loss.backward()
        else:
            # this rank's share: the shares of the ranks sum to the global loss
            (reg_loss / group.size).backward()
            sum_gradients([p for g in state.optimizer.param_groups for p in g["params"]],
                          group)
        state.optimizer.step()
        for hook in hooks:
            state.hook_states[hook.name] = hook.post_step(
                ctx, state.model, state.hook_states[hook.name])
        state.step += 1
        metrics["reg_loss"] = reg_loss.detach()
        return metrics if group is None else mean_over_ranks(metrics, group)

    return step


class PretrainEncoderTrainer(Trainer):
    """Contrastive pretraining on the experiment loop (JAX
    ``PretrainEncoderTrainer``): InfoNCE and cross-correlation hooks only,
    the forward cut at their deepest tap (:attr:`forward_until`) and every
    later layer frozen (the encoder too without
    ``CrossCorrelationParameters.train_encoder``).
    ``contrast_loader`` feeds the steps (by default the labeled loader); the
    JAX trainer's optional ``monitor_loader`` pass is not ported. The
    ``device_cache`` key is ignored, as in JAX: pretraining is host-fed."""

    train_mode = "pretrain"
    activate_hooks = True
    data_parallel_refusal = ("JAX's pretraining loop does not shard its batches "
                             "(contrastyou_tpu/trainers/pretrain.py tra_epoch); the pretrain "
                             "step does: build_pretrain_step(data_group=)")

    def __init__(self, *, contrast_loader=None, monitor_loader=None, **kwargs):
        if monitor_loader is not None:
            raise NotImplementedError("the pretrain trainers' monitor_loader is not ported")
        if contrast_loader is not None:
            kwargs.setdefault("labeled_loader", contrast_loader)
        super().__init__(**kwargs)
        self._contrast_loader = contrast_loader or self._labeled_loader

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

    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        with self._writer:
            for epoch in range(self._cur_epoch, self._max_epoch):
                self._cur_epoch = epoch
                with self._epoch_profile(epoch), self._storage:
                    tra = self.tra_epoch(epoch)
                    self._storage.add_from_meter_interface(epoch=epoch, tra=tra)
                    self._write_events(epoch, {"tra": tra})
                self.save_to("last")
                logger.info("pretrain epoch %d/%d: reg %.5f", epoch + 1, self._max_epoch,
                            tra["pretrain"]["reg_loss"])
        package.success(self._save_dir)
        return 0.0

    def _device_contrast_batch(self, batch: dict) -> dict:
        dev = self._to_device
        out = {"image": dev(batch["image"]),
               **{k: dev(batch[k]).long() for k in ("partition", "scan_id", "patient", "cycle")}}
        if "superpixel" in batch:
            out["superpixel"] = dev(batch["superpixel"]).long()
        return out

    def tra_epoch(self, epoch: int) -> dict:
        meters = MeterInterface(default_focus="pretrain")
        meters.register_meter("reg_loss", AverageValueMeter())
        hook_meters = {}
        for hook in self._active_hooks:
            with meters.focus_on(hook.name):
                hook_meters[hook.name] = meters.register_meter(
                    "metrics", AverageValueDictionaryMeter())
        if not hasattr(self, "_contrast_iter"):
            self._contrast_iter = iter(self._contrast_loader)
        generator = torch.Generator(device=self.device).manual_seed(
            epoch_seed(self._seed, epoch, PRETRAIN_SEED_OFFSET))
        strength = jitter_strength(str(self._config.get("Data", {}).get("name", "")))
        grids = point_grids(self._active_hooks)
        t0 = time.perf_counter()
        with meters:
            for it in range(self._num_batches):
                batch = self._device_contrast_batch(next(self._contrast_iter))
                draws = sample_pretrain_draws(generator, batch["image"].shape[0],
                                              color_jitter=strength, point_grids=grids)
                metrics = self._train_step(self._state, batch, draws, epoch)
                meters.add("reg_loss", metrics["reg_loss"])
                for hook in self._active_hooks:
                    hook_meters[hook.name].add(**hook_metrics(metrics, hook.name))
                if it == 0:
                    self._log_figures(metrics, epoch)
        self._sync()
        seconds = time.perf_counter() - t0
        logger.info("pretrain epoch %d: %d steps in %.3f s (%.3f ms/step, host-fed%s)", epoch,
                    self._num_batches, seconds, seconds / self._num_batches * 1e3,
                    ", profiled" if self._profiling else "",
                    extra={"timing": {"phase": "train", "epoch": epoch,
                                      "steps": self._num_batches, "seconds": seconds,
                                      "device_cache": False, "profiled": self._profiling}})
        return dict(meters.statistics())


class PretrainDecoderTrainer(PretrainEncoderTrainer):
    """Decoder hooks (JAX ``PretrainDecoderTrainer``): the same loop; the
    decoder taps set the cut."""
