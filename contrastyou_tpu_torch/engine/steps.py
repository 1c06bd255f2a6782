"""Step builders (counterpart of contrastyou_tpu/engine/steps.py): the
``semi`` step — augmentation, two-stage forward, supervised KL, summed hook
losses, optimizer update, hook post-updates — and the ``ft`` step (the
labeled forward alone under the supervised KL and the hooks), the
device-cached step that also samples its batch on the GPU, and the eval step
(running-statistics forward, optionally averaged over the four axis flips).

K steps a call (``Trainer.unroll_steps``, JAX's unrolled and cached
steps): :func:`build_unrolled_train_step` takes K host-fed batches stacked
``[K, ...]`` and K steps' draws, :func:`build_cached_train_step` with
``unroll=K`` samples K batches and their draws a call; both return every
metric stacked ``[K, ...]``. The i-th step of a call makes the draws the
i-th of K one-step calls makes, so at one seed K and 1 train the same
steps, in one process and on W > 1 ranks. On the CPU and on W > 1 ranks
the K steps run as a loop; in one process on the card one call is one
CUDA graph, captured once and replayed (``engine/graph.py``).
:func:`build_scanned_eval_step` evaluates a chunk of K eval batches a call
(JAX's scanned eval; one CUDA graph a chunk shape on the card).

Every random draw is explicit: the ``semi`` step takes a :class:`StepDraws`
(the unlabeled batch's GeoParams and gammas, each drawing hook's draws and
the dense hooks' sampled positions; ``ft`` the drawing hooks' draws alone,
:func:`sample_ft_draws`); the cached step draws those, the sample indices
and the crop offsets from a ``torch.Generator``, and the hooks' host-side
draws (ICT's and MixUp's ``lam`` and permutation) from a numpy generator.

Data parallelism (``data_group`` of W > 1 ranks, ``parallel/``): the ``semi``
and ``ft`` steps (and the pretrain step of trainers/pretrain.py) compute
what one process computes on the global batch, as JAX's step on a sharded
batch does. Each rank holds 1/W of the batch and of the draws (every rank
draws the global batch's from the same generators and keeps its rows,
:func:`shard_step_draws`: each hook's draw, or each part of it, along its
own batch axis, or whole); BatchNorm's sums (the teachers' forwards
included), the InfoNCE anchors, the IIC joints and the IMSAT marginals are
global; each rank back-propagates its share of the loss (its per-rank
means, or a global value, over W), the gradients are summed over ranks
before the update, and the metrics are the global batch's. The hooks whose
``data_parallel`` is True run so (:func:`check_data_parallel`); W = 1 or no
group runs no collective.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..losses.kl import kl_div
from ..meters.dice import slice_intersection_union
from ..ops.affine import (GeoParams, sample_gammas, sample_geo_params,
                          transform_image, transform_logits)
from ..parallel.collectives import gather_rows, mean_over_ranks, num_ranks, sum_gradients
from ..parallel.mesh import DataGroup, data_parallel, multi_rank, shard_batch
from ..tracing import hook_span_names, span
from .bundle import ModelBundle
from .graph import EvalGraph, GraphPool, StepGraph
from .hooks import StepContext, TrainerHook, check_hook_names, combined_taps
from .state import TrainState

__all__ = ["POINT_NUMS", "StepDraws", "draw_points", "point_grids", "sample_hook_draws",
           "sample_step_draws", "sample_ft_draws", "shard_draw", "shard_step_draws", "init_train_state",
           "DATA_PARALLEL_MODES", "check_data_parallel", "commit_state",
           "build_train_step", "stack_batches", "build_unrolled_train_step",
           "build_cached_train_step", "tta_probs", "build_eval_step",
           "build_scanned_eval_step"]


class StepDraws(NamedTuple):
    geo: Optional[GeoParams]          # transform of the unlabeled batch (None: ft)
    gammas: Optional[torch.Tensor]    # [Bu] gamma of the unlabeled batch (None: ft)
    hooks: Optional[Dict[str, Any]] = None   # each drawing hook's draws, by name
    #: the dense hooks' sampled positions: grid -> (ys, xs) [Bu, P]
    points: Optional[Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]] = None


#: positions a dense hook samples per image
POINT_NUMS = 5


def draw_points(generator: torch.Generator, batch: int,
                grid: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image, :data:`POINT_NUMS` distinct rows and distinct columns of the
    ``grid`` -> (ys, xs) [batch, POINT_NUMS] long, on the generator's device."""
    if min(grid) < POINT_NUMS:
        raise ValueError(f"grid {grid}: fewer than {POINT_NUMS} rows or columns to sample")
    dev = generator.device

    def distinct(n):
        return torch.rand(batch, n, generator=generator, device=dev).argsort(1)[:, :POINT_NUMS]

    return distinct(grid[0]), distinct(grid[1])


def point_grids(hooks: Sequence[TrainerHook]) -> list:
    """The distinct grids of the dense (decoder) hooks, sorted."""
    return sorted({h.grid for h in hooks if h.grid is not None})


def sample_hook_draws(generator: torch.Generator, hooks: Sequence[TrainerHook] = (), *,
                      host_rng=None, shape: Optional[Tuple[int, ...]] = None,
                      labeled_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """Each hook's :meth:`~contrastyou_tpu_torch.engine.hooks.TrainerHook.draw`,
    in hook order, for the batch it reads: the unlabeled batch's ``shape``,
    or ``labeled_shape`` for a hook that reads no unlabeled batch (MixUp).
    Hooks that draw nothing leave the generators as they were and are left
    out."""
    drawn = {h.name: h.draw(generator, host_rng, shape if h.requires_unlabeled else labeled_shape)
             for h in hooks}
    return {k: v for k, v in drawn.items() if v is not None}


def sample_step_draws(generator: torch.Generator, batch: int,
                      hooks: Sequence[TrainerHook] = (), *, host_rng=None,
                      shape: Optional[Tuple[int, ...]] = None,
                      labeled_shape: Optional[Tuple[int, ...]] = None) -> StepDraws:
    """The transform of an unlabeled batch of ``batch`` slices, then the
    hooks' draws (:func:`sample_hook_draws`), then one :func:`draw_points`
    per distinct grid of the dense hooks, shared by the hooks on that grid as
    JAX's share one key (a run without dense hooks draws none)."""
    geo, gammas = sample_geo_params(generator, batch), sample_gammas(generator, batch)
    drawn = sample_hook_draws(generator, hooks, host_rng=host_rng, shape=shape,
                              labeled_shape=labeled_shape)
    points = {g: draw_points(generator, batch, g) for g in point_grids(hooks)}
    return StepDraws(geo, gammas, drawn, points)


def sample_ft_draws(generator: torch.Generator, hooks: Sequence[TrainerHook] = (), *,
                    host_rng=None, shape: Tuple[int, ...]) -> StepDraws:
    """The draws of an ``ft`` step on a labeled batch of ``shape``: the
    hooks' alone (no transform; a run without drawing hooks draws
    nothing)."""
    return StepDraws(None, None, sample_hook_draws(generator, hooks, host_rng=host_rng,
                                                   shape=shape, labeled_shape=shape), {})


def shard_draw(draw: Any, batch_dim, group: Optional[DataGroup]) -> Any:
    """This rank's share of one hook's draw made at the global batch:
    ``batch_dim`` an int cuts it along that axis (``parallel.shard_batch``),
    None keeps it whole, and a tuple gives each part of a tuple draw its own
    rule, in turn (MixUp's ``(geo, lam, perm)``: ``(0, None, None)``)."""
    if batch_dim is None:
        return draw
    if isinstance(batch_dim, tuple):
        if not isinstance(draw, tuple) or len(draw) != len(batch_dim):
            raise ValueError(f"a draw of {len(draw) if isinstance(draw, tuple) else 1} "
                             f"part(s) against the axes {batch_dim}")
        return tuple(shard_draw(d, a, group) for d, a in zip(draw, batch_dim))
    return shard_batch(draw, group, batch_dim)


def shard_step_draws(draws: Optional[StepDraws], hooks: Sequence[TrainerHook],
                     group: Optional[DataGroup]) -> Optional[StepDraws]:
    """This rank's share of a global batch's draws: the transform's and the
    point draws' rows, and each hook's draw cut by the hook's
    ``draw_batch_dim`` (:func:`shard_draw`: UAMT's noise [num_noise, B, ...]
    along axis 1, ICT's permutation of the global batch whole, MixUp's
    GeoParams by rows and its ``lam`` and permutation whole). Without a
    group, or with one rank, ``draws`` as they are."""
    if draws is None or multi_rank(group) is None:
        return draws
    dims = {h.name: h.draw_batch_dim for h in hooks}
    drawn = None if draws.hooks is None else {
        k: shard_draw(v, dims.get(k, 0), group) for k, v in draws.hooks.items()}
    return StepDraws(shard_batch(draws.geo, group), shard_batch(draws.gammas, group), drawn,
                     shard_batch(draws.points, group))


def init_train_state(bundle: ModelBundle, hooks: Sequence[TrainerHook],
                     optimizer: torch.optim.Optimizer) -> TrainState:
    check_hook_names(hooks)
    return TrainState(model=bundle.model, optimizer=optimizer,
                      hook_states={h.name: h.init_state(bundle) for h in hooks})


#: the step modes that run on W > 1 ranks
DATA_PARALLEL_MODES = ("semi", "ft", "pretrain")


def check_data_parallel(hooks: Sequence[TrainerHook], data_group: Optional[DataGroup], *,
                        mode: str = "semi", sup_criterion: Optional[Callable] = None) -> None:
    """Raise ``NotImplementedError`` when a step over ``data_group``'s W > 1
    ranks would compute something other than the global batch's: a mode
    other than those of :data:`DATA_PARALLEL_MODES`, a supervised criterion
    that does not declare itself a batch mean (its ``data_parallel``, as
    ``MultiCoreKL``'s), or a hook whose batch reductions are not global yet
    (``data_parallel`` False), named."""
    if multi_rank(data_group) is None:
        return
    W = data_group.size
    if mode not in DATA_PARALLEL_MODES:
        raise NotImplementedError(f"the {mode} step does not run on {W} ranks: data "
                                  f"parallelism covers the {', '.join(DATA_PARALLEL_MODES)} "
                                  f"steps")
    if sup_criterion is not None and not getattr(sup_criterion, "data_parallel", False):
        raise NotImplementedError(f"the supervised criterion {sup_criterion!r} does not run "
                                  f"on {W} ranks: data parallelism covers the KL and the "
                                  f"criteria that are batch means (data_parallel True)")
    for h in hooks:
        if not h.data_parallel:
            raise NotImplementedError(
                f"hook {h.name!r} ({type(h).__name__}) does not run on {W} ranks: its batch "
                f"reductions are not global yet (a hook runs there where its data_parallel "
                f"is True)")


@torch.no_grad()
def commit_state(old: Any, new: Any) -> Any:
    """A hook's new state (``loss``'s second value) with each tensor written
    into the tensor of the old state it replaces (same key, shape, dtype and
    device), so the state's tensors live across steps and a CUDA graph of
    the step replays the update (``engine/graph.py``); other values as
    ``new`` has them."""
    if not isinstance(old, dict) or not isinstance(new, dict):
        return new
    out = dict(new)
    for k, v in new.items():
        o = old.get(k)
        if (isinstance(v, torch.Tensor) and isinstance(o, torch.Tensor) and v is not o
                and (v.shape, v.dtype, v.device) == (o.shape, o.dtype, o.device)):
            out[k] = o.copy_(v)
    return out


def build_train_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                     disable_bn: bool = False, two_stage: bool = True, mode: str = "semi",
                     sup_criterion: Optional[Callable] = None,
                     prob_transform: Optional[Callable] = None,
                     target_num_classes: Optional[int] = None,
                     data_group: Optional[DataGroup] = None) -> Callable:
    """-> ``step(state, batch, draws, epoch=0) -> metrics`` for ``mode``
    ``semi`` or ``ft``.

    ``batch``: ``labeled_image`` [B,H,W,1], ``labeled_target`` [B,H,W] int;
    under ``semi`` also ``unlabeled_image`` [Bu,H,W,1], optional group ids
    and ``unlabeled_superpixel`` [Bu,H,W]. ``semi`` with ``two_stage``
    (the reference config's ``Trainer.two_stage``) runs one forward over
    the labeled batch, one over the unlabeled batch and its transformed copy
    (``disable_bn`` keeps the second from updating the BN running
    statistics); without it one forward over all three, with shared batch
    statistics and one running update (``disable_bn`` then plays no part,
    as in JAX). ``ft`` runs the labeled forward alone; its ``draws``
    (:func:`sample_ft_draws`, or None) carry the drawing hooks' draws only.
    ``sup_criterion(probs, onehot)`` replaces the supervised KL,
    ``prob_transform`` maps the probabilities before the dice counts and
    ``target_num_classes`` is the class count of the targets (multicore:
    the prototype channels summed to the true classes); without them the
    model's classes and the KL. The metrics stay on the device.

    ``data_group`` of W > 1 ranks: ``batch`` and ``draws`` are this rank's
    rows of the global batch's (see the module docstring); the metrics are
    the global batch's, the dice counts [W*B, C] in rank order."""
    if mode not in ("semi", "ft"):
        raise ValueError(f"mode {mode!r}: semi or ft")
    hooks = tuple(hooks)
    group = multi_rank(data_group)
    check_data_parallel(hooks, group, mode=mode, sup_criterion=sup_criterion)
    taps = combined_taps(hooks)
    num_classes = target_num_classes or bundle.num_classes
    hook_spans = hook_span_names(hooks)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[StepDraws], epoch: int = 0) -> Dict[str, torch.Tensor]:
        with data_parallel(group):
            return run(state, batch, draws, epoch)

    def run(state, batch, draws, epoch):
        with span("cy/step/forward"):
            state.model.train()
            labeled_image = batch["labeled_image"]
            labeled_target = batch["labeled_target"]
            ctx = StepContext(labeled_image=labeled_image, labeled_target=labeled_target,
                              epoch=epoch, bundle=bundle, data_group=group)
            if mode != "semi" or two_stage:
                labeled_logits, labeled_taps = bundle.apply_train(labeled_image, taps=taps)
            if draws is not None:
                ctx.hook_draws = dict(draws.hooks or {})
            if mode == "semi":
                unlabeled_image = batch["unlabeled_image"]
                nu = unlabeled_image.shape[0]
                ctx.unlabeled_image = unlabeled_image
                ctx.unlabeled_image_tf = transform_image(unlabeled_image, draws.geo, draws.gammas)
                ctx.geo_params = draws.geo
                ctx.point_draws = dict(draws.points or {})
                ctx.superpixel = batch.get("unlabeled_superpixel")
                ctx.label_group = batch.get("unlabeled_scan_id")
                ctx.partition_group = batch.get("unlabeled_partition")
                ctx.patient_group = batch.get("unlabeled_patient")
                ctx.cycle_group = batch.get("unlabeled_cycle")
                if two_stage:
                    u_logits, u_taps = bundle.apply_train(
                        torch.cat([unlabeled_image, ctx.unlabeled_image_tf], 0), taps=taps,
                        update_stats=not disable_bn)
                else:
                    nl = labeled_image.shape[0]
                    logits, all_taps = bundle.apply_train(
                        torch.cat([labeled_image, unlabeled_image, ctx.unlabeled_image_tf], 0),
                        taps=taps)
                    labeled_logits, u_logits = logits[:nl], logits[nl:]
                    labeled_taps = {k: v[:nl] for k, v in all_taps.items()}
                    u_taps = {k: v[nl:] for k, v in all_taps.items()}
                ctx.unlabeled_logits, ctx.unlabeled_tf_logits = u_logits[:nu], u_logits[nu:]
                ctx.unlabeled_logits_tf = transform_logits(ctx.unlabeled_logits, draws.geo)
                ctx.unlabeled_taps = {k: v[:nu] for k, v in u_taps.items()}
                ctx.unlabeled_tf_taps = {k: v[nu:] for k, v in u_taps.items()}
            ctx.labeled_logits, ctx.labeled_taps = labeled_logits, labeled_taps

            onehot = F.one_hot(labeled_target.long(), num_classes).float()
            probs = torch.softmax(labeled_logits, -1)
            sup_loss = (kl_div(probs, onehot) if sup_criterion is None
                        else sup_criterion(probs, onehot))
            reg_loss = sup_loss.new_zeros(())
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
                # copies: a metric may be a state tensor that the commit below overwrites
                metrics.update({f"{hook.name}/{k}": v.detach().clone()
                                for k, v in h_metrics.items()})
            total = sup_loss + reg_loss

        with span("cy/step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            if group is None:
                total.backward()
            else:
                # this rank's share: the shares of the ranks sum to the global loss
                (total / group.size).backward()
                sum_gradients([p for g in state.optimizer.param_groups for p in g["params"]],
                              group)
        with span("cy/step/optimizer"):
            state.optimizer.step()
        with span("cy/step/commit"):
            for name, h_state in new_states.items():
                state.hook_states[name] = commit_state(state.hook_states[name], h_state)
            for hook in hooks:
                state.hook_states[hook.name] = hook.post_step(
                    ctx, state.model, state.hook_states[hook.name])
            state.step += 1

            pred = probs.detach() if prob_transform is None else prob_transform(probs.detach())
            inter, union = slice_intersection_union(pred.argmax(-1), labeled_target,
                                                    num_classes=num_classes)
            metrics.update(sup_loss=sup_loss.detach(), reg_loss=reg_loss.detach(),
                           total_loss=total.detach())
            if group is not None:
                metrics = mean_over_ranks(metrics, group)
                inter, union = gather_rows(inter, group), gather_rows(union, group)
            metrics.update(dice_inter=inter, dice_union=union)
        return metrics

    return step


def _with_lr(state: TrainState, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's metrics plus ``lr``, the learning rate of its update."""
    lr = getattr(state.optimizer, "lr", None)
    if isinstance(lr, torch.Tensor):
        metrics["lr"] = lr.clone()
    return metrics


def stack_batches(batches: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """K batch (or metric) dicts -> one dict of [K, ...] tensors."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def build_unrolled_train_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                              unroll: int, data_group: Optional[DataGroup] = None,
                              **kwargs) -> Callable:
    """-> ``unrolled(state, batches, draws, epoch=0) -> metrics``: ``unroll``
    steps of :func:`build_train_step` (``**kwargs`` as there), the i-th on
    ``batches``' i-th rows (each value stacked [K, ...], :func:`stack_batches`)
    and ``draws[i]``. Every metric comes back stacked [K, ...], plus ``lr``
    [K], each update's learning rate. On the card one call is one CUDA graph
    (``engine/graph.py``); on the CPU, and on W > 1 ranks (``data_group``:
    ``batches`` and ``draws`` this rank's rows of each step's, as
    :func:`build_train_step` takes them), the steps run as a loop."""
    hooks = tuple(hooks)
    step = build_train_step(bundle, hooks, data_group=data_group, **kwargs)

    def body(state, inputs, epoch):
        batches, draws = inputs
        return stack_batches([
            _with_lr(state, step(state, {k: v[i] for k, v in batches.items()}, draws[i], epoch))
            for i in range(unroll)])

    graph = StepGraph(body, unroll=unroll, capture=multi_rank(data_group) is None,
                      name=f"the unrolled {kwargs.get('mode', 'semi')} step")

    def unrolled(state: TrainState, batches: Dict[str, torch.Tensor],
                 draws: Sequence[Optional[StepDraws]], epoch: int = 0) -> Dict[str, torch.Tensor]:
        if len(draws) != unroll or any(v.shape[0] != unroll for v in batches.values()):
            raise ValueError(f"{len(draws)} draws and batches of {[v.shape[0] for v in batches.values()]} "
                             f"steps for a call of {unroll}")
        return graph(state, (batches, list(draws)), epoch)

    unrolled.graph = graph
    return unrolled


def build_cached_train_step(bundle: ModelBundle, hooks: Sequence[TrainerHook], *,
                            labeled_cache, unlabeled_cache=None,
                            labeled_batch: int = 5, unlabeled_batch: int = 5,
                            data_group: Optional[DataGroup] = None, unroll: int = 1,
                            **kwargs) -> Callable:
    """-> ``cached_step(state, generator, epoch=0, host_rng=None) -> metrics``:
    one ``semi`` step whose batch is sampled and cropped on the device from
    the two :class:`~contrastyou_tpu_torch.data.device_cache.DeviceDataCache` s,
    the hooks' draws made after the transform's (host-side ones from the
    numpy ``host_rng``), or without an ``unlabeled_cache`` one ``ft`` step
    on the labeled cache's batch alone, with the hooks' draws; the metrics
    also carry ``labeled_scan_id`` [B].

    ``unroll`` = K > 1: ``unroll`` such steps a call, each drawing as a call
    of one step does (so K and 1 train the same steps from one generator);
    every metric comes back stacked [K, ...] (``labeled_scan_id`` [K, B]),
    plus ``lr`` [K]. All K steps' draws (indices, crops, transforms, hook
    draws) are made before the steps; on the card the K steps are one CUDA
    graph that reads them (``engine/graph.py``, ``cached_step.graph``).
    ``cached_step.run(state, draws, epoch)`` runs the steps of a list of
    draws of one step each (``{"labeled": (idx, oy, ox), "unlabeled": ...,
    "draws": StepDraws}``).

    ``data_group`` of W ranks, each holding the whole caches (JAX's
    ``place_on_mesh`` replicates them): the batches are per rank, so every
    rank draws the global batch of W times as many slices, and its draws,
    from the same generator and keeps its rows; ``labeled_scan_id`` is the
    global batch's. At K > 1 on W > 1 ranks each of the K steps draws its
    global batch so and the K steps run as a loop, not a graph (the ranks'
    collectives are not captured; ``engine/graph.py``)."""
    semi = unlabeled_cache is not None
    W = num_ranks(data_group)
    hooks = tuple(hooks)
    needs_map = [h.name for h in hooks if h.needs_superpixel]
    if needs_map:
        raise ValueError(f"hooks {needs_map} read the superpixel map, which the device "
                         f"cache does not carry: train them host-fed "
                         f"(Trainer.device_cache=false)")
    step = build_train_step(bundle, hooks, mode="semi" if semi else "ft",
                            data_group=data_group, **kwargs)
    crop = labeled_cache.crop
    labeled_shape = (labeled_batch * W, crop, crop, 1)

    def draw(generator: torch.Generator, host_rng=None) -> dict:
        """One step's draws, in the order of the step: the labeled batch,
        the unlabeled batch, the transform and the hooks'."""
        with span("cy/data/draw"):
            drawn = {"labeled": labeled_cache.draw(generator, labeled_batch * W)}
            if semi:
                drawn["unlabeled"] = unlabeled_cache.draw(generator, unlabeled_batch * W)
                shape = (unlabeled_batch * W, unlabeled_cache.crop, unlabeled_cache.crop, 1)
                drawn["draws"] = sample_step_draws(generator, shape[0], hooks,
                                                   host_rng=host_rng, shape=shape,
                                                   labeled_shape=labeled_shape)
            else:
                drawn["draws"] = sample_ft_draws(generator, hooks, host_rng=host_rng,
                                                 shape=labeled_shape)
            return drawn

    def one(state: TrainState, drawn: dict, epoch: int) -> Dict[str, torch.Tensor]:
        with span("cy/data/draw"):
            lab = labeled_cache.sample_at(*drawn["labeled"])
            batch = {"labeled_image": lab["image"], "labeled_target": lab["target"]}
            if semi:
                unl = unlabeled_cache.sample_at(*drawn["unlabeled"])
                batch.update(unlabeled_image=unl["image"], unlabeled_partition=unl["partition"],
                             unlabeled_scan_id=unl["scan_id"], unlabeled_patient=unl["patient"],
                             unlabeled_cycle=unl["cycle"])
        metrics = step(state, shard_batch(batch, data_group),
                       shard_step_draws(drawn["draws"], hooks, data_group), epoch)
        metrics["labeled_scan_id"] = lab["scan_id"]
        return metrics

    def body(state, drawn_list, epoch):
        return stack_batches([_with_lr(state, one(state, d, epoch)) for d in drawn_list])

    graph = StepGraph(body, unroll=unroll, capture=multi_rank(data_group) is None,
                      name=f"the device-cached {'semi' if semi else 'ft'} step")

    def run(state: TrainState, drawn_list: Sequence[dict], epoch: int = 0):
        return graph(state, list(drawn_list), epoch)

    def cached_step(state: TrainState, generator: torch.Generator, epoch: int = 0,
                    host_rng=None):
        if unroll == 1:
            return one(state, draw(generator, host_rng), epoch)
        return run(state, [draw(generator, host_rng) for _ in range(unroll)], epoch)

    cached_step.run, cached_step.graph = run, graph
    return cached_step


def _probs(model: torch.nn.Module, image: torch.Tensor,
           prob_transform: Optional[Callable]) -> torch.Tensor:
    p = torch.softmax(model(image, train=False)[0], -1)
    return p if prob_transform is None else prob_transform(p)


def tta_probs(model: torch.nn.Module, image: torch.Tensor,
              prob_transform: Optional[Callable] = None) -> torch.Tensor:
    """Test-time augmentation: the mean class probability (after
    ``prob_transform``) over the four axis flips of the NHWC ``image``
    (none, W, H, both), each flipped back."""
    def probs(dims):
        x = torch.flip(image, dims) if dims else image
        p = _probs(model, x, prob_transform)
        return torch.flip(p, dims) if dims else p

    return (probs(()) + probs((2,)) + probs((1,)) + probs((1, 2))) / 4.0


def _eval_counts(probs: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                 num_classes: int) -> tuple:
    """(loss, pred, inter, union) of one eval batch from its class
    probabilities: the KL to the one-hot target per pixel, averaged per
    sample and over the ``mask``-ed samples; the argmax; per-sample [B, C]
    dice counts zeroed where ``mask`` is False."""
    per_px = kl_div(probs, F.one_hot(target.long(), num_classes).float(), reduction="none")
    m = mask.float()
    loss = (per_px.mean((1, 2)) * m).sum() / m.sum().clamp(min=1.0)
    pred = probs.argmax(-1)
    inter, union = slice_intersection_union(pred, target, num_classes=num_classes)
    mi = mask.long()[:, None]
    return loss, pred, inter * mi, union * mi


def build_eval_step(bundle: ModelBundle, *, tta: bool = False,
                    prob_transform: Optional[Callable] = None,
                    target_num_classes: Optional[int] = None) -> Callable:
    """-> ``eval_step(model, image, target, mask) -> (loss, pred, inter,
    union)``, under ``torch.no_grad``: the running-statistics forward of
    ``model`` (the bundle's or an eval model of the same classes), or its
    flip average with ``tta``; ``loss`` the KL to the one-hot target per
    pixel, averaged per sample and over the ``mask``-ed samples; ``pred`` the
    argmax [B,H,W]; per-sample [B, C] dice counts zeroed where ``mask`` is
    False. ``prob_transform`` and ``target_num_classes`` as in
    :func:`build_train_step`."""
    num_classes = target_num_classes or bundle.num_classes

    @torch.no_grad()
    def eval_step(model, image, target, mask):
        if tta:
            probs = tta_probs(model, image, prob_transform)
        else:
            probs = _probs(model, image, prob_transform)
        return _eval_counts(probs, target, mask, num_classes)

    return eval_step


def build_scanned_eval_step(bundle: ModelBundle, *, prob_transform: Optional[Callable] = None,
                            target_num_classes: Optional[int] = None,
                            pool: Optional[GraphPool] = None) -> Callable:
    """-> ``scanned(model, images [K,B,H,W,1], targets [K,B,H,W], masks
    [K,B]) -> (loss [K], inter [K,B,C], union [K,B,C])``, JAX's
    ``build_scanned_eval_step``: each of the K stacked eval batches as
    :func:`build_eval_step` (no TTA) takes it, a padded batch (mask all
    False) giving loss 0 and zero counts. On the CPU a loop over K; on a
    CUDA device one graph per chunk shape and eval model, captured at the
    second call and replayed (``engine/graph.py`` ``EvalGraph``,
    ``scanned.graph``; ``pool``: the memory pool it shares, the train
    graph's)."""
    num_classes = target_num_classes or bundle.num_classes

    @torch.no_grad()
    def body(model, images, targets, masks):
        outs = [_eval_counts(_probs(model, x, prob_transform), y, m, num_classes)
                for x, y, m in zip(images.unbind(0), targets.unbind(0), masks.unbind(0))]
        return (torch.stack([o[0] for o in outs]), torch.stack([o[2] for o in outs]),
                torch.stack([o[3] for o in outs]))

    graph = EvalGraph(body, name="the chunked eval step", pool=pool)

    def scanned(model, images, targets, masks):
        return graph(model, images, targets, masks)

    scanned.graph = graph
    return scanned
