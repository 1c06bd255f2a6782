"""Trainer: the epoch loop around the steps (counterpart of
contrastyou_tpu/engine/trainer.py): per epoch the hooks' ``on_epoch_start``,
``num_batches`` train steps (``train_mode`` ``semi``, or ``ft``: the labeled
batch alone), validation and test passes over whole scans,
one ``storage.csv`` row, the ``last`` checkpoint and, on a higher
validation ``DSC_mean``, ``best``; ``.success`` at the end. A run resumes
from a checkpoint with its epoch, best score and metric history.

Warm starts leave the optimizer, RAdam's update count and the hooks fresh:
:meth:`Trainer.load_pretrained` (``Arch.pretrained_path``, an npz archive of
flax-keyed paths merged into the model, BN statistics included, at
:meth:`Trainer.init`) and :meth:`Trainer.load_model_params`
(``Arch.checkpoint``: the parameters alone, the BN statistics stay fresh).

Input: host-fed by default (the loaders' numpy batches, each step's
transform draws from a ``torch.Generator``), or with ``device_cache`` the
train split staged on the device, where each step samples and crops its own
batch. The generator is reseeded at each epoch from ``(seed, 10_000 +
epoch)``, as JAX folds ``10_000 + epoch`` into its key, so a resumed
device-cached run reproduces an unbroken one; the host loaders restart from
their seeds on resume, as the JAX package's do. The hooks' host-side draws
(ICT's and MixUp's ``lam`` and permutation) come from a numpy generator
reseeded from ``(seed, 30_000 + epoch)``.

Evaluation and inference run on the student, or on the model of the hook
given to :meth:`Trainer.set_model4inference` (a mean teacher, an EMA of
the student): its parameters and BN statistics (the student's when it
offers none) copied into an eval copy of the model before each pass.

Progress goes to the ``logging`` logger of this module. Each phase's host
time is logged with ``extra={"timing": {...}}`` (``phase`` train / val /
test / inference / save / events / profile, its ``seconds`` and counts),
for callers that time the loop. Beside ``storage.csv`` each epoch's
statistics go to TensorBoard events under JAX's tags, step = epoch
(``writer.py``, ``<save_dir>/tensorboard``; a resumed run adds a file), and
the ``fig/`` metrics of each epoch's first step (hook figures: the
cross-correlation block's joint, InfoNCE's similarities) are logged as
images there by ``hooks/savers.py`` ``joint_2D_figure`` and kept out of the
meters. ``Trainer.profile`` (or a non-empty ``CONTRASTYOU_PROFILE``) runs
epoch index 1 under ``torch.profiler`` (CPU and, on the card, CUDA
activity; the first epoch pays the first launches), from the hooks' epoch
start to its storage row: the Chrome trace goes to
``<save_dir>/profile/epoch_001.pt.trace.json`` beside ``launches.json``,
the hand-written kernels' launch counts and the CUDA graphs' counts
(:func:`graph_stats`) over the same window; on the card a trace without
device kernels is removed and the run raises, and that epoch's timing
records carry ``profiled: True``. The trace holds the port's host spans
(``tracing.py``): ``cy/train/call`` and ``cy/train/meters`` for each call
of the train step and the meters after it, ``cy/data/host_batch`` for a
host-fed step's batch and draws, ``cy/eval/chunk`` and ``cy/eval/readback``
for each eval chunk, and inside them the graph's, the step's and the
draws' spans.

``unroll_steps`` = K runs K train steps a call, as JAX's trainer:
``num_batches // K`` calls an epoch (JAX's warning when K does not divide
``num_batches``), each call's metrics stacked [K, ...] and taken into the
meters step by step (so the epoch's statistics are those of K calls of
one step, where JAX adds their mean with weight K), the dice counts per
scan over the K x B rows, ``state.step`` advanced by K. The i-th step of
a call draws as the i-th of K one-step calls does, so K and 1 train the
same steps. On the card
a call is one CUDA graph (``engine/graph.py``), host-fed batches reaching it
through pinned memory; on the CPU, and on W > 1 ranks (whose collectives
are not captured), the K steps run as a loop. Trainers that build their
own step (``adv``, pretraining) refuse K > 1. The train ``timing`` record
carries ``graph``: whether the epoch's calls replayed a CUDA graph, and the
epoch's ``captures`` of it and their host seconds, ``capture_s`` (the
graph is captured again each epoch, which the hooks read as a host
number).

Evaluation (JAX's ``eval_epoch``): a validation or test pass takes its
batches (one scan each, padded to the longest) in chunks of
:attr:`Trainer.EVAL_CHUNK`; a pass of more batches pads its last chunk to
that many with masked copies of its last batch, so every chunk has one
shape. A chunk is one call of ``build_scanned_eval_step`` (on the card one
CUDA graph per chunk shape and eval model, captured at its second call and
replayed after), its stacked batches reaching the device through pinned
memory, its losses and counts read back once; the ``timing`` record
carries ``batches``, ``chunks`` and ``graph``. Inference stays one scan a
call (TTA, the predictions, the surface distances).

``two_stage`` (``semi`` steps) picks two forwards (labeled, then unlabeled
and transformed) or one over all three; ``accumulate_iter`` makes the
optimizer ``optax.MultiSteps`` (``engine/optim.py``): BN statistics and the
hooks' post-steps move on every step, the parameters every k-th.

Data parallelism (``data_group``, in place of JAX's ``mesh``; a trainer
whose ``data_parallel`` is False refuses W > 1 ranks): the model and hook
heads are broadcast from rank 0 at :meth:`Trainer.init`; the loaders' batch
sizes are per rank. Host-fed, each rank's loaders read its stride of the
indices (``InfiniteRandomSampler(process_index=, process_count=)``); with
the device cache every rank draws the global batch and keeps its rows, so
the run is the one-process run at W times the batch. The step's metrics
are global, so every rank's meters hold the global values. Eval shards
the batch axis of a chunk whose batches divide by W (each rank evaluates
its rows, with no collective inside the chunk's graph), then sums the
chunk's loss numerators and counts over the ranks and gathers its dice
counts in row order, two collectives a chunk; a chunk of batches that do
not divide is evaluated whole on every rank. Only rank 0 writes
``config.yaml``, ``storage.csv``, the checkpoints, ``.success`` and
``inference_result.json``, the events and the trace; a resume loads on
every rank.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import logging
import os
import re
import time
import typing as t
from pathlib import Path

import numpy as np
import torch

import contrastyou_tpu_torch as package
from ..configure.config import yaml_write
from ..indicator import Indicator
from ..data.device_cache import DeviceDataCache
from ..meters.averages import AverageValueDictionaryMeter, AverageValueMeter
from ..meters.dice import UniversalDice
from ..meters.interface import MeterInterface
from ..meters.storage import Storage
from ..ops import convblock, iic, supcon
from ..parallel.collectives import all_reduce_sum, gather_rows, num_ranks
from ..parallel.mesh import DataGroup, multi_rank, replicate, shard_batch
from ..tracing import span
from ..utils.torch_convert import load_pretrained
from ..writer import SummaryWriter
from .bundle import ModelBundle
from .checkpoint import (load_checkpoint, load_model_params, load_train_state, save_checkpoint,
                         train_state_dict)
from .graph import GRAPH_STATS
from .hooks import TrainerHook, hook_parameters
from .optim import create_optimizer
from .steps import (build_cached_train_step, build_eval_step, build_scanned_eval_step,
                    build_train_step, build_unrolled_train_step, init_train_state,
                    sample_ft_draws, sample_step_draws, shard_step_draws, stack_batches)

__all__ = ["Trainer", "epoch_seed", "hook_metrics", "kernel_launches", "graph_stats",
           "HOOK_DRAW_SEED_OFFSET", "PROFILE_EPOCH"]

logger = logging.getLogger(__name__)

#: offset of the hooks' host generator's per-epoch seed
HOOK_DRAW_SEED_OFFSET = 30_000
#: the epoch index ``Trainer.profile`` traces (as JAX's trainer)
PROFILE_EPOCH = 1
#: a device kernel's event in a Chrome trace
_KERNEL_EVENT = re.compile(rb'"cat"\s*:\s*"kernel"')


def hook_metrics(metrics: dict, hook_name: str) -> dict:
    """The step metrics ``<hook_name>/...`` of one hook, keyed and ordered
    as the JAX trainers hand them to their meters (and so as
    ``storage.csv``'s columns): without the name's first path component
    only, so ``infonce/Conv5/self/loss`` is kept as ``Conv5/self/loss``, in
    sorted order (a jitted step returns its metrics dict sorted); the
    ``<hook_name>/fig/...`` figure tensors are left out."""
    return {k.split("/", 1)[1]: metrics[k] for k in sorted(metrics)
            if k.startswith(hook_name + "/") and "/fig/" not in k}


def kernel_launches() -> t.Dict[str, int]:
    """The hand-written kernels' launch counts so far in this process (the
    ``ops`` modules' counters; none on the CPU, where the plain versions
    run)."""
    return {**convblock.LAUNCHES, **supcon.LAUNCHES, **iic.LAUNCHES}


def graph_stats() -> t.Dict[str, float]:
    """The CUDA graphs' warm-ups, captures and replays so far in this
    process, by kind (``step_*``, ``eval_*``), and the host seconds of their
    captures by kind (``step_capture_s``, ``eval_capture_s``)
    (``engine/graph.py`` ``GRAPH_STATS``; zeros on the CPU)."""
    return dict(GRAPH_STATS)


def _graph_counts(step) -> tuple:
    """(replays, captures, capture seconds) of a built step's CUDA graph so
    far (zeros without a graph)."""
    graph = getattr(step, "graph", None)
    return (getattr(graph, "replays", 0), getattr(graph, "captures", 0),
            getattr(graph, "capture_s", 0.0))


def epoch_seed(seed: int, epoch: int, offset: int = 10_000) -> int:
    """The step generator's seed in ``epoch`` (JAX folds ``offset + epoch``
    into its key: 10_000 in training, 20_000 in pretraining)."""
    return int(np.random.SeedSequence([int(seed), offset + int(epoch)]).generate_state(1)[0])


class Trainer:
    """Generic trainer; ``trainers/`` subclasses pick the step mode."""

    #: eval batches a call (JAX's ``Trainer.EVAL_CHUNK``)
    EVAL_CHUNK: int = 32

    activate_hooks: bool = True
    train_mode: str = "semi"        # "semi" | "ft"
    #: whether ``main`` ends a run with :meth:`inference` (SemiTrainer and
    #: its subclasses; not the pretraining or adversarial trainers)
    runs_inference: bool = False
    #: whether the trainer runs on a ``data_group`` of W > 1 ranks
    data_parallel: bool = False
    #: why it does not, where ``data_parallel`` is False
    data_parallel_refusal: str = "its batch reductions are not global yet"
    #: why the trainer runs one step a call whatever ``unroll_steps`` is
    #: (it builds its own step and loop), or None where it takes K
    unroll_refusal: t.Optional[str] = None

    @classmethod
    def active_hooks(cls, hooks: t.Sequence[TrainerHook]) -> t.List[TrainerHook]:
        """The hooks that run under this trainer: all of them, or with
        ``activate_hooks`` False (ft, adv) only the loss-free
        ``always_active`` ones (the EMA eval model)."""
        return list(hooks) if cls.activate_hooks else [h for h in hooks if h.always_active]

    def __init__(self, *, model: torch.nn.Module, labeled_loader, unlabeled_loader=None,
                 val_loader=None, test_loader=None, save_dir: str = "tmp",
                 max_epoch: int = 100, num_batches: int = 100,
                 config: t.Optional[t.Mapping] = None, two_stage: bool = True,
                 disable_bn: bool = False, accumulate_iter: int = 1,
                 enable_scale: bool = False, seed: int = 10, device_cache: bool = False,
                 unroll_steps: int = 1, profile: bool = False,
                 criterion: t.Optional[t.Callable] = None,
                 prob_transform: t.Optional[t.Callable] = None,
                 target_num_classes: t.Optional[int] = None,
                 data_group: t.Optional[DataGroup] = None, **kwargs):
        del enable_scale, kwargs  # bf16 needs no loss scaling; other keys are the JAX trainer's
        self._group = multi_rank(data_group)
        if self._group is not None and not self.data_parallel:
            raise NotImplementedError(
                f"{type(self).__name__} does not run on {self._group.size} ranks: "
                f"{self.data_parallel_refusal} (a trainer runs there where its "
                f"data_parallel is True)")
        self._unroll = int(unroll_steps)
        if self._unroll < 1:
            raise ValueError(f"Trainer.unroll_steps={unroll_steps!r}: at least 1")
        if self._unroll > 1 and self.unroll_refusal is not None:
            raise NotImplementedError(f"{type(self).__name__} does not take "
                                      f"Trainer.unroll_steps={self._unroll}: "
                                      f"{self.unroll_refusal}")
        self._profile = bool(profile) or bool(os.environ.get("CONTRASTYOU_PROFILE"))
        self._profiling = False
        self._model = model
        # the multicore trainer's supervised criterion, probability transform
        # and true class count (engine/steps.py build_train_step)
        self._criterion, self._prob_transform = criterion, prob_transform
        self._target_num_classes = target_num_classes
        self._labeled_loader, self._unlabeled_loader = labeled_loader, unlabeled_loader
        self._val_loader, self._test_loader = val_loader, test_loader
        save_dir = Path(save_dir)
        if not save_dir.is_absolute():
            save_dir = Path(package.RUN_PATH) / save_dir
        save_dir.mkdir(parents=True, exist_ok=True)
        self._save_dir = str(save_dir)
        self._max_epoch, self._num_batches = int(max_epoch), int(num_batches)
        self._config = dict(config) if config else {}
        self._disable_bn = bool(disable_bn)
        self._two_stage = bool(two_stage)
        self._accumulate_iter = int(accumulate_iter)
        self._seed = int(seed)
        self._device_cache = bool(device_cache)
        self._hooks: t.List[TrainerHook] = []
        self._inference_hook: t.Optional[TrainerHook] = None
        self._eval_model: t.Optional[torch.nn.Module] = None
        self._pretrained_path: t.Optional[str] = None
        self._cur_epoch = 0
        self._best_score = -np.inf
        self._initialized = False
        self._storage = Storage(self._save_dir, write=self.is_master)
        self._writer = SummaryWriter(self._save_dir, write=self.is_master)
        if self._config and self.is_master:
            yaml_write(self._config, self._save_dir, "config.yaml")

    @property
    def is_master(self) -> bool:
        """Whether this process writes the run's files (rank 0, or the only one)."""
        return self._group is None or self._group.rank == 0

    # --- hooks ------------------------------------------------------------
    def register_hooks(self, *hooks: TrainerHook) -> None:
        if self._initialized:
            raise RuntimeError("register hooks before init()")
        self._hooks.extend(hooks)

    def set_model4inference(self, hook: TrainerHook) -> None:
        """Evaluate and infer with ``hook``'s eval model (its
        ``eval_params``)."""
        self._inference_hook = hook

    # --- initialization ---------------------------------------------------
    @property
    def device(self) -> torch.device:
        return next(self._model.parameters()).device

    def init(self) -> None:
        self._bundle = ModelBundle(self._model, self._labeled_loader.item_shape)
        if self._pretrained_path is not None:
            loaded, skipped = load_pretrained(self._model, self._pretrained_path)
            logger.info("pretrained warm start from %s: %d tensors loaded, %d of another "
                        "shape skipped", self._pretrained_path, len(loaded), len(skipped))
        self._active_hooks = self.active_hooks(self._hooks)
        self._optimizer, self._schedule = create_optimizer(
            self._trainable_parameters() + hook_parameters(self._active_hooks),
            self._config.get("Optim", {}), self._config.get("Scheduler", {}),
            max_epoch=self._max_epoch, steps_per_epoch=self._num_batches,
            accumulate_iter=self._accumulate_iter)
        if self._inference_hook is not None and self._inference_hook not in self._active_hooks:
            raise RuntimeError(f"the eval model's hook {self._inference_hook.name!r} is not "
                               f"active under {type(self).__name__}")
        self._state = init_train_state(self._bundle, self._active_hooks, self._optimizer)
        for module in (self._model, *self._active_hooks):
            if isinstance(module, torch.nn.Module):
                replicate(module, self._group)
        self._build_steps()
        self._initialized = True

    def _trainable_parameters(self) -> t.List[torch.nn.Parameter]:
        """The model parameters the optimizer updates (pretraining freezes some)."""
        return list(self._model.parameters())

    # --- warm starts -------------------------------------------------------
    def load_pretrained(self, path: str) -> None:
        """Schedule the ``Arch.pretrained_path`` warm start (applied by
        :meth:`init`)."""
        if self._initialized:
            raise RuntimeError("load_pretrained before init()")
        self._pretrained_path = str(path)

    def load_model_params(self, params: t.Mapping[str, torch.Tensor]) -> None:
        """Warm-start the model's parameters after :meth:`init`
        (``Arch.checkpoint``,
        :func:`~contrastyou_tpu_torch.engine.checkpoint.extract_model_params`)."""
        if not self._initialized:
            raise RuntimeError("init() before load_model_params")
        load_model_params(self._model, params)

    @property
    def num_classes(self) -> int:
        return self._target_num_classes or self._bundle.num_classes

    def _eval_kwargs(self) -> dict:
        return dict(prob_transform=self._prob_transform,
                    target_num_classes=self._target_num_classes)

    @property
    def _semi(self) -> bool:
        return self.train_mode == "semi"

    def _build_steps(self) -> None:
        kw = dict(disable_bn=self._disable_bn, two_stage=self._two_stage,
                  sup_criterion=self._criterion, data_group=self._group,
                  **self._eval_kwargs())
        if self._device_cache:
            crop = int(self._bundle.input_shape[0])
            self._labeled_cache = DeviceDataCache.from_dataset(
                self._labeled_loader.dataset, crop=crop, device=self.device)
            unlabeled_cache = (DeviceDataCache.from_dataset(
                self._unlabeled_loader.dataset, crop=crop, device=self.device)
                if self._semi else None)
            self._train_step = build_cached_train_step(
                self._bundle, self._active_hooks, labeled_cache=self._labeled_cache,
                unlabeled_cache=unlabeled_cache,
                labeled_batch=self._labeled_loader.batch_size,
                unlabeled_batch=self._unlabeled_loader.batch_size if self._semi else 0,
                unroll=self._unroll, **kw)
        elif self._unroll > 1:
            self._train_step = build_unrolled_train_step(
                self._bundle, self._active_hooks, unroll=self._unroll, mode=self.train_mode, **kw)
        else:
            self._train_step = build_train_step(self._bundle, self._active_hooks,
                                                mode=self.train_mode, **kw)
        self._eval_step = build_eval_step(self._bundle, **self._eval_kwargs())

    def _train_iterators(self):
        """The train loaders' iterators, made once per run (``ft`` reads no
        unlabeled batch)."""
        if not hasattr(self, "_labeled_iter"):
            self._labeled_iter = iter(self._labeled_loader)
            self._unlabeled_iter = iter(self._unlabeled_loader) if self._semi else None
        return self._labeled_iter, self._unlabeled_iter

    #: the attributes holding the run's loader iterators (kept across epochs)
    _ITERATORS = ("_labeled_iter", "_unlabeled_iter", "_contrast_iter", "_monitor_iter")

    def _pause_iterators(self) -> None:
        """Stop the loader iterators' prefetch threads at an epoch's end: the
        batches they made stay for the next epoch, which restarts them, so
        the stream is the one an unbroken iterator gives."""
        for name in self._ITERATORS:
            pause = getattr(getattr(self, name, None), "pause", None)
            if pause is not None:
                pause()

    @contextlib.contextmanager
    def _closing_iterators(self):
        """Close the run's loader iterators (and their threads) when the run
        ends, however it ends; a later run makes new ones."""
        try:
            yield
        finally:
            for name in self._ITERATORS:
                it = self.__dict__.pop(name, None)
                close = getattr(it, "close", None)
                if close is not None:
                    close()

    def _to_device(self, a: np.ndarray, pinned: bool = False) -> torch.Tensor:
        """``a`` on the device; ``pinned``: through pinned memory, without
        waiting (on the card)."""
        x = torch.from_numpy(np.ascontiguousarray(a))
        if pinned and self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _host_batch(self, labeled: dict, unlabeled: t.Optional[dict]) -> dict:
        pinned = self._unroll > 1

        def dev(a):
            return self._to_device(a, pinned)

        batch = {"labeled_image": dev(labeled["image"]),
                 "labeled_target": dev(labeled["target"]).long()}
        if unlabeled is not None:
            batch["unlabeled_image"] = dev(unlabeled["image"])
            batch.update({f"unlabeled_{k}": dev(unlabeled[k]).long()
                          for k in ("partition", "scan_id", "patient", "cycle")})
            if "superpixel" in unlabeled:
                batch["unlabeled_superpixel"] = dev(unlabeled["superpixel"]).long()
        return batch

    def _global_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the global batch whose rows ``x`` holds on this rank."""
        W = num_ranks(self._group)
        return (x.shape[0] * W, *x.shape[1:])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- training ---------------------------------------------------------
    def start_training(self) -> float:
        if not self._initialized:
            raise RuntimeError("call init() first")
        with self._writer, self._closing_iterators():
            for epoch in range(self._cur_epoch, self._max_epoch):
                self._cur_epoch = epoch
                with self._epoch_profile(epoch):
                    for hook in self._active_hooks:
                        self._state.hook_states[hook.name] = hook.on_epoch_start(
                            self._state.hook_states[hook.name], epoch)
                    with self._storage:
                        stages = {"tra": self.tra_epoch(epoch)}
                        cur_score = None
                        if self._val_loader is not None:
                            stages["val"], cur_score = self.eval_epoch(self._val_loader, epoch,
                                                                       "val")
                        if self._test_loader is not None:
                            stages["test"], _ = self.eval_epoch(self._test_loader, epoch, "test")
                        self._storage.add_from_meter_interface(epoch=epoch, **stages)
                        self._write_events(epoch, stages)
                # the best score is updated before ``last`` is written (JAX writes
                # ``last`` first, so a run resumed from it forgets this epoch's best)
                improved = cur_score is not None and cur_score > self._best_score
                if improved:
                    self._best_score = float(cur_score)
                self.save_to("last")
                if improved:
                    self.save_to("best")
                tra = stages["tra"]["tra"]
                logger.info("epoch %d/%d: sup %.5f reg %.5f sup DSC_mean %.4f, val DSC_mean %s",
                            epoch + 1, self._max_epoch, tra["sup_loss"],
                            tra.get("reg_loss", 0.0), tra["sup_dice"]["DSC_mean"],
                            "-" if cur_score is None else f"{cur_score:.4f}")
        if self.is_master:
            package.success(self._save_dir)
        return self._best_score

    # --- observability ------------------------------------------------------
    def _write_events(self, epoch: int, stages: dict) -> None:
        """The epoch's statistics as TensorBoard scalars (JAX's tags, step =
        epoch), flushed; the time and the file's size are logged."""
        if not self.is_master:
            return
        t0 = time.perf_counter()
        self._writer.add_scalars_from_meter_interface(epoch=epoch, **stages)
        self._writer.flush()
        seconds = time.perf_counter() - t0
        size = self._writer.path.stat().st_size
        logger.info("events of epoch %d: %s, %d bytes, written in %.3f ms", epoch,
                    self._writer.path.name, size, seconds * 1e3,
                    extra={"timing": {"phase": "events", "epoch": epoch, "seconds": seconds,
                                      "bytes": size}})

    def _log_figures(self, metrics: dict, epoch: int) -> None:
        """The ``fig/`` tensors of a step's metrics (the first step of an
        epoch) as TensorBoard images, tag ``<hook>/<name>``, the first 2-D
        slice of each (JAX trainer ``log_figures``)."""
        if not self.is_master:
            return
        from ..hooks.savers import joint_2D_figure
        for k, v in metrics.items():
            if "fig/" not in k:
                continue
            mat = v.detach().float().cpu().numpy()
            while mat.ndim > 2:
                mat = mat[0]
            try:
                joint_2D_figure(mat, tb_writer=self._writer, cur_epoch=epoch,
                                tag=k.replace("fig/", ""))
            except (ValueError, RuntimeError, OSError) as e:
                logger.warning("figure logging failed for %s: %s", k, e)

    @contextlib.contextmanager
    def _epoch_profile(self, epoch: int):
        """``epoch`` under ``torch.profiler`` when ``Trainer.profile`` asks
        for it and ``epoch`` is :data:`PROFILE_EPOCH` (rank 0 alone); the
        trace and the window's kernel launches go to ``<save_dir>/profile``."""
        if not (self._profile and epoch == PROFILE_EPOCH and self.is_master):
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._sync()
        before, graphs_before = kernel_launches(), graph_stats()
        self._profiling = True
        try:
            with profile(activities=activities) as prof:
                yield
                self._sync()
        finally:
            self._profiling = False
        launches = {k: v - before.get(k, 0) for k, v in kernel_launches().items()}
        graphs = {k: v - graphs_before[k] for k, v in graph_stats().items()}
        t0 = time.perf_counter()
        out = Path(self._save_dir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        trace = out / f"epoch_{epoch:03d}.pt.trace.json"
        prof.export_chrome_trace(str(trace))
        # the device kernels of the trace, counted in its text (walking the
        # profiler's events in Python costs more than the export)
        device_events = len(_KERNEL_EVENT.findall(trace.read_bytes()))
        if cuda and not device_events:
            trace.unlink()
            raise RuntimeError(
                "Trainer.profile: the profiler recorded no CUDA activity on the card (is "
                "CUPTI available?); no trace is kept without the device")
        (out / "launches.json").write_text(json.dumps(
            {"epoch": epoch, "trace": trace.name, "device_events": device_events,
             "launches": launches, "graphs": graphs}, indent=2))
        seconds = time.perf_counter() - t0
        size = trace.stat().st_size
        logger.info("profile of epoch %d: %s (%d bytes, %d device events) in %.3f s", epoch,
                    trace, size, device_events, seconds,
                    extra={"timing": {"phase": "profile", "epoch": epoch, "seconds": seconds,
                                      "bytes": size, "device_events": device_events}})

    def tra_epoch(self, epoch: int) -> dict:
        meters = MeterInterface(default_focus="tra")
        meters.register_meter("sup_loss", AverageValueMeter())
        meters.register_meter("reg_loss", AverageValueMeter())
        dice = meters.register_meter("sup_dice", UniversalDice(
            self.num_classes, report_axis=range(1, self.num_classes)))
        hook_meters = {}
        for hook in self._active_hooks:
            with meters.focus_on(hook.name):
                hook_meters[hook.name] = meters.register_meter(
                    "metrics", AverageValueDictionaryMeter())
        generator = torch.Generator(device=self.device).manual_seed(
            epoch_seed(self._seed, epoch))
        host_rng = np.random.default_rng(epoch_seed(self._seed, epoch, HOOK_DRAW_SEED_OFFSET))
        if not self._device_cache:
            labeled_iter, unlabeled_iter = self._train_iterators()
        K = self._unroll
        num_calls = max(self._num_batches // K, 1)
        if K > 1 and self._num_batches % K:
            logger.warning("num_batches=%d not divisible by unroll_steps=%d; running %d steps "
                           "per epoch", self._num_batches, K, num_calls * K)
        indicator = Indicator(range(num_calls), desc=f"train {epoch:03d}")
        last = num_calls - 1
        counts = _graph_counts(self._train_step)
        t0 = time.perf_counter()
        with meters:
            for it in indicator:
                if self._device_cache:
                    with span("cy/train/call"):
                        metrics = self._train_step(self._state, generator, epoch, host_rng)
                    with span("cy/train/meters"):
                        dice.add_counts(*self._rows(metrics["dice_inter"], metrics["dice_union"]),
                                        group_ids=metrics.pop("labeled_scan_id").reshape(-1),
                                        id_table=self._labeled_cache.scan_names)
                elif K == 1:
                    labeled, batch, draws = self._host_step_inputs(
                        labeled_iter, unlabeled_iter, generator, host_rng)
                    with span("cy/train/call"):
                        metrics = self._train_step(self._state, batch, draws, epoch)
                    with span("cy/train/meters"):
                        self._add_host_counts(dice, metrics, [labeled])
                else:
                    inputs = [self._host_step_inputs(labeled_iter, unlabeled_iter, generator,
                                                     host_rng) for _ in range(K)]
                    with span("cy/data/host_batch"):
                        batches = stack_batches([b for _, b, _ in inputs])
                    with span("cy/train/call"):
                        metrics = self._train_step(self._state, batches,
                                                   [d for _, _, d in inputs], epoch)
                    with span("cy/train/meters"):
                        self._add_host_counts(dice, metrics, [lab for lab, _, _ in inputs])
                with span("cy/train/meters"):
                    # a call's K steps one by one: the meters sum as over K one-step calls
                    for m in ([metrics] if K == 1 else
                              [{k: v[i] for k, v in metrics.items()} for i in range(K)]):
                        for key in ("sup_loss", "reg_loss"):
                            meters.add(key, m[key])
                        for hook in self._active_hooks:
                            hook_meters[hook.name].add(**hook_metrics(m, hook.name))
                    if it == 0:
                        self._log_figures(metrics, epoch)
                    # reading a meter waits for the device: every tenth step, as JAX's loop
                    if (it + 1) * K // 10 > it * K // 10 or it == last:
                        indicator.set_postfix_statics(
                            {"tra": {"sup": meters["sup_loss"].summary(),
                                     "reg": meters["reg_loss"].summary()}},
                            force_update=it == last)
        self._pause_iterators()
        self._sync()
        seconds = time.perf_counter() - t0
        stats = dict(meters.statistics())
        stats["tra"]["lr"] = float(self._schedule(int(self._state.step)))
        steps = num_calls * K
        replays, captures, capture_s = (
            v - old for v, old in zip(_graph_counts(self._train_step), counts))
        graph = replays > 0
        logger.info("train epoch %d: %d steps in %.3f s (%.3f ms/step, %s%s%s%s)", epoch,
                    steps, seconds, seconds / steps * 1e3,
                    "device cache" if self._device_cache else "host-fed",
                    f", {K} steps a call" if K > 1 else "", ", CUDA graphs" if graph else "",
                    ", profiled" if self._profiling else "",
                    extra={"timing": {"phase": "train", "epoch": epoch,
                                      "steps": steps, "seconds": seconds,
                                      "device_cache": self._device_cache,
                                      "unroll_steps": K, "graph": graph,
                                      "captures": captures, "capture_s": capture_s,
                                      "profiled": self._profiling}})
        return stats

    @staticmethod
    def _rows(inter: torch.Tensor, union: torch.Tensor) -> tuple:
        """A call's dice counts as [rows, C] (K x B rows of K steps)."""
        return inter.reshape(-1, inter.shape[-1]), union.reshape(-1, union.shape[-1])

    def _host_step_inputs(self, labeled_iter, unlabeled_iter, generator, host_rng) -> tuple:
        """(labeled host batch, device batch, draws) of one host-fed step."""
        with span("cy/data/host_batch"):
            labeled = next(labeled_iter)
            unlabeled = next(unlabeled_iter) if unlabeled_iter is not None else None
            batch = self._host_batch(labeled, unlabeled)
            labeled_shape = self._global_shape(batch["labeled_image"])
            if unlabeled is not None:
                shape = self._global_shape(batch["unlabeled_image"])
                draws = sample_step_draws(generator, shape[0], self._active_hooks,
                                          host_rng=host_rng, shape=shape,
                                          labeled_shape=labeled_shape)
            else:
                draws = sample_ft_draws(generator, self._active_hooks, host_rng=host_rng,
                                        shape=labeled_shape)
            return labeled, batch, shard_step_draws(draws, self._active_hooks, self._group)

    def _add_host_counts(self, dice, metrics: dict, labeled: list) -> None:
        """The dice counts of a call's host-fed steps, grouped by their scans."""
        inter, union = self._rows(metrics["dice_inter"], metrics["dice_union"])
        if self._group is None:
            dice.add_counts(inter, union, group_name=[s for lab in labeled for s in lab["scan"]])
        else:
            # the ranks' scans of each step, in the order of its gathered counts
            ids = torch.stack([self._to_device(lab["scan_id"]).long() for lab in labeled])
            ids = gather_rows(ids.T.contiguous(), self._group).T
            dice.add_counts(inter, union, group_ids=ids.reshape(-1),
                            id_table=self._labeled_loader.dataset.get_scan_list())

    # --- evaluation -------------------------------------------------------
    @torch.no_grad()
    def _inference_state(self) -> torch.nn.Module:
        """The model evaluated: the student, or the eval model of the
        inference hook, its parameters and BN statistics (or, when it offers
        none, the student's) copied into the trainer's eval copy."""
        hook = self._inference_hook
        if hook is None:
            return self._state.model
        hook_state = self._state.hook_states[hook.name]
        params = hook.eval_params(hook_state)
        if params is None:
            return self._state.model
        stats = hook.eval_batch_stats(hook_state)
        if stats is None:
            stats = dict(self._state.model.named_buffers())
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self._state.model).requires_grad_(False)
            for p in self._eval_model.parameters():
                p.grad = None
        for name, p in self._eval_model.named_parameters():
            p.copy_(params[name])
        for name, b in self._eval_model.named_buffers():
            b.copy_(stats[name])
        return self._eval_model

    def _eval_batches(self, loader) -> t.Iterator[t.Tuple[dict, tuple]]:
        """(host batch, its (image, target, mask) on the device)."""
        for batch in loader:
            yield batch, (self._to_device(batch["image"]), self._to_device(batch["target"]),
                          self._to_device(batch["mask"]))

    def _scanned_eval(self) -> t.Callable:
        """The chunked eval step, built at the first pass (trainers override
        ``_build_steps``), its graphs in the train graph's memory pool."""
        if getattr(self, "_scanned_eval_step", None) is None:
            graph = getattr(getattr(self, "_train_step", None), "graph", None)
            self._scanned_eval_step = build_scanned_eval_step(
                self._bundle, pool=getattr(graph, "pool", None), **self._eval_kwargs())
        return self._scanned_eval_step

    def _eval_chunks(self, loader) -> t.Iterator[tuple]:
        """(host batches, their scan names, real batches) of each chunk of
        :attr:`EVAL_CHUNK` batches; in a pass of more, the last chunk padded
        with masked copies of its last batch named None."""
        K, batches = self.EVAL_CHUNK, iter(loader)
        for c in itertools.count():
            chunk = list(itertools.islice(batches, K))
            if not chunk:
                return
            n_real = len(chunk)
            names = [name for b in chunk for name in b["scan"]]
            if n_real < K and c > 0:
                pad = {**chunk[-1], "mask": np.zeros_like(chunk[-1]["mask"])}
                chunk += [pad] * (K - n_real)
                names += [None] * ((K - n_real) * len(pad["scan"]))
            yield chunk, names, n_real

    def eval_epoch(self, loader, epoch: int, stage: str = "eval") -> t.Tuple[dict, float]:
        num_classes = self.num_classes
        meters = MeterInterface(default_focus="eval")
        meters.register_meter("loss", AverageValueMeter())
        dice = meters.register_meter("dice", UniversalDice(
            num_classes, report_axis=range(1, num_classes)))
        model = self._inference_state()
        graph = self._scanned_eval().graph
        replays = graph.replays
        t0, batches, chunks, pending = time.perf_counter(), 0, 0, None
        with meters:
            for chunk, names, n_real in self._eval_chunks(loader):
                with span("cy/eval/chunk"):
                    out = self._eval_chunk(model, chunk)
                # the previous chunk's results, read while this one runs
                if pending is not None:
                    with span("cy/eval/readback"):
                        self._add_chunk(meters, dice, *pending)
                pending = out, names, n_real
                batches, chunks = batches + n_real, chunks + 1
            if pending is not None:
                with span("cy/eval/readback"):
                    self._add_chunk(meters, dice, *pending)
        stats = dict(meters.statistics())
        self._log_eval(stage, epoch, batches, time.perf_counter() - t0, chunks=chunks,
                       graph=graph.replays > replays)
        return stats, float(stats["eval"]["dice"]["DSC_mean"])

    def _eval_chunk(self, model, chunk: list) -> tuple:
        """(loss [K], inter [K, B, C], union [K, B, C]) of a chunk's K host
        batches, on the device. On W ranks a chunk whose batches divide by W
        is sharded on its batch axis, as JAX's mesh eval does: each rank
        evaluates its rows, then the loss's masked sums and counts are
        summed over the ranks and the per-sample counts gathered in row
        order; another chunk is evaluated whole on every rank."""
        group = self._group
        host = [torch.from_numpy(np.stack([b[k] for b in chunk])) for k in
                ("image", "target", "mask")]
        sharded = group is not None and host[0].shape[1] % group.size == 0
        if sharded:
            host = shard_batch(host, group, batch_dim=1)
        images, targets, masks = (self._to_device(x.contiguous().numpy(), pinned=True)
                                  for x in host)
        loss, inter, union = self._scanned_eval()(model, images, targets, masks)
        if not sharded:
            return loss, inter, union
        count = masks.float().sum(1)
        num, count = all_reduce_sum(torch.stack([loss * count.clamp(min=1.0), count]), group)
        # [B/W, 2, K, C] rows gathered in rank order -> [2, K, B, C]
        counts = gather_rows(torch.stack([inter, union]).permute(2, 0, 1, 3).contiguous(),
                             group).permute(1, 2, 0, 3)
        return num / count.clamp(min=1.0), counts[0], counts[1]

    @staticmethod
    def _add_chunk(meters, dice, out: tuple, names: list, n_real: int) -> None:
        """A chunk's results into the meters, read back at once: one loss a
        real batch, the dice counts of every row (padded rows named None)."""
        loss, inter, union = out
        flat = torch.cat([x.reshape(-1).double() for x in out]).cpu().numpy()
        loss_h, inter_h, union_h = np.split(flat, [loss.numel(), loss.numel() + inter.numel()])
        for v in loss_h[:n_real]:
            meters.add("loss", float(v))
        c = inter.shape[-1]
        dice.add_counts(inter_h.astype(np.int64).reshape(-1, c),
                        union_h.astype(np.int64).reshape(-1, c), group_name=names)

    def _log_eval(self, stage: str, epoch: int, batches: int, seconds: float, **extra) -> None:
        logger.info("%s epoch %d: %d batches in %.3f s", stage, epoch, batches, seconds,
                    extra={"timing": {"phase": stage, "epoch": epoch, "batches": batches,
                                      "seconds": seconds, "profiled": self._profiling, **extra}})

    # --- checkpointing ----------------------------------------------------
    def save_to(self, name: str = "last") -> str:
        """Write checkpoint ``name`` (rank 0 alone; every rank waits for it)."""
        path = Path(self._save_dir) / name
        if not self.is_master:
            self._group.barrier()
            return str(path)
        t0 = time.perf_counter()
        save_checkpoint(path, train_state=self._train_state_to_save(),
                        host_state={"cur_epoch": self._cur_epoch + 1,
                                    "best_score": float(self._best_score),
                                    "config": self._config,
                                    "storage": self._storage.state_dict()})
        seconds = time.perf_counter() - t0
        logger.info("saved %s in %.3f s", path, seconds,
                    extra={"timing": {"phase": "save", "name": name, "seconds": seconds}})
        if self._group is not None:
            self._group.barrier()
        return str(path)

    def _train_state_to_save(self) -> dict:
        return train_state_dict(self._state, self._active_hooks)

    def resume_from_path(self, path: str) -> None:
        if not self._initialized:
            raise RuntimeError("init() before resume")
        ckpt = load_checkpoint(path, map_location=self.device)
        load_train_state(self._state, self._active_hooks, ckpt["train_state"])
        host = ckpt["host_state"]
        self._cur_epoch = int(host["cur_epoch"])
        self._best_score = float(host["best_score"])
        self._storage.load_state_dict(host["storage"])
        logger.info("resumed from %s at epoch %d", path, self._cur_epoch)

    # --- accessors --------------------------------------------------------
    @property
    def save_dir(self) -> str:
        return self._save_dir

    @property
    def cur_epoch(self) -> int:
        return self._cur_epoch
