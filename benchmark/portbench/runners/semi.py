"""The ``semi`` cells: the port's two-stage ``semi`` step with its hooks,
K updates a call, its batches sampled and cropped on the device from a
device-resident split (``feed: device_cache``)."""
from __future__ import annotations

from typing import Dict

import torch

from .. import inputs, reference as ref
from ..check import Readings
from ..work import conv_flops, kernel_sites, unet_convs
from . import base
from .base import half_batch, no_synthetic_slices, readings_of


class Runner(base.Runner):
    """A runner of another ``semi`` method subclasses this one in a module
    of its own, with its :attr:`hook_sections` and :meth:`reference_update`."""

    #: the configuration's hook sections that :meth:`reference_update` computes
    hook_sections = ("ConsistencyParameters",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.updates_per_call = int(self.config["Trainer"].get("unroll_steps", 1))
        hooks = tuple(k for k in self.config if k.endswith(("Parameters", "Params")))
        if hooks != self.hook_sections:
            raise NotImplementedError(f"hook sections {hooks}: this runner's reference "
                                      f"computes {self.hook_sections}")

    @property
    def captures(self) -> bool:
        return self.device.type == "cuda" and self.updates_per_call > 1

    def _sizes(self):
        t = self.traffic
        return int(t["raw_size"]), int(t["crop"]), int(t["slices"])

    def build(self) -> None:
        from contrastyou_tpu_torch import main as port
        from contrastyou_tpu_torch.engine import steps
        if self.traffic.get("feed") != "device_cache":
            raise NotImplementedError(f"feed {self.traffic.get('feed')!r}: the semi runner "
                                      f"feeds from the device cache")
        raw, crop, n = self._sizes()
        with no_synthetic_slices(port):
            run = port.build_semi_run(self.config, device=self.device, dtype=self.dtype,
                                      raw_size=raw, crop=crop, n_slices=n)
        nc = self.num_classes
        pshapes, bshapes = ref.unet_shapes(self.max_channel, nc)
        weights = inputs.make_weights(pshapes, inputs.generator(self.seed, inputs.WEIGHTS,
                                                                self.device))
        buffers = inputs.make_buffers(bshapes, self.device)
        model = run.state.model
        model.load_state_dict({**weights, **buffers})
        images, targets = inputs.make_slices(n, raw, nc, inputs.generator(
            self.seed, inputs.SLICES, self.device))
        half = n // 2
        for cache, rows in ((run.labeled_cache, slice(0, half)), (run.unlabeled_cache, slice(half, n))):
            cache.images.copy_(images[rows])
            cache.targets.copy_(targets[rows])
            if self.fault == "half_batch":
                self.plant(cache, "sample_at", lambda f: half_batch(f, None))
        if self.fault == "half_batch":
            self.plant(steps, "sample_step_draws", half_batch)
        self.run = run
        self.gen = inputs.generator(self.seed, inputs.DRAWS, self.device)
        self.slices_per_update = run.batch_slices
        self.initial = {k: v.detach().clone() for k, v in self.leaves().items()}
        self.names = {id(p): k for k, p in model.named_parameters()}

    def call(self):
        run = self.run
        return run.step(run.state, self.gen, 0, run.host_rng)

    def loss_of(self, metrics) -> torch.Tensor:
        return metrics["total_loss"]

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.run.state.model.state_dict())

    # --- work ------------------------------------------------------------
    def _passes(self):
        cfg = self.config
        nl = int(cfg["LabeledLoader"]["batch_size"])
        nu = int(cfg["UnlabeledLoader"]["batch_size"])
        return (nl, 2 * nu)

    def _convs(self):
        return unet_convs(self.max_channel, self.num_classes, int(self.traffic["crop"]))

    def sites(self) -> list:
        return [s for b in self._passes() for s in kernel_sites(self._convs(), b)]

    def model_flops(self) -> float:
        return sum(conv_flops(self._convs(), b) for b in self._passes())

    # --- the reference ---------------------------------------------------
    def reference(self, prec, n_calls: int) -> Readings:
        raw, crop, n = self._sizes()
        images, targets = inputs.make_slices(n, raw, self.num_classes, inputs.generator(
            self.seed, inputs.SLICES, self.device))
        half = n // 2
        data = {"labeled_images": images[:half], "labeled_targets": targets[:half],
                "unlabeled_images": images[half:]}
        bl, bu = self._passes()[0], self._passes()[1] // 2

        def batch(g):
            d = ref.semi_draws(g, n_labeled=half, n_unlabeled=n - half, size=raw, crop=crop,
                               batch_labeled=bl, batch_unlabeled=bu)
            return (*ref.cached_batch(data, d, crop), d)

        return self.reference_updates(prec, n_calls * self.updates_per_call, batch)

    @property
    def num_classes(self) -> int:
        return int(self.cell.config["num_classes"])

    def reference_updates(self, prec, updates: int, batch) -> Readings:
        """The reference's first ``updates`` updates from the seed's weights,
        ``batch(generator)`` giving each update's (labeled images, targets,
        unlabeled images, draws) in the port's order of draws."""
        pshapes, bshapes = ref.unet_shapes(self.max_channel, self.num_classes)
        dev = self.device
        weights = inputs.make_weights(pshapes, inputs.generator(self.seed, inputs.WEIGHTS, dev))
        state = ref.State(weights, inputs.make_buffers(bshapes, dev), list(pshapes),
                          self.config, prec)
        start = {**{k: v.detach().clone() for k, v in state.params.items()},
                 **{k: v.clone() for k, v in state.buffers.items()}}
        g = inputs.generator(self.seed, inputs.DRAWS, dev)
        losses, first = [], {}
        for i in range(updates):
            losses.append(self.reference_update(state, *batch(g)))
            if i == 0:
                first = {k: v.clone() for k, v in state.opt.mu.items()}
        end = {**{k: v.detach() for k, v in state.params.items()}, **state.buffers}
        return readings_of(losses, first, start, end)

    def reference_update(self, state, labeled, targets, unlabeled, draws) -> float:
        """One update of the reference's ``state``; returns its loss."""
        return ref.semi_step(state, labeled, targets, unlabeled, draws,
                             num_classes=self.num_classes,
                             consistency_weight=float(self.config["ConsistencyParameters"]["weight"]))
