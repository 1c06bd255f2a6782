"""Adversarial semi-supervised trainer (counterpart of
contrastyou_tpu/trainers/adv.py): per step a generator update, then a
discriminator update, on the labeled and unlabeled host batches.

- Generator: the supervised KL of the labeled forward plus ``reg_weight``
  times BCE(D(softmax(unlabeled forward)), real); both forwards update the
  segmenter's BN statistics, the discriminator's forward here does not
  update its own (JAX discards them).
- Discriminator: ``reg_weight`` times BCE(D(labeled probs), real) +
  BCE(D(unlabeled probs), fake) on the detached probabilities, each forward
  updating its statistics; with ``dis_consider_image`` its input is the
  image beside the probabilities.

As in JAX the trainer runs no hooks and has no inference; validation and
test evaluate the trained segmenter. ``storage.csv`` carries ``sup_loss``,
``sup_dice`` and ``adv_reg/{dis_loss,gen_loss}``.

JAX's checkpoints of this trainer hold its ``_state``, which the adversarial
step never updates (it carries its own state): ``last`` and ``best`` keep
the segmenter's initial weights and optimizer, and a resume would restart
the adversarial state silently. The port writes what JAX writes (the
initial train state) and raises on a resume.
"""
from __future__ import annotations

import copy
import logging
import time

import torch
import torch.nn.functional as F

from ..engine.checkpoint import train_state_dict
from ..engine.optim import create_optimizer
from ..engine.trainer import Trainer
from ..indicator import Indicator
from ..losses.kl import kl_div
from ..meters.averages import AverageValueMeter
from ..meters.dice import UniversalDice, slice_intersection_union
from ..meters.interface import MeterInterface
from ..models.discriminator import Discriminator

__all__ = ["AdversarialTrainer", "build_adversarial_step", "bce"]

logger = logging.getLogger(__name__)


def bce(pred: torch.Tensor, target_value: float) -> torch.Tensor:
    """Binary cross-entropy of probabilities against a constant target."""
    t = target_value
    return -(t * torch.log(pred + 1e-8) + (1 - t) * torch.log(1 - pred + 1e-8)).mean()


def build_adversarial_step(model: torch.nn.Module, disc: Discriminator,
                           gen_opt: torch.optim.Optimizer, disc_opt: torch.optim.Optimizer, *,
                           reg_weight: float, dis_consider_image: bool, num_classes: int):
    """-> ``step(batch) -> metrics`` (``batch``: ``labeled_image``,
    ``labeled_target``, ``unlabeled_image``); the metrics stay on the
    device."""
    gen_params = list(model.parameters())

    def disc_input(image, probs):
        return torch.cat([image, probs], -1) if dis_consider_image else probs

    def step(batch):
        model.train()
        labeled_image, target = batch["labeled_image"], batch["labeled_target"]
        labeled_logits = model(labeled_image, train=True)[0]
        probs = torch.softmax(labeled_logits, -1)
        sup_loss = kl_div(probs, F.one_hot(target.long(), num_classes).float())
        gen_err = sup_loss.new_zeros(())
        if reg_weight > 0:
            unlabeled_image = batch["unlabeled_image"]
            unlabeled_probs = torch.softmax(model(unlabeled_image, train=True)[0], -1)
            d_out = disc(disc_input(unlabeled_image, unlabeled_probs), train=True,
                         update_stats=False)
            gen_err = bce(d_out, 1.0)
        total = sup_loss + reg_weight * gen_err
        gen_opt.zero_grad(set_to_none=True)
        total.backward(inputs=gen_params)
        gen_opt.step()

        disc_loss = sup_loss.new_zeros(())
        if reg_weight > 0:
            err_l = bce(disc(disc_input(labeled_image, probs.detach()), train=True), 1.0)
            err_u = bce(disc(disc_input(unlabeled_image, unlabeled_probs.detach()), train=True),
                        0.0)
            disc_opt.zero_grad(set_to_none=True)
            ((err_l + err_u) * reg_weight).backward()
            disc_opt.step()
            disc_loss = (err_l + err_u).detach()
        inter, union = slice_intersection_union(labeled_logits.detach().argmax(-1), target,
                                                num_classes=num_classes)
        return {"sup_loss": sup_loss.detach(), "gen_loss": gen_err.detach(),
                "dis_loss": disc_loss, "dice_inter": inter, "dice_union": union}

    return step


class AdversarialTrainer(Trainer):
    activate_hooks = False
    data_parallel_refusal = ("JAX's adversarial loop does not shard its batches "
                             "(contrastyou_tpu/trainers/adv.py tra_epoch)")
    unroll_refusal = ("JAX's adversarial trainer builds its own step and loop and runs one "
                      "step a call whatever unroll_steps is (contrastyou_tpu/trainers/adv.py "
                      "tra_epoch)")

    def __init__(self, *, reg_weight: float = 0.01, dis_consider_image: bool = False, **kwargs):
        if int(kwargs.get("accumulate_iter", 1)) != 1:
            # JAX's adversarial trainer builds its optimizers without it
            raise NotImplementedError("Trainer.accumulate_iter under Trainer.name=adv: the "
                                      "adversarial trainer steps both optimizers every call")
        super().__init__(**kwargs)
        self._reg_weight = float(reg_weight)
        self._dis_consider_image = bool(dis_consider_image)

    def init(self) -> None:
        super().init()
        num_classes = self._bundle.num_classes
        input_dim = num_classes + (self._bundle.input_shape[-1]
                                   if self._dis_consider_image else 0)
        gen = torch.Generator(device=self.device).manual_seed(self._seed + 7)
        self._disc = Discriminator(input_dim=input_dim, dtype=self._model.dtype).to(
            self.device).init_weights(gen)
        self._disc_optimizer, _ = create_optimizer(
            self._disc.parameters(), self._config.get("Optim", {"name": "adam", "lr": 1e-4}),
            None, max_epoch=self._max_epoch, steps_per_epoch=self._num_batches)
        # what JAX's save_to writes: the train state as it stands before training
        self._saved_state = copy.deepcopy(train_state_dict(self._state, self._active_hooks))
        self._adv_step = build_adversarial_step(
            self._model, self._disc, self._optimizer, self._disc_optimizer,
            reg_weight=self._reg_weight, dis_consider_image=self._dis_consider_image,
            num_classes=num_classes)

    def _build_steps(self) -> None:
        from ..engine.steps import build_eval_step
        self._eval_step = build_eval_step(self._bundle)

    def _train_iterators(self):
        if not hasattr(self, "_labeled_iter"):
            self._labeled_iter = iter(self._labeled_loader)
            self._unlabeled_iter = iter(self._unlabeled_loader)
        return self._labeled_iter, self._unlabeled_iter

    def tra_epoch(self, epoch: int) -> dict:
        num_classes = self._bundle.num_classes
        meters = MeterInterface(default_focus="tra")
        meters.register_meter("sup_loss", AverageValueMeter())
        dice = meters.register_meter("sup_dice", UniversalDice(
            num_classes, report_axis=range(1, num_classes)))
        with meters.focus_on("adv_reg"):
            meters.register_meter("dis_loss", AverageValueMeter())
            meters.register_meter("gen_loss", AverageValueMeter())
        labeled_iter, unlabeled_iter = self._train_iterators()
        t0 = time.perf_counter()
        with meters:
            for _ in Indicator(range(self._num_batches), desc=f"adv {epoch:03d}"):
                labeled, unlabeled = next(labeled_iter), next(unlabeled_iter)
                batch = {"labeled_image": self._to_device(labeled["image"]),
                         "labeled_target": self._to_device(labeled["target"]).long(),
                         "unlabeled_image": self._to_device(unlabeled["image"])}
                metrics = self._adv_step(batch)
                meters.add("sup_loss", metrics["sup_loss"])
                dice.add_counts(metrics["dice_inter"], metrics["dice_union"],
                                group_name=labeled["scan"])
                with meters.focus_on("adv_reg"):
                    meters.add("dis_loss", metrics["dis_loss"])
                    meters.add("gen_loss", metrics["gen_loss"])
        self._pause_iterators()
        self._sync()
        seconds = time.perf_counter() - t0
        logger.info("train epoch %d: %d adversarial steps in %.3f s (%.3f ms/step, host-fed%s)",
                    epoch, self._num_batches, seconds, seconds / self._num_batches * 1e3,
                    ", profiled" if self._profiling else "",
                    extra={"timing": {"phase": "train", "epoch": epoch,
                                      "steps": self._num_batches, "seconds": seconds,
                                      "device_cache": False, "profiled": self._profiling}})
        return dict(meters.statistics())

    def _train_state_to_save(self) -> dict:
        return self._saved_state

    def resume_from_path(self, path: str) -> None:
        raise NotImplementedError(
            f"resuming an adversarial run ({path}) is refused: as the JAX trainer's, its "
            f"checkpoints hold the segmenter's initial state, not the trained one, and no "
            f"discriminator")
