"""Semi-supervised trainer (counterpart of contrastyou_tpu/trainers/semi.py):
labeled + unlabeled two-view steps under the supervised KL and the hooks,
and scan-grouped inference (3D dice and average surface distance, written
to ``inference_result.json``), optionally averaged over the four axis flips
(``Inference.tta``), optionally with each slice's image, ground truth,
prediction and overlay as PNGs (``save_predictions``,
``trainers/savers.py``)."""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional

from ..engine.steps import build_eval_step
from ..engine.trainer import Trainer
from ..meters.averages import AverageValueMeter
from ..meters.dice import UniversalDice
from ..meters.interface import MeterInterface
from ..meters.surface import SurfaceMeter
from .savers import InferenceSaver

__all__ = ["SemiTrainer"]

logger = logging.getLogger(__name__)


class SemiTrainer(Trainer):
    activate_hooks = True
    runs_inference = True
    data_parallel = True

    def inference(self, scan_loader=None, checkpoint: Optional[str] = None,
                  save_predictions: bool = False, tta: Optional[bool] = None) -> dict:
        """Dice and ASD per scan of ``scan_loader`` (default: the test
        loader) after restoring ``checkpoint`` when given; ``tta`` defaults
        to the config's ``Inference.tta``; ``save_predictions`` writes the
        slices' PNGs under ``<save_dir>/predictions`` (``InferenceSaver``).
        On W ranks every rank evaluates every scan and rank 0 writes the
        result and the PNGs."""
        if not self._initialized:
            raise RuntimeError("call init() first")
        if tta is None:
            tta = bool(self._config.get("Inference", {}).get("tta", False))
        if checkpoint is not None:
            self.resume_from_path(checkpoint)
        loader = scan_loader if scan_loader is not None else self._test_loader
        c = self.num_classes
        meters = MeterInterface(default_focus="inference")
        meters.register_meter("loss", AverageValueMeter())
        dice = meters.register_meter("dice", UniversalDice(c, report_axis=range(1, c)))
        asd = meters.register_meter("asd", SurfaceMeter(c, report_axis=range(1, c)))
        eval_step = (build_eval_step(self._bundle, tta=True, **self._eval_kwargs()) if tta
                     else self._eval_step)
        saver = (InferenceSaver(self._save_dir) if save_predictions and self.is_master
                 else None)
        model = self._inference_state()
        t0, n = time.perf_counter(), 0
        with meters:
            for batch, tensors in self._eval_batches(loader):
                loss, pred, inter, union = eval_step(model, *tensors)
                meters.add("loss", loss)
                dice.add_counts(inter, union, group_name=batch["scan"])
                asd.add(pred, batch["target"], group_name=batch["scan"])
                if saver is not None:
                    saver.save_batch(image=batch["image"], target=batch["target"], pred=pred,
                                     filenames=batch["filename"], mask=batch["mask"])
                n += 1
        result = dict(meters.statistics())["inference"]
        self._log_eval("inference", self._cur_epoch, n, time.perf_counter() - t0, tta=tta)
        out = {"dice": result["dice"], "asd": result["asd"], "loss": float(result["loss"])}
        if self.is_master:
            with open(Path(self._save_dir) / "inference_result.json", "w") as f:
                json.dump(out, f, indent=2)
        logger.info("inference: %s", out["dice"])
        return out
