"""The fine-tune sweep (counterpart of the root ``val.py``): after
contrastive pretraining, fine-tune the pretrained weights at each labeled
scan count and record the best validation dice of each.

    from contrastyou_tpu_torch.engine.checkpoint import extract_model_params
    params = extract_model_params("<pretrain>/last", model)
    val(model=model, pretrained_params=params, save_dir="<pretrain>",
        base_config=config, labeled_ratios=[1, 2, 4])

Each count runs a :class:`~contrastyou_tpu_torch.trainers.ft.FineTuneTrainer`
in ``<save_dir>/tra/num_labeled_scan_<n>`` on a copy of ``model`` (its
BN statistics as given), with ``pretrained_params`` loaded after ``init``,
resuming from that directory's ``last`` when present.
"""
from __future__ import annotations

import copy
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch

import contrastyou_tpu_torch as package
from .data.creator import get_data
from .engine.checkpoint import is_checkpoint
from .trainers.ft import FineTuneTrainer

__all__ = ["val"]

logger = logging.getLogger(__name__)


def val(*, model: torch.nn.Module, pretrained_params: Mapping[str, torch.Tensor],
        save_dir: str, base_config: Mapping[str, Any], labeled_ratios: List[int],
        seed: int = 10, root_dir: Optional[str] = None) -> Dict[int, float]:
    """Fine-tune ``pretrained_params`` at each labeled scan count ->
    ``{labeled scan count: best validation DSC_mean}``."""
    results: Dict[int, float] = {}
    for ratio in labeled_ratios:
        config = copy.deepcopy(dict(base_config))
        config["Data"]["labeled_scan_num"] = int(ratio)
        labeled, unlabeled, val_loader, test_loader = get_data(
            config["Data"], config.get("LabeledLoader", {}), config.get("UnlabeledLoader", {}),
            root_dir=root_dir or package.DATA_PATH,
            order_num=int(config["Data"].get("order_num", 0)))
        n_scans = len(labeled.dataset.get_scan_list())
        trainer = FineTuneTrainer(
            model=copy.deepcopy(model), labeled_loader=labeled, unlabeled_loader=unlabeled,
            val_loader=val_loader, test_loader=test_loader,
            save_dir=os.path.join(save_dir, "tra", f"num_labeled_scan_{n_scans}"),
            config=config, seed=seed,
            **{k: v for k, v in config["Trainer"].items()
               if k not in ("name", "device", "save_dir")})
        trainer.init()
        trainer.load_model_params(pretrained_params)
        last = Path(trainer.save_dir) / "last"
        if is_checkpoint(last):
            trainer.resume_from_path(str(last))
        best = trainer.start_training()
        package.success(trainer.save_dir)
        results[n_scans] = best
        logger.info("labeled scans %d: best dice %.4f", n_scans, best)
    return results
