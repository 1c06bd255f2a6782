"""Multicore (multi-prototype) trainer (counterpart of
contrastyou_tpu/trainers/multicore.py): the model predicts ``true_num_classes
* multiplier`` prototype channels; the supervised loss, the dice counts,
evaluation and inference sum each class's prototypes back to it
(:class:`~contrastyou_tpu_torch.losses.multicore.MultiCoreKL`). The hooks
read the prototype logits."""
from __future__ import annotations

from typing import List

from ..losses.multicore import MultiCoreKL
from .semi import SemiTrainer

__all__ = ["prototype_groups", "MulticoreTrainer"]


def prototype_groups(true_num_classes: int, multiplier: int) -> List[List[int]]:
    """Contiguous blocks of ``multiplier`` prototype channels per class."""
    return [list(range(c * multiplier, (c + 1) * multiplier)) for c in range(true_num_classes)]


class MulticoreTrainer(SemiTrainer):
    #: on W > 1 ranks: the criterion is a batch mean (``MultiCoreKL``)
    data_parallel = True

    def __init__(self, *, true_num_classes: int, multiplier: int = 2, **kwargs):
        criterion = MultiCoreKL(prototype_groups(true_num_classes, multiplier))
        super().__init__(criterion=criterion, prob_transform=criterion.reduced_simplex,
                         target_num_classes=true_num_classes, **kwargs)
