"""Fine-tune trainer (counterpart of contrastyou_tpu/trainers/ft.py): the
labeled batch alone under the supervised KL, every regularizer hook dropped
(an ``always_active`` one, the EMA eval model of ``EvalEMAParameters``,
stays and is evaluated); validation, test and inference as
:class:`~contrastyou_tpu_torch.trainers.semi.SemiTrainer`'s."""
from __future__ import annotations

from .semi import SemiTrainer

__all__ = ["FineTuneTrainer"]


class FineTuneTrainer(SemiTrainer):
    train_mode = "ft"
    activate_hooks = False
    #: on W > 1 ranks the labeled forward's BatchNorm sums are global, the
    #: KL a per-rank mean (engine/steps.py)
    data_parallel = True
