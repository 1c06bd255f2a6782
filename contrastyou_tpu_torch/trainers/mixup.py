"""MixUp trainer (counterpart of contrastyou_tpu/trainers/mixup.py): the
labeled batch alone (``ft`` steps, so no unlabeled loader is read) with the
hooks active, the MixUp hook among them; validation, test and inference as
:class:`~contrastyou_tpu_torch.trainers.semi.SemiTrainer`'s."""
from __future__ import annotations

from .semi import SemiTrainer

__all__ = ["MixUpTrainer"]


class MixUpTrainer(SemiTrainer):
    train_mode = "ft"
    activate_hooks = True
    #: on W > 1 ranks the hook mixes the gathered global batch
    data_parallel = True
