"""Differentiable-mean-teacher trainer (counterpart of
contrastyou_tpu/trainers/dmt.py): ``semi`` training with the DMT hook,
evaluating and inferring on its teacher."""
from __future__ import annotations

from ..hooks.dmt import DifferentiableMeanTeacherTrainerHook
from .semi import SemiTrainer

__all__ = ["DMTTrainer"]


class DMTTrainer(SemiTrainer):
    #: on W > 1 ranks the teacher's forwards take global BatchNorm sums and
    #: its meta gradients are summed over ranks (hooks/dmt.py)
    data_parallel = True

    def init(self) -> None:
        super().init()
        dmt = next((h for h in self._active_hooks
                    if isinstance(h, DifferentiableMeanTeacherTrainerHook)), None)
        if dmt is None:
            raise RuntimeError("DMTTrainer requires a DifferentiableMeanTeacher hook")
        self.set_model4inference(dmt)
